// Hand-written Hopper kernel for coordinate-wise Byzantine-robust
// aggregation on the flat (K, P) parameter buffer (kernel B7):
//
//   OUT[k, p] = sum_j W[k, j] * sort_i{ payload_i[p] : MASK[k, i] > 0 }[j]
//
// where payload_i is SENT[i] for a neighbor and BUF[k] for receiver k's own
// slot, the sort is ascending, masked slots count as +inf (past every live
// value) and every non-finite sorted value contributes 0. W holds position
// weights (trimmed mean or median, from faults/robust.py::sorted_weights).
//
// Replaces src/repro/kernels/robust_agg.py::robust_agg (the Pallas TPU
// kernel). The TPU version builds the (K, K, block) candidate tensor in VMEM
// and sorts every receiver's candidates with K passes of an odd-even
// transposition network, because VMEM code cannot branch on data. Here:
//
// * One block owns TC consecutive columns (TC = 8192 / Kp, at most 32; Kp
//   is K rounded up to a power of two). It stages the K sender values of
//   each column in shared memory as 64-bit (order-preserving key, sender
//   index) pairs and sorts each column ONCE with a bitonic network: the
//   sorted column is shared by all K receivers. Shared memory is
//   TC * (Kp + 1) * 8 bytes, 64 KB at K=256 and at K=1024.
// * Each (receiver k, column) item then walks the sorted column in O(K):
//   it skips senders outside k's mask (a bitmask transposed by a small
//   first kernel, so a lookup is one 32-bit word), skips slot k, merges
//   BUF[k, p] in at its place, and accumulates W[k, pos] * v over the live
//   positions pos = 0, 1, ... in f32 FMAs. Up to K=256 a warp holds 32
//   columns of one receiver, so the BUF reads and OUT writes are coalesced
//   and the W reads fall on one row.
// * Order keys map a float to a uint32 that sorts like the float (-inf
//   first, -0 before +0); NaN maps to the largest key, after +inf, as the
//   reference's sort places it. Equal values may sort in either order: they
//   give the same weighted sum. Masked and live +inf / NaN values land past
//   every finite live value and are zeroed, as the reference zeroes them.
// * What bounds it on the H100: operations. The walk is K*K*P
//   compare-select-FMA steps (1.57e9 at K=256, P=23,936) against 12 bytes
//   per element of traffic, so the kernel is far from the HBM bound. The
//   (K, K, P) candidate tensor is never materialized.
// * K <= 1024 (the sender index fits the key's low word; shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNodes = 1024;
constexpr int kSortElems = 8192;     // TC * Kp: 64 KB of 8-byte pairs
constexpr int kMaxCols = 32;
constexpr unsigned long long kPad = ~0ull;

__device__ __forceinline__ uint32_t sort_key(float x) {
  if (isnan(x)) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ float scrub(float v) {
  return isfinite(v) ? v : 0.f;
}

// bits[i * kw + b] bit t = MASK[32 * b + t, i] > 0: for sender i, the word of
// 32 receivers that hear it.
__global__ void pack_mask_kernel(const float* __restrict__ mask,
                                 uint32_t* __restrict__ bits, int k, int kw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= k * kw) return;
  const int i = e / kw, b = e % kw;
  uint32_t word = 0;
  for (int t = 0; t < 32; ++t) {
    const int r = 32 * b + t;
    if (r < k && mask[(size_t)r * k + i] > 0.f) word |= 1u << t;
  }
  bits[e] = word;
}

__global__ void __launch_bounds__(kThreads)
robust_agg_kernel(const float* __restrict__ w,
                  const uint32_t* __restrict__ bits,
                  const float* __restrict__ buf,
                  const float* __restrict__ sent, float* __restrict__ out,
                  int k, int p, int kp, int tc, int kw) {
  extern __shared__ __align__(16) unsigned long long s_col[];
  const int stride = kp + 1;           // one pad word per column
  const int col0 = blockIdx.x * tc;

  // 1. stage (key, sender) pairs, column-major; padding sorts last
  for (int e = threadIdx.x; e < kp * tc; e += kThreads) {
    const int c = e % tc, i = e / tc;
    const int col = col0 + c;
    unsigned long long v = kPad;
    if (i < k && col < p) {
      v = (static_cast<unsigned long long>(
               sort_key(sent[(size_t)i * p + col])) << 32) |
          static_cast<uint32_t>(i);
    }
    s_col[c * stride + i] = v;
  }
  __syncthreads();

  // 2. bitonic sort of every column, ascending
  const int half = kp >> 1;
  for (int size = 2; size <= kp; size <<= 1) {
    for (int st = size >> 1; st > 0; st >>= 1) {
      for (int e = threadIdx.x; e < half * tc; e += kThreads) {
        const int c = e / half, j = e % half;
        const int lo = 2 * j - (j & (st - 1));
        unsigned long long* col = s_col + c * stride;
        const unsigned long long a = col[lo], b = col[lo + st];
        if ((a > b) == ((lo & size) == 0)) {
          col[lo] = b;
          col[lo + st] = a;
        }
      }
      __syncthreads();
    }
  }

  // 3. every (receiver, column) walks its column's sorted senders
  for (int q = threadIdx.x; q < k * tc; q += kThreads) {
    const int r = q / tc, c = q % tc;
    const int col = col0 + c;
    if (col >= p) continue;
    const unsigned long long* sc = s_col + c * stride;
    const uint32_t* hears = bits + (r >> 5);    // hears[i * kw]: sender i
    const uint32_t bit = 1u << (r & 31);
    const float* wr = w + (size_t)r * k;
    const float own = buf[(size_t)r * p + col];
    const uint32_t own_key = sort_key(own);
    bool own_pending = (__ldg(hears + (size_t)r * kw) & bit) != 0;
    float acc = 0.f;
    int pos = 0;
    for (int s = 0; s < k; ++s) {
      const unsigned long long e = sc[s];
      const int i = static_cast<int>(static_cast<uint32_t>(e));
      if (i == r || !(__ldg(hears + (size_t)i * kw) & bit)) continue;
      const uint32_t key = static_cast<uint32_t>(e >> 32);
      if (own_pending && own_key <= key) {
        acc = fmaf(__ldg(wr + pos), scrub(own), acc);
        ++pos;
        own_pending = false;
      }
      acc = fmaf(__ldg(wr + pos), scrub(key_value(key)), acc);
      ++pos;
    }
    if (own_pending) acc = fmaf(__ldg(wr + pos), scrub(own), acc);
    out[(size_t)r * p + col] = acc;
  }
}

}  // namespace

// weights, mask (K, K) f32; buf, sent, out (K, P) f32; bits: int32 scratch
// of K * ceil(K / 32) words. Returns cudaGetLastError() after the launches.
extern "C" int repro_robust_agg(const void* weights, const void* mask,
                                const void* buf, const void* sent, void* bits,
                                void* out, int k, int p, void* stream) {
  if (k < 1 || k > kMaxNodes || p < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int kp = 1;
  while (kp < k) kp <<= 1;
  int tc = kSortElems / kp;
  tc = tc < 1 ? 1 : (tc > kMaxCols ? kMaxCols : tc);
  const int kw = (k + 31) / 32;
  auto* b = static_cast<uint32_t*>(bits);
  pack_mask_kernel<<<(k * kw + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(mask), b, k, kw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)tc * (kp + 1) * sizeof(unsigned long long);
  // above 48 KB needs the opt-in; set once to the largest size any K takes
  // (TC * Kp <= kSortElems, plus TC <= kMaxCols pad words)
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    err = cudaFuncSetAttribute(
        robust_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kSortElems + kMaxCols) *
                         sizeof(unsigned long long)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  robust_agg_kernel<<<(p + tc - 1) / tc, kThreads, smem, s>>>(
      static_cast<const float*>(weights), b, static_cast<const float*>(buf),
      static_cast<const float*>(sent), static_cast<float*>(out), k, p, kp, tc,
      kw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
