// Hand-written Hopper kernels for the eq. 5 consensus exchange.
//
//   B1 flat_mix:       OUT = M + gamma * (ETA @ W - rowsum(ETA) * W)
//   B2 flat_consensus: OUT = A @ BUF
//   B8 consensus_mix:  OUT = W + gamma * sum_i eta_i (NB_i - W)
//
// B1/B2 work on the flat (K, P) parameter buffer and replace
// src/repro/kernels/consensus_mix.py::flat_mix and ::flat_consensus (the
// Pallas TPU kernels). B8, one node mixing N neighbor copies of its own
// tensor, is described at its kernel below. The TPU versions of B1/B2 hold
// the whole (K, K) operator in VMEM and run one MXU matmul per
// (K, block_cols) slab. Here:
//
// * What bounds it on the H100. At the paper's K=4, P=23,936 one call moves
//   about 1.15 MB (master, wire, out), which is under a microsecond of HBM
//   time, so the call is launch-bound. At a fleet of K=256 it is 2*K*K*P =
//   3.1 GFLOP of f32 FMA against about 74 MB of traffic: bound by the CUDA
//   cores' f32 rate and by re-reading the wire slab from L2.
// * No tensor cores. TF32 keeps about three decimal digits and would break
//   the f32 delta form (src/repro/core/flatten.py, mix_flat), whose point is
//   to keep the cancellation at the f32 noise floor. bf16 is only a wire
//   format: it is read as bf16 and upcast before every FMA.
// * Tiling. A block owns TR output rows by 128 columns; each thread owns one
//   column and keeps TR f32 accumulators in registers. The inner node index
//   is walked in chunks of 32: the (TR, 32) eta chunk is staged in shared
//   memory (every thread reads the same entry, a broadcast), and each thread
//   reads its own column of the wire chunk straight into a register (that
//   element is used by this thread only, so staging it in shared memory
//   would buy nothing). A full eta never sits in one block: at K=256 it is
//   256 KB, above the 227 KB a block may use. Row sums come from the same
//   staged eta chunks. Ragged K and P are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;   // threads per block = output columns per block
constexpr int kChunk = 32;   // inner node indices staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int TR, bool kMix, typename WireT>
__global__ void __launch_bounds__(kCols)
mix_kernel(const float* __restrict__ eta, const float* __restrict__ master,
           const WireT* __restrict__ wire, const float* __restrict__ gamma,
           float* __restrict__ out, int k, int p) {
  __shared__ float s_eta[TR][kChunk + 1];   // +1: no bank conflicts on rows
  __shared__ float s_row[TR];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * TR;
  const bool live = col < p;
  float acc[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r] = 0.f;
  if (kMix && threadIdx.x < TR) s_row[threadIdx.x] = 0.f;

  for (int i0 = 0; i0 < k; i0 += kChunk) {
    __syncthreads();   // the previous chunk is fully consumed
    for (int e = threadIdx.x; e < TR * kChunk; e += kCols) {
      const int r = e / kChunk, ii = e % kChunk;
      const int gr = row0 + r, gi = i0 + ii;
      s_eta[r][ii] = (gr < k && gi < k) ? eta[(size_t)gr * k + gi] : 0.f;
    }
    __syncthreads();
    if (kMix && threadIdx.x < TR) {
      float s = 0.f;
      for (int ii = 0; ii < kChunk; ++ii) s += s_eta[threadIdx.x][ii];
      s_row[threadIdx.x] += s;
    }
    if (live) {
      const int n = min(kChunk, k - i0);
      const WireT* w_col = wire + (size_t)i0 * p + col;
#pragma unroll 4
      for (int ii = 0; ii < n; ++ii) {
        const float w = to_f32(w_col[(size_t)ii * p]);
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[r] = fmaf(s_eta[r][ii], w, acc[r]);
      }
    }
  }
  __syncthreads();   // s_row is complete
  if (!live) return;
  if (kMix) {
    const float g = *gamma;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int gr = row0 + r;
      if (gr < k) {
        const size_t o = (size_t)gr * p + col;
        const float ws = to_f32(wire[o]);
        out[o] = master[o] + g * (acc[r] - s_row[r] * ws);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int gr = row0 + r;
      if (gr < k) out[(size_t)gr * p + col] = acc[r];
    }
  }
}

template <bool kMix, typename WireT>
int launch(const float* eta, const float* master, const WireT* wire,
           const float* gamma, float* out, int k, int p, void* stream) {
  const int tr = k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 32;
  const dim3 block(kCols);
  const dim3 grid((p + kCols - 1) / kCols, (k + tr - 1) / tr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tr) {
    case 4:
      mix_kernel<4, kMix, WireT><<<grid, block, 0, s>>>(
          eta, master, wire, gamma, out, k, p);
      break;
    case 8:
      mix_kernel<8, kMix, WireT><<<grid, block, 0, s>>>(
          eta, master, wire, gamma, out, k, p);
      break;
    case 16:
      mix_kernel<16, kMix, WireT><<<grid, block, 0, s>>>(
          eta, master, wire, gamma, out, k, p);
      break;
    default:
      mix_kernel<32, kMix, WireT><<<grid, block, 0, s>>>(
          eta, master, wire, gamma, out, k, p);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// B8 consensus_mix: OUT = W + gamma * sum_i eta_i (NB_i - W), f32 accumulate,
// OUT in W's dtype (f32 or bf16); W (E,), NB (N, E), eta (N,), gamma (1,).
//
// Replaces src/repro/kernels/consensus_mix.py::consensus_mix, whose Pallas
// body streams (block_rows, 128) tiles of W and the N neighbor tiles through
// VMEM with the N+1 scalars in one (1, N+1) block. Here:
//
// * What bounds it on the H100: bytes. Each element is read N+1 times (W
//   once, each neighbor once) and written once, with 2N+1 flops: at N=8 that
//   is 0.4 flop per f32 byte, far under the card's balance point, so the
//   least time is (N+2)*E*bytes / 3.35 TB/s. At the paper MLP's size (E =
//   23,936, N=2) that is 0.1 us and the call is launch-bound.
// * One streaming pass. Each thread owns 16-byte runs (4 f32 or 8 bf16
//   values), loads its W run once, walks the N neighbor runs with one
//   16-byte load each, accumulates eta_i * (nb_i - w) in f32 registers and
//   writes w + gamma * acc once, cast to W's dtype. The TPU tile shape has
//   no meaning here: any E is accepted.
// * eta and gamma are read on the device (no host synchronization) and
//   staged once per block in shared memory; every thread then reads the
//   same entry, a broadcast.
// * Ragged sizes. The 16-byte path needs E % V == 0 and 16-byte aligned
//   pointers; otherwise the launch takes the scalar path (V = 1).
constexpr int kNbThreads = 256;
constexpr long long kNbMaxBlocks = 1 << 20;

__device__ __forceinline__ void load_run(const float* p, float (&x)[1]) {
  x[0] = p[0];
}
__device__ __forceinline__ void load_run(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&x)[1]) {
  x[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_run(float* p, const float (&x)[1]) {
  p[0] = x[0];
}
__device__ __forceinline__ void store_run(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&x)[1]) {
  p[0] = __float2bfloat16(x[0]);
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&x)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename T, int V>
__global__ void __launch_bounds__(kNbThreads)
neighbor_mix_kernel(const T* __restrict__ w, const T* __restrict__ nb,
                    const float* __restrict__ eta,
                    const float* __restrict__ gamma, T* __restrict__ out,
                    int n, long long e) {
  extern __shared__ float s_scal[];   // [gamma, eta_0 .. eta_{N-1}]
  for (int i = threadIdx.x; i <= n; i += kNbThreads) {
    s_scal[i] = i == 0 ? gamma[0] : eta[i - 1];
  }
  __syncthreads();
  const float g = s_scal[0];
  const long long runs = e / V;
  for (long long r = (long long)blockIdx.x * kNbThreads + threadIdx.x;
       r < runs; r += (long long)gridDim.x * kNbThreads) {
    const long long o = r * V;
    float x[V], acc[V];
    load_run(w + o, x);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int i = 0; i < n; ++i) {
      float y[V];
      load_run(nb + (long long)i * e + o, y);
      const float a = s_scal[i + 1];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(a, y[v] - x[v], acc[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = fmaf(g, acc[v], x[v]);
    store_run(out + o, x);
  }
}

template <typename T, int V>
int launch_neighbor(const T* w, const T* nb, const float* eta,
                    const float* gamma, T* out, int n, long long e,
                    cudaStream_t s) {
  const long long runs = e / V;
  long long blocks = (runs + kNbThreads - 1) / kNbThreads;
  if (blocks > kNbMaxBlocks) blocks = kNbMaxBlocks;
  const size_t smem = (size_t)(n + 1) * sizeof(float);
  neighbor_mix_kernel<T, V><<<(unsigned)blocks, kNbThreads, smem, s>>>(
      w, nb, eta, gamma, out, n, e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename T>
int neighbor_mix(const void* w, const void* nb, const void* eta,
                 const void* gamma, void* out, int n, int e, void* stream) {
  if (n < 1 || e < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pw = static_cast<const T*>(w);
  const auto* pn = static_cast<const T*>(nb);
  const auto* pe = static_cast<const float*>(eta);
  const auto* pg = static_cast<const float*>(gamma);
  auto* po = static_cast<T*>(out);
  if (e % kVec == 0 && aligned16(w) && aligned16(nb) && aligned16(out)) {
    return launch_neighbor<T, kVec>(pw, pn, pe, pg, po, n, e, s);
  }
  return launch_neighbor<T, 1>(pw, pn, pe, pg, po, n, e, s);
}

}  // namespace

extern "C" int repro_flat_mix_f32(const void* eta, const void* master,
                                  const void* wire, const void* gamma,
                                  void* out, int k, int p, void* stream) {
  return launch<true, float>(
      static_cast<const float*>(eta), static_cast<const float*>(master),
      static_cast<const float*>(wire), static_cast<const float*>(gamma),
      static_cast<float*>(out), k, p, stream);
}

extern "C" int repro_flat_mix_bf16(const void* eta, const void* master,
                                   const void* wire, const void* gamma,
                                   void* out, int k, int p, void* stream) {
  return launch<true, __nv_bfloat16>(
      static_cast<const float*>(eta), static_cast<const float*>(master),
      static_cast<const __nv_bfloat16*>(wire),
      static_cast<const float*>(gamma), static_cast<float*>(out), k, p,
      stream);
}

extern "C" int repro_flat_consensus(const void* a, const void* buf, void* out,
                                    int k, int p, void* stream) {
  return launch<false, float>(
      static_cast<const float*>(a), nullptr, static_cast<const float*>(buf),
      nullptr, static_cast<float*>(out), k, p, stream);
}

extern "C" int repro_consensus_mix_f32(const void* w, const void* nb,
                                       const void* eta, const void* gamma,
                                       void* out, int n, int e,
                                       void* stream) {
  return neighbor_mix<float>(w, nb, eta, gamma, out, n, e, stream);
}

extern "C" int repro_consensus_mix_bf16(const void* w, const void* nb,
                                        const void* eta, const void* gamma,
                                        void* out, int n, int e,
                                        void* stream) {
  return neighbor_mix<__nv_bfloat16>(w, nb, eta, gamma, out, n, e, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
