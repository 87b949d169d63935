// Hand-written Hopper kernel for coordinate-wise Byzantine-robust
// aggregation on the flat (K, P) parameter buffer (kernel B7):
//
//   OUT[k, p] = sum_j W[k, j] * sort_i{ payload_i[p] : MASK[k, i] > 0 }[j]
//
// where payload_i is SENT[i] for a neighbor and BUF[k] for receiver k's own
// slot, the sort is ascending, masked slots count as +inf (past every live
// value) and every non-finite sorted value contributes 0. W is any (K, K)
// matrix of position weights (trimmed mean or median from
// faults/robust.py::sorted_weights, but not only a band); an empty row
// gives 0.
//
// Replaces src/repro/kernels/robust_agg.py::robust_agg (the Pallas TPU
// kernel). The TPU version builds the (K, K, block) candidate tensor in VMEM
// and sorts every receiver's candidates with K passes of an odd-even
// transposition network, because VMEM code cannot branch on data. Here:
//
// * What bounds it on the H100: issue slots. Every (receiver, sender,
//   column) triple is one step of a walk, K*K*P steps (1.57e9 at K=256,
//   P=23,936) against 12 bytes per element of traffic, so the kernel is far
//   from the HBM bound; the (K, K, P) candidate tensor is never
//   materialized. The design cuts the instructions a step (chip_smoke.py
//   counts them in the SASS of the walk's loop) and keeps every lane of a
//   warp on the same instruction.
// * A first small kernel packs the mask (per sender, one 32-bit word per
//   group of 32 receivers, by ballot) and writes W transposed by receiver
//   group, Wt[g][i][t] = W[32g + t, i], into the scratch buffer.
// * One block owns TC consecutive columns. It stages the K sender values of
//   each column in shared memory as 64-bit (order-preserving key, sender
//   index) pairs and sorts each column ONCE with a bitonic network: every
//   receiver group below reuses it. A warp's pairs of a stride below 64
//   lie in 64-element segments no other warp touches, so only the strides
//   of 64 and more take block barriers (3 of 36 stages at K = 256).
// * The walk is transposed: a warp owns 32 receivers (one 32-bit mask word)
//   and one column, and walks the column's sorted senders s = 0..K-1 in
//   order. Per receiver group g the block copies Wt[g] into shared memory
//   with 16-byte cp.async copies, Ws[pos][lane] (bank = lane whatever pos a
//   lane reads: no conflicts), stages the group's K mask words with the
//   receivers' own slots cleared, and runs, four interleaved a thread, the
//   branch-free binary searches for T, the first sorted slot whose key is
//   not below a receiver's own value's key. Per column the warp writes the
//   sorted (scrubbed value, mask word) pairs into its own row; then every
//   step is a broadcast 16-byte read of two pairs and, per lane, predicated
//   arithmetic with no data-dependent branch:
//
//       at = s == T:   own_pos = pos; pos += at          (own value slots in)
//       live = word >> lane & 1
//       acc += live ? Ws[pos][lane] * v : 0;  pos += live
//
//   and after the walk acc += Ws[own_pos][lane] * scrub(own) when the own
//   slot is live. These are the positions of the column walk's merge
//   (own before every sender whose key is not smaller).
// * The 32 x TC own/out tile goes through shared memory so that BUF is read
//   and OUT written in rows. TC is the widest multiple of the 8 warps (at
//   most 32) that leaves two blocks an SM (113 KB each): 24 at K = 256, 32
//   at K = 64; else the widest that fits (5 at K = 1024, one block an SM,
//   128 KB of Ws).
// * Up to K = kColumnWalkMaxK a column-major walk runs instead (a lane
//   owns one (receiver, column) and merges its own value in by a branch):
//   with fewer receivers than a warp's 32 lanes it wins: timed side by side
//   on the H100 at P = 23,936, it is faster up to K = 17, the group walk
//   from K = 20.
// * Timed side by side and dropped: W's rows read from device memory and
//   transposed in every group (slower than the prepared Wt); the binary
//   searches inside each warp's walk (latency-bound); a warp sorting one
//   column with no block barrier (no faster at K = 256, slower at small
//   K); eight consecutive pairs a thread sorted in registers in
//   warp-owned 256-element segments (a little faster at K = 256, slower at
//   K <= 128: 128 registers, idle lanes on short columns); 16 and 8
//   columns a block, and 32 with one block an SM.
// * Order keys map a float to a uint32 that sorts like the float (-inf
//   first, -0 before +0); NaN maps to the largest key, after +inf, as the
//   reference's sort places it. Equal values may sort in either order: they
//   give the same weighted sum.
// * K <= 1024 (the sender index fits the key's low word; shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNodes = 1024;
constexpr int kMaxDevices = 64;
constexpr int kMaxCols = 32;                // columns a block owns
constexpr int kColumnWalkMaxK = 17;         // K at and below: column walk
constexpr int kSortElems = 8192;            // column walk: TC * Kp pairs
constexpr size_t kSmemLimit = 232448;       // bytes a block may opt into
constexpr size_t kTwoBlocks = 115712;       // two blocks an SM (1 KB each
                                            // reserved of 228 KB)
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

// Per sender i and receiver group g (one warp, lane t): bits[i * kw + g]
// bit t = MASK[32 g + t, i] > 0, the word of the 32 receivers that hear i;
// and wt[(g * K + i) * 32 + t] = W[32 g + t, i], group g's rows of W
// transposed, which a block then stages with contiguous 16-byte copies.
__global__ void robust_agg_prep(const float* __restrict__ w,
                                const float* __restrict__ mask,
                                uint32_t* __restrict__ bits,
                                float* __restrict__ wt, int k, int kw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = e & 31, gi = e >> 5;
  if (gi >= kw * k) return;            // whole warps: gi is the warp's
  const int g = gi / k, i = gi % k, r = 32 * g + t;
  const bool in = r < k;
  const uint32_t word =
      __ballot_sync(0xFFFFFFFFu, in && mask[(size_t)r * k + i] > 0.f);
  wt[e] = in ? w[(size_t)r * k + i] : 0.f;
  if (t == 0) bits[(size_t)i * kw + g] = word;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// Stage the (key, sender) pairs of columns col0.. col0+tc-1 column-major
// (row pitch kp + 1; padding sorts last).
__device__ void stage_columns(unsigned long long* s_col,
                              const float* __restrict__ sent, int k, int p,
                              int kp, int tc, int col0) {
  const int stride = kp + 1;
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
}

// One bitonic compare-exchange stage (size, st) over pairs j of a column.
__device__ __forceinline__ void bitonic_step(unsigned long long* col, int j,
                                             int size, int st) {
  const int lo = 2 * j - (j & (st - 1));
  const unsigned long long a = col[lo], b = col[lo + st];
  const bool up = (lo & size) == 0;
  col[lo] = up ? min(a, b) : max(a, b);
  col[lo + st] = up ? max(a, b) : min(a, b);
}

// Sort every staged column ascending with a bitonic network. Thread e of
// a stage owns pair e of the tile; a warp's pairs of a stride below 64 lie
// in 64-element segments that no other warp touches, so only the strides
// of 64 and more take block barriers (3 of 36 stages at K = 256).
__device__ void sort_columns(unsigned long long* s_col, int kp, int tc) {
  __syncthreads();
  if (kp < 2) return;
  const int half = kp >> 1, lh = __ffs(half) - 1;   // half = 2^lh
  for (int size = 2; size <= kp; size <<= 1) {
    for (int st = size >> 1; st > 0; st >>= 1) {
      const bool wide = st >= 64;
      if (wide) __syncthreads();
      for (int e = threadIdx.x; e < half * tc; e += kThreads)
        bitonic_step(s_col + (e >> lh) * (kp + 1), e & (half - 1), size,
                     st);
      if (wide) __syncthreads();
      else __syncwarp();
    }
  }
  __syncthreads();
}

// Small K: every (receiver, column) item walks its column's sorted senders,
// skips the ones outside its mask and merges its own value in by a branch.
__global__ void __launch_bounds__(kThreads)
robust_agg_column_walk(const float* __restrict__ w,
                       const uint32_t* __restrict__ bits,
                       const float* __restrict__ buf,
                       const float* __restrict__ sent,
                       float* __restrict__ out, int k, int p, int kp, int tc,
                       int kw) {
  extern __shared__ __align__(16) unsigned long long s_col[];
  const int stride = kp + 1;
  const int col0 = blockIdx.x * tc;
  stage_columns(s_col, sent, k, p, kp, tc, col0);
  sort_columns(s_col, kp, tc);
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

// Shared-memory plan of the receiver-group walk for one K.
struct Plan {
  int kp;      // K rounded up to a power of two (the bitonic sort)
  int kr;      // K rounded up to even: a walk row of (value, word) pairs
  int tc;      // columns a block
  int nw;      // warps that walk (one column each at a time)
  int ios;     // pitch of the 32 x TC own/out and T tiles (odd)
  size_t sort_words;   // 8-byte words of the sorted tile (even)
  size_t bytes;
};

inline Plan make_plan(int k, int tc) {
  Plan pl;
  pl.kp = 1;
  while (pl.kp < k) pl.kp <<= 1;
  pl.kr = k + (k & 1);
  pl.tc = tc;
  pl.nw = tc < kWarps ? tc : kWarps;
  pl.ios = (tc + 1) | 1;
  pl.sort_words = ((size_t)tc * (pl.kp + 1) + 1) & ~(size_t)1;
  pl.bytes = pl.sort_words * 8 +                 // sorted (key, sender)
             (size_t)pl.nw * pl.kr * 8 +         // per-warp walk rows
             (size_t)(k + 1) * 32 * 4 +          // Ws (+ one spare row)
             (size_t)k * 4 +                     // the group's mask words
             (size_t)2 * 32 * pl.ios * 4;        // own/out tile, T tile
  return pl;
}

// The widest tile that keeps two blocks an SM, else one; a multiple of the
// warp count where one fits, so that every warp walks as many columns.
inline Plan choose_plan(int k) {
  const size_t budgets[2] = {kTwoBlocks, kSmemLimit};
  const int steps[2] = {kWarps, 1};
  for (size_t budget : budgets) {
    for (int step : steps) {
      for (int tc = kMaxCols; tc >= step; tc -= step) {
        const Plan pl = make_plan(k, tc - tc % step);
        if (pl.bytes <= budget) return pl;
      }
    }
  }
  return make_plan(k, 1);   // unreachable for K <= kMaxNodes
}

// One step of the walk, predicated: when s == T the own value takes the
// slot at pos; a live sender adds Ws[pos] * v and takes the next slot. pos
// is the shared-memory byte address of Ws[slot][lane]: a slot is 128 bytes.
// d = T - (the slot of J = 0).
template <int J>
__device__ __forceinline__ void walk_step(uint32_t& pos, uint32_t& own_pos,
                                          float& acc, uint32_t word, float v,
                                          uint32_t lanebit, int d) {
  asm("{\n\t"
      ".reg .pred at, live;\n\t"
      ".reg .b32 bit;\n\t"
      ".reg .f32 wv;\n\t"
      "setp.eq.s32 at, %6, %7;\n\t"
      "@at mov.b32 %1, %0;\n\t"
      "@at add.s32 %0, %0, 128;\n\t"
      "and.b32 bit, %3, %5;\n\t"
      "setp.ne.b32 live, bit, 0;\n\t"
      "@live ld.shared.f32 wv, [%0];\n\t"
      "@live fma.rn.f32 %2, wv, %4, %2;\n\t"
      "@live add.s32 %0, %0, 128;\n\t"
      "}"
      : "+r"(pos), "+r"(own_pos), "+f"(acc)
      : "r"(word), "f"(v), "r"(lanebit), "r"(d), "n"(J));
}

// slots 2J and 2J + 1 from one 16-byte read of two (value, word) pairs
template <int J>
__device__ __forceinline__ void walk_pair(uint32_t& pos, uint32_t& own_pos,
                                          float& acc, uint4 e,
                                          uint32_t lanebit, int d) {
  walk_step<2 * J>(pos, own_pos, acc, e.y, __uint_as_float(e.x), lanebit, d);
  walk_step<2 * J + 1>(pos, own_pos, acc, e.w, __uint_as_float(e.z), lanebit,
                       d);
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

constexpr int kSearchIlp = 4;   // lower bounds a thread runs interleaved

__global__ void __launch_bounds__(kThreads, 2)
robust_agg_group_walk(const float* __restrict__ wt,
                      const uint32_t* __restrict__ bits,
                      const float* __restrict__ buf,
                      const float* __restrict__ sent, float* __restrict__ out,
                      int k, int p, Plan pl, int kw) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const int kp = pl.kp, kr = pl.kr, tc = pl.tc, nw = pl.nw, ios = pl.ios;
  const int stride = kp + 1;
  unsigned long long* const s_col = smem;
  uint2* const s_work = reinterpret_cast<uint2*>(smem + pl.sort_words);
  float* const s_w = reinterpret_cast<float*>(s_work + (size_t)nw * kr);
  uint32_t* const s_bits =
      reinterpret_cast<uint32_t*>(s_w + (size_t)(k + 1) * 32);
  float* const s_io = reinterpret_cast<float*>(s_bits + k);
  int* const s_t = reinterpret_cast<int*>(s_io + 32 * ios);

  const int col0 = blockIdx.x * tc;
  const int cols = min(tc, p - col0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lanebit = 1u << lane;
  uint2* const row = s_work + (size_t)warp * kr;
  const uint32_t ws_lane =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_w)) + 4 * lane;

  stage_columns(s_col, sent, k, p, kp, tc, col0);
  sort_columns(s_col, kp, tc);

  for (int g = 0; g * 32 < k; ++g) {
    const int r0 = 32 * g;
    // W's rows r0.. r0+31 transposed (copies in flight over the search),
    // and the group's mask words
    const float* wt_g = wt + (size_t)g * k * 32;
    for (int q = threadIdx.x; q < k * 8; q += kThreads)
      cp_async16(s_w + 4 * q, wt_g + 4 * q);
    for (int i = threadIdx.x; i < k; i += kThreads) {
      uint32_t word = __ldg(bits + (size_t)i * kw + g);
      if ((i >> 5) == g) word &= ~(1u << (i & 31));   // the own slot
      s_bits[i] = word;
    }
    // the own tile, and per (receiver, column) the first sorted slot T
    // whose key is not below the own value's (-1: own slot masked off),
    // kSearchIlp branch-free lower bounds interleaved a thread. A slot is
    // read below (out) by the thread that refills it here, so no barrier
    // sits between one group's store and the next group's staging.
    for (int e0 = threadIdx.x; e0 < 32 * tc; e0 += kThreads * kSearchIlp) {
      uint32_t key[kSearchIlp];
      int lo[kSearchIlp];
      const unsigned long long* sc[kSearchIlp];
#pragma unroll
      for (int j = 0; j < kSearchIlp; ++j) {
        const int e = e0 + j * kThreads;
        const int t = e / tc, c = e % tc, r = r0 + t;
        const bool in = e < 32 * tc && r < k && c < cols;
        const float own = in ? buf[(size_t)r * p + col0 + c] : 0.f;
        if (e < 32 * tc) s_io[t * ios + c] = own;
        key[j] = sort_key(own);
        sc[j] = s_col + (size_t)(in ? c : 0) * stride;
        lo[j] = 0;
      }
      for (int n = k; n > 1;) {
        const int half = n >> 1;
#pragma unroll
        for (int j = 0; j < kSearchIlp; ++j) {
          lo[j] = static_cast<uint32_t>(sc[j][lo[j] + half] >> 32) < key[j]
                      ? lo[j] + half : lo[j];
        }
        n -= half;
      }
#pragma unroll
      for (int j = 0; j < kSearchIlp; ++j) {
        const int e = e0 + j * kThreads;
        if (e >= 32 * tc) continue;
        const int t = e / tc, c = e % tc, r = r0 + t;
        const bool live =
            r < k && c < cols &&
            ((__ldg(bits + (size_t)r * kw + g) >> t) & 1u);
        lo[j] += static_cast<uint32_t>(sc[j][lo[j]] >> 32) < key[j] ? 1 : 0;
        s_t[t * ios + c] = live ? lo[j] : -1;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    for (int c = warp; c < cols && warp < nw; c += nw) {
      // this column's sorted (scrubbed value, mask word) pairs
      const unsigned long long* sc = s_col + (size_t)c * stride;
      for (int s = lane; s < kr; s += 32) {
        uint2 e = make_uint2(0u, 0u);
        if (s < k) {
          const unsigned long long v = sc[s];
          e.x = __float_as_uint(scrub(key_value(static_cast<uint32_t>(
              v >> 32))));
          e.y = s_bits[static_cast<uint32_t>(v)];
        }
        row[s] = e;
      }
      __syncwarp();
      const float own = s_io[lane * ios + c];
      const int t = s_t[lane * ios + c];
      uint32_t pos = ws_lane, own_pos = ws_lane;
      float acc = 0.f;
      const uint4* pairs = reinterpret_cast<const uint4*>(row);
      int s = 0;
      for (; s + 8 <= kr; s += 8) {
        const int d = t - s;
        walk_pair<0>(pos, own_pos, acc, pairs[s / 2], lanebit, d);
        walk_pair<1>(pos, own_pos, acc, pairs[s / 2 + 1], lanebit, d);
        walk_pair<2>(pos, own_pos, acc, pairs[s / 2 + 2], lanebit, d);
        walk_pair<3>(pos, own_pos, acc, pairs[s / 2 + 3], lanebit, d);
      }
      for (; s < kr; s += 2)
        walk_pair<0>(pos, own_pos, acc, pairs[s / 2], lanebit, t - s);
      if (t == kr) own_pos = pos;      // own after every sender
      if (t >= 0) acc = fmaf(ld_shared(own_pos), scrub(own), acc);
      s_io[lane * ios + c] = acc;
      __syncwarp();
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 32 * tc; e += kThreads) {
      const int t = e / tc, c = e % tc;
      if (r0 + t < k && c < cols)
        out[(size_t)(r0 + t) * p + col0 + c] = s_io[t * ios + c];
    }
  }
}

// opt a kernel into `bytes` of dynamic shared memory once per device (and so
// never while a CUDA graph captures a launch)
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// the packed mask's words in the scratch buffer, rounded up so that Wt
// starts 16-byte aligned after them
int mask_words(int k) { return (k * ((k + 31) / 32) + 3) & ~3; }

}  // namespace

// weights, mask (K, K) f32; buf, sent, out (K, P) f32; scratch: int32 of
// repro_robust_agg_scratch_words(K) words (the packed mask, W transposed by
// receiver group). Returns cudaGetLastError() after the launches.
extern "C" int repro_robust_agg_scratch_words(int k) {
  return mask_words(k) + (k + 31) / 32 * k * 32;
}

extern "C" int repro_robust_agg(const void* weights, const void* mask,
                                const void* buf, const void* sent,
                                void* scratch, void* out, int k, int p,
                                void* stream) {
  if (k < 1 || k > kMaxNodes || p < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kw = (k + 31) / 32;
  auto* bits = static_cast<uint32_t*>(scratch);
  auto* wt = reinterpret_cast<float*>(bits + mask_words(k));
  const auto* wf = static_cast<const float*>(weights);
  const auto* bf = static_cast<const float*>(buf);
  const auto* sf = static_cast<const float*>(sent);
  auto* of = static_cast<float*>(out);
  robust_agg_prep<<<(kw * k * 32 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      wf, static_cast<const float*>(mask), bits, wt, k, kw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= kColumnWalkMaxK) {
    static bool opted[kMaxDevices] = {};
    int kp = 1;
    while (kp < k) kp <<= 1;
    int tc = kSortElems / kp;
    tc = tc > kMaxCols ? kMaxCols : tc;
    const size_t smem = (size_t)tc * (kp + 1) * sizeof(unsigned long long);
    err = opt_in(robust_agg_column_walk, smem, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    robust_agg_column_walk<<<(p + tc - 1) / tc, kThreads, smem, s>>>(
        wf, bits, bf, sf, of, k, p, kp, tc, kw);
    return static_cast<int>(cudaGetLastError());
  }
  static bool opted[kMaxDevices] = {};
  const Plan pl = choose_plan(k);
  err = opt_in(robust_agg_group_walk, pl.bytes, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  robust_agg_group_walk<<<(p + pl.tc - 1) / pl.tc, kThreads, pl.bytes, s>>>(
      wt, bits, bf, sf, of, k, p, pl, kw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
