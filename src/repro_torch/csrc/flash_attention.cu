// Hand-written Hopper kernel B9: blockwise online-softmax attention with
// GQA, causal and sliding-window masks.
//
//   OUT[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over the live keys j of query i (causal: j <= i; window W: j > i - W; q at
// position 0), scale = D**-0.5, G = H / KV. It replaces
// src/repro/kernels/flash_attention.py::flash_attention, the Pallas TPU
// kernel, which runs the grid (B, H, Sq/bq, Sk/bk) with the last axis in
// order and keeps the running max, denominator and accumulator in VMEM.
// Inputs are read from (B, S, H, D) in place: the kv head of query head h
// is h / G, and nothing is transposed or repeated in device memory. A query
// row with no live key at all gets the uniform average of v over all Sk
// keys, as the TPU kernel (its -1e30 scores make every p exactly 1 until a
// live key arrives) and the reference attend give it; causal prefill always
// has the diagonal key, so no caller of the model path reaches that branch.
//
// What bounds it on the H100. Causal prefill of qwen3-1.7b (B=4, S=2048,
// H=16, KV=8, D=128) does 4*B*H*D*S*(S+1)/2 = 69 GFLOP on 50 MB of q, k, v
// and out: far above the ridge, so the operations bound it, 0.070 ms at the
// tensor cores' bf16 rate (989 TFLOP/s), 1.0 ms at the CUDA cores' f32 rate.
// So the two instantiations differ:
//
// * f32 (namespace f32): f32 FMAs on the CUDA cores. "f32 means f32": TF32
//   would keep about three decimal digits and break the 2e-5 gate. Its
//   path's shape is the f32 serving prefill and every qwen3-1.7b training
//   forward: B=4 S=128 H=16 KV=8 D=128 causal, 270 MFLOP on 3 MB, bound by
//   the operations at 0.00404 ms (67 TFLOP/s), about 4 us of work spread
//   over 132 SMs, so parallelism, balance and the copies' latency matter
//   as much as the FMA rate.
//   - Rows. The G query heads of a kv head share its k and v, so a q tile
//     is 32 flattened (position, head) rows of one (batch, kv head), row R
//     being position R / G of head kv_head * G + R % G: each staged k/v
//     tile serves G heads. A block owns two q tiles, p and nt - 1 - p:
//     under a causal mask the shortest rows ride with the longest, so the
//     blocks do about the same work and share each k/v tile (128 blocks of
//     8 warps at the path's shape, one an SM).
//   - Lanes. A row is shared by L = 16 lanes (8 at D = 32). A lane owns 4
//     rows, their score columns x + L j of a tile of 64 keys (j < 64 / L)
//     and their output columns 4x + 4L c .. + 3, so both products read
//     float4 operands from shared memory for 8 to 10.7 FMAs a read; the
//     running max m, the lane's share of the denominator l and the
//     accumulator stay in registers, and a row's max takes log2 L
//     shuffles (its l shares are added once, at the end).
//   - Key chunks. Keys L j .. L j + L - 1 of a tile form chunk j; a warp
//     runs only the chunks that hold a live pair for its rows, through a
//     step instantiated for each count of live chunks, so no branch sits
//     in the inner loops (a branch per chunk in the score loop ran 1.57x
//     slower than no skip at all), and the causal diagonal costs 16-key
//     chunks, not tiles.
//   - Copies. q, then k and v of each key tile go through a ring of two
//     stages with 16-byte cp.async copies by every thread; the scores of
//     the first tile wait for q and its k only, and the next tile's k and
//     v are issued as a tile starts, so they land under its products.
//     Inputs that are not 16-byte aligned are staged with plain loads.
//   - Softmax. In f32 on raw scores, exp2 with scale * log2 e folded in;
//     keys past Sk are zeros, so a dead key's p = 0 meets a finite v.
//   - Shared memory: 184,320 bytes at D = 128 (102,400 at 64, 61,440 at
//     32), opted in; q [64][D + 4], k [64][D + 4] and v [64][D] a stage,
//     p [64][68]. The pitch D + 4 puts the float4 reads of 8 k rows on 32
//     banks, and 68 the p stores of a warp's two row groups on disjoint
//     banks. ptxas: 168 registers at D = 128, 152 at 64, 168 at 32, no
//     spills (chip_smoke.py prints them and fails on a spill).
//   - Measured (PERF.md, section 6): about 4.7 us pass before a block's
//     first scores (its arithmetic setup, about 1 us, and the first
//     copies), and the tile steps run the FMAs at about a third of their
//     peak. Tried, each against the kept design in one run on the same
//     card, and dropped: 2 rows a lane (fewer FMAs a read: 1.07x slower
//     than 4 rows without the chunk skip), one q tile a block in any order
//     and 16- or 64-row q tiles or 16-key tiles with 2 rows a lane (no
//     faster than pairs), one producer warp issuing every copy against
//     mbarriers (by cp.async 1.16x, by bulk TMA rows 1.05x slower: a single
//     warp issues too slowly), and clusters of 4 blocks sharing each k/v
//     tile by multicast (2.07x slower: clusters of four 184 KB blocks fit
//     on fewer SMs and ran in two waves).
//
// * bf16 (namespace tc): the products run on the tensor cores (wgmma, bf16
//   in, f32 accumulators), fed by TMA.
//   - Tiling. A block of 288 threads owns 128 query rows of one (batch,
//     head): two consumer warpgroups of 64 rows each, and one producer
//     warp. The blocks of the longest rows start first. The block walks
//     the key tiles of 64 that can be live for any of its rows, in order;
//     a warpgroup skips the arithmetic of a tile wholly dead for its rows
//     and the mask of a tile wholly live for them.
//   - Copies. One thread of the producer warp issues TMA copies through
//     4-D tensor maps over (B, S, heads, D), encoded on the host for each
//     call and passed as __grid_constant__ parameters (a CUDA graph
//     captures them by value). q's 128 rows arrive once; k and v tiles go
//     through a ring of two stages guarded by full (TMA bytes) and empty
//     (one arrival per consumer warp) mbarriers, so the next tile's copy
//     runs while the warpgroups compute on this one. Tiles are panels of
//     64 columns under the 128-byte swizzle (D=128 takes two panels; D=32
//     one panel of 32 under the 64-byte swizzle), which is the layout
//     wgmma reads without bank conflicts. TMA fills rows past S with
//     zeros; the masks keep them out.
//   - Scores. S = q k^T by wgmma m64n64k16, q and k both from shared
//     memory in their natural K-major layout (d contiguous); the scale is
//     applied to the f32 scores (D**-0.5 is not a power of two at D = 32
//     or 128, so a scaled bf16 q would round), folded with log2 e into
//     exp2f. Softmax runs in registers on the accumulator's layout: a row
//     lives on the four lanes of a quad, so its max takes two shuffles;
//     the denominator l is summed from the f32 p.
//   - p . v, and why p goes in as two bf16 terms. The tensor cores take p
//     in bf16, but the TPU kernel, the plain version and the f32 kernel
//     keep p in f32, and chip_smoke.py holds bf16 B9 to one bf16 ulp of
//     the f32 plain version. A p rounded once to bf16 errs by up to 2**-9
//     relative in every term, and the terms' errors add up: tens of ulp
//     of the output at worst, thousands of outputs past one ulp at the
//     shapes of tests/test_torch_flash_attention.py, which emulates both
//     on the CPU. So p is split, p_hi = bf16(p), p_lo = bf16(p - p_hi),
//     and both go through wgmma m64nDk16 into one f32 accumulator: v is
//     exact in bf16 and p_hi + p_lo carries about 16 bits of p, so the
//     output stays within about half an ulp, as with f32 p. The second
//     product makes each computed tile cost 1.5x the operations. p
//     comes from registers: the score accumulator's layout is already the
//     A operand's (see the note above the kernel), so it is converted in
//     place, as FlashAttention-3 does; v is read from shared memory
//     MN-major through the transpose bit, as it lies.
//   - Rows past Sq are computed on TMA's zero fill and not stored; the
//     output is O / max(l, 1e-30), written as bf16 pairs.
//   - Within a warpgroup each tile runs in turn: scores, softmax, p . v.
//     The two warpgroups overlap each other only as the warp schedulers
//     interleave them. Overlapping the next tile's scores with this
//     tile's p . v inside a warpgroup (FlashAttention-3's scheme) and a
//     ring of three stages were measured no faster (PERF.md, section 6).
//   Not done yet: ping-pong of the two warpgroups (one's softmax under
//   the other's products, ordered by named barriers), persistent blocks,
//   sharing a k/v tile among the G query heads of a kv head.
#include <cuda.h>  // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxDevices = 64;

// Opt the kernel in to more than 48 KB of dynamic shared memory, once per
// kernel and device (and so never while a CUDA graph captures a later
// launch).
template <auto kernel>
cudaError_t opt_in_smem(int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

namespace f32 {

constexpr int kRows = 32;   // flattened (position, head) rows a q tile
constexpr int kKeys = 64;   // keys a tile
constexpr int kR = 4;       // rows a lane
constexpr float kLog2e = 1.4426950408889634f;

// Lanes and shared-memory plan of head dim D. A row is shared by L lanes
// (16, or 8 at D = 32, where 8 lanes of 4 columns cover the row): a lane
// owns kR rows, their score columns x + L j (j < KJ: key chunk j of a
// tile is keys L j .. L j + L - 1) and their output columns 4x + 4L c ..
// + 3 (c < NC), so a warp owns kR * 32 / L rows and WT warps own a q tile.
// A block owns two q tiles (2 WT warps). In floats: q [2 kRows][QP], two
// stages of k [kKeys][QP] and v [kKeys][D], p [2 kRows][PP]. Every
// shared-memory read is a float4 that 8 lanes of a quarter warp take from
// one address (q, p) or from 8 rows that the pitch D + 4 puts on 32
// different banks (k), or 8 consecutive float4 (v); PP = kKeys + 4 puts
// the p stores of a warp's two row groups on disjoint banks (L = 16).
template <int D>
struct Plan {
  static constexpr int L = D >= 64 ? 16 : 8;
  static constexpr int WROWS = kR * 32 / L;  // rows a warp
  static constexpr int WT = kRows / WROWS;   // warps a q tile
  static constexpr int THREADS = 2 * 32 * WT;
  static constexpr int KJ = kKeys / L;       // key chunks a tile
  static constexpr int NC = D / (4 * L);     // float4 output chunks a lane
  static constexpr int QP = D + 4;
  static constexpr int PP = kKeys + 4;
  static constexpr int K_FLOATS = kKeys * QP;
  static constexpr int STAGE = K_FLOATS + kKeys * D;
  static constexpr int KV_OFF = 2 * kRows * QP;
  static constexpr int P_OFF = KV_OFF + 2 * STAGE;
  static constexpr int BYTES = (P_OFF + 2 * kRows * PP) * 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes from global memory into shared memory: cp.async when the
// source is 16-byte aligned (vec), else four plain loads
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       int vec) {
  if (vec) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[u] = src[u];
  }
}

// x over the L lanes of a row group (lanes L ry .. L ry + L - 1)
template <int L>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < L; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < L; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool live(int kp, int qp, int sk, int causal,
                                     int window) {
  return kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// keys [lo, hi) that can be live for flattened rows [r_lo, r_hi]
__device__ __forceinline__ void key_range(int r_lo, int r_hi, int g, int sk,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = window > 0 ? max(0, r_lo / g - window + 1) : 0;
  hi = causal ? min(sk, r_hi / g + 1) : sk;
}

// A lane's rows and their state: shared-memory row lr, position qp,
// running max m (raw score units), this lane's share of the denominator l
// (its keys x + L j; the L lanes' shares are added at the end), and the
// output accumulator (columns 4x + 4L c .. + 3).
template <int D>
struct Rows {
  int lr[kR], qp[kR];
  float m[kR], l[kR];
  float4 acc[kR][Plan<D>::NC];
};

// The scores of one key tile for one warp's rows, over its key chunks
// j_lo .. j_lo + NJ - 1 (the chunks that hold a live pair for the warp:
// NJ is a template argument so that the inner loops carry no branch),
// then the online softmax, which leaves p in the warp's rows of sP.
template <int D, int NJ>
__device__ __forceinline__ void score_step(Rows<D>& st, const float* sQ,
                                           float* sP, const float* cK, int x,
                                           int k0, int j_lo, bool all_live,
                                           int sk, int causal, int window,
                                           float scale_log2) {
  using P = Plan<D>;
  constexpr int L = P::L, NC = P::NC, QP = P::QP, PP = P::PP;
  const int kx = x + L * j_lo;        // this lane's first key in the tile
  const float* cKx = cK + kx * QP;

  // -- scores: kR rows x NJ keys a lane, float4 steps along d ------------
  float s[kR][NJ];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) a[i] = ld4(sQ + st.lr[i] * QP + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 kk = ld4(cKx + L * j * QP + d);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        s[i][j] = fmaf(a[i].x, kk.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, kk.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, kk.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, kk.w, s[i][j]);
      }
    }
  }

  // -- online softmax in f32, exp2 with scale * log2 e folded in ---------
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (!all_live) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (!live(k0 + kx + L * j, st.qp[i], sk, causal, window))
          s[i][j] = -INFINITY;
    }
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < NJ; ++j) mx = fmaxf(mx, s[i][j]);
    const float m_new = fmaxf(st.m[i], group_max<L>(mx));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f((st.m[i] - m_use) * scale_log2);
    const float nb = -m_use * scale_log2;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = exp2f(fmaf(s[i][j], scale_log2, nb));
      sP[st.lr[i] * PP + kx + L * j] = p;
      rs += p;
    }
    st.l[i] = st.l[i] * alpha + rs;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      st.acc[i][c].x *= alpha;
      st.acc[i][c].y *= alpha;
      st.acc[i][c].z *= alpha;
      st.acc[i][c].w *= alpha;
    }
  }
  __syncwarp();   // the warp's p rows complete
}

// p . v over key chunks j_lo .. j_lo + NJ - 1: kR rows x 4 NC columns a
// lane, 4 keys a step
template <int D, int NJ>
__device__ __forceinline__ void pv_step(Rows<D>& st, const float* sP,
                                        const float* cV, int x, int j_lo) {
  using P = Plan<D>;
  constexpr int L = P::L, NC = P::NC, PP = P::PP;
#pragma unroll 2
  for (int kc = 0; kc < NJ * L; kc += 4) {
    const int key = j_lo * L + kc;
    float pr[kR][4];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float4 p4 = ld4(sP + st.lr[i] * PP + key);
      pr[i][0] = p4.x;
      pr[i][1] = p4.y;
      pr[i][2] = p4.z;
      pr[i][3] = p4.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = ld4(cV + (key + u) * D + 4 * x + 4 * L * c);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          st.acc[i][c].x = fmaf(pr[i][u], vv.x, st.acc[i][c].x);
          st.acc[i][c].y = fmaf(pr[i][u], vv.y, st.acc[i][c].y);
          st.acc[i][c].z = fmaf(pr[i][u], vv.z, st.acc[i][c].z);
          st.acc[i][c].w = fmaf(pr[i][u], vv.w, st.acc[i][c].w);
        }
      }
  }
}

template <int N>
struct Chunks {
  static constexpr int value = N;
};

// f(Chunks<nj>{}) for the chunk count nj, 1 <= nj <= NJ (nothing for
// nj < 1): the runtime count picks a compiled step
template <int NJ, typename F>
__device__ __forceinline__ void with_chunks(int nj, F&& f) {
  if constexpr (NJ >= 1) {
    if (nj == NJ)
      f(Chunks<NJ>{});
    else
      with_chunks<NJ - 1>(nj, f);
  }
}

// Block x of the grid owns the q tiles p and nt - 1 - p of the (batch, kv
// head) x % (B * KV), p = x / (B * KV): under a causal mask the tile of
// the shortest rows rides with the tile of the longest, so every block
// does about the same work, and the two share each staged k/v tile.
// kernels/flash_attention.py::f32_blocks is its Python twin.
template <int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int batch,
             int sq, int sk, int h, int kvh, int causal, int window,
             float scale_log2, int vec) {
  using P = Plan<D>;
  constexpr int L = P::L, KJ = P::KJ, NC = P::NC, QP = P::QP;
  constexpr int WROWS = P::WROWS, WT = P::WT, THREADS = P::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* const sQ = smem;                  // rows of tile a, then of tile b
  float* const sP = smem + P::P_OFF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ry = lane / L, x = lane % L;
  const int g = h / kvh;
  const int rows = sq * g;                 // flattened rows of a kv head
  const int nt = (rows + kRows - 1) / kRows;
  const int nbk = batch * kvh;
  const int pair = (int)(blockIdx.x / nbk);
  const int bk = (int)(blockIdx.x % nbk), b = bk / kvh, kv_head = bk % kvh;
  const int tile_a = pair, tile_b = nt - 1 - pair;   // tile_b >= tile_a
  // flattened row R is position R / g of head kv_head * g + R % g, at
  // q_base + (R / g) * H * D + (R % g) * D
  const size_t q_pos = (size_t)h * D, kv_pos = (size_t)kvh * D;
  const size_t q_base = (size_t)b * sq * q_pos + (size_t)kv_head * g * D;
  const size_t kv_base = (size_t)b * sk * kv_pos + (size_t)kv_head * D;
  auto q_off = [&](int r) {
    return q_base + (size_t)(r / g) * q_pos + (size_t)(r % g) * D;
  };
  // the flattened row of shared-memory row lr (-1: none)
  auto row_of = [&](int lr) {
    const int half = lr / kRows;
    if (half == 1 && tile_b == tile_a) return -1;
    const int r = (half ? tile_b : tile_a) * kRows + lr % kRows;
    return r < rows ? r : -1;
  };

  // keys that can be live for some row of the block: the union of both
  // tiles' ranges, walked in tiles of kKeys
  int lo_a, hi_a, lo_b, hi_b;
  key_range(tile_a * kRows, min(rows, (tile_a + 1) * kRows) - 1, g, sk,
            causal, window, lo_a, hi_a);
  key_range(tile_b * kRows, min(rows, (tile_b + 1) * kRows) - 1, g, sk,
            causal, window, lo_b, hi_b);
  const int k_lo = min(lo_a, lo_b), k_hi = max(hi_a, hi_b);
  const int t0 = k_lo / kKeys;
  const int n_tiles =
      k_hi > t0 * kKeys ? (k_hi - t0 * kKeys + kKeys - 1) / kKeys : 0;
  // this warp's rows and the keys that can be live for them
  const int wl0 = (warp / WT) * kRows + (warp % WT) * WROWS;
  const int wr0 = row_of(wl0);
  const bool warp_rows = wr0 >= 0;
  const int wr1 = warp_rows ? min(rows - 1, wr0 + WROWS - 1) : 0;
  int wk_lo, wk_hi;
  key_range(wr0, wr1, g, sk, causal, window, wk_lo, wk_hi);
  const int wp_first = wr0 / g, wp_last = wr1 / g;

  // k (v) of key tile t (kKeys keys from t * kKeys) into stage s; keys
  // past sk are zeros, so that a dead key's p = 0 meets a finite v
  auto stage = [&](const float* src, int t, int s, int is_v) {
    float* dst = smem + P::KV_OFF + s * P::STAGE + (is_v ? P::K_FLOATS : 0);
    const int pitch = is_v ? D : QP;
    const int k0 = t * kKeys;
    for (int i = tid; i < kKeys * (D / 4); i += THREADS) {
      const int c = i / (D / 4), d = (i % (D / 4)) * 4, kp = k0 + c;
      if (kp < sk)
        stage4(dst + c * pitch + d, src + kv_base + (size_t)kp * kv_pos + d,
               vec);
      else
        *reinterpret_cast<float4*>(dst + c * pitch + d) =
            make_float4(0, 0, 0, 0);
    }
  };

  // copy groups: q with the first k tile, then the first v tile (the
  // scores of tile 0 need only the first), then k and v of each next tile
  for (int i = tid; i < 2 * kRows * (D / 4); i += THREADS) {
    const int lr = i / (D / 4), d = (i % (D / 4)) * 4, r = row_of(lr);
    if (r >= 0)
      stage4(sQ + lr * QP + d, q + q_off(r) + d, vec);
    else
      *reinterpret_cast<float4*>(sQ + lr * QP + d) = make_float4(0, 0, 0, 0);
  }
  if (n_tiles > 0) stage(k, t0, 0, 0);
  cp_async_commit();
  if (n_tiles > 0) stage(v, t0, 0, 1);
  cp_async_commit();

  // this lane's rows: their flattened rows gr and their state
  Rows<D> st;
  int gr[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    st.lr[i] = wl0 + ry * kR + i;
    gr[i] = row_of(st.lr[i]);
    st.qp[i] = gr[i] / g;
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) st.acc[i][c] = make_float4(0, 0, 0, 0);
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t == 0)
      cp_async_wait<1>();   // q and k of tile 0 (v of tile 0 in flight)
    else
      cp_async_wait<0>();
    __syncthreads();   // k of tile t staged; every warp done with t - 1
    if (t + 1 < n_tiles) {
      stage(k, t0 + t + 1, (t + 1) & 1, 0);
      stage(v, t0 + t + 1, (t + 1) & 1, 1);
    }
    cp_async_commit();
    const float* cK = smem + P::KV_OFF + (t & 1) * P::STAGE;
    const float* cV = cK + P::K_FLOATS;
    const int k0 = (t0 + t) * kKeys;
    // the key chunks [j_lo, j_hi) of this tile that hold a live pair for
    // this warp's rows; the others are skipped (they would leave m, l
    // and acc as they are)
    const int j_lo = warp_rows ? max(0, (wk_lo - k0) / L) : 0;
    const int j_hi = warp_rows ? min(KJ, (wk_hi - k0 + L - 1) / L) : 0;
    const int nj = j_hi - j_lo;
    const bool all_live = k0 + kKeys <= sk &&
                          (!causal || k0 + kKeys - 1 <= wp_first) &&
                          (window <= 0 || k0 > wp_last - window);
    with_chunks<KJ>(nj, [&](auto n) {
      score_step<D, decltype(n)::value>(st, sQ, sP, cK, x, k0, j_lo,
                                        all_live, sk, causal, window,
                                        scale_log2);
    });
    if (t == 0) {
      cp_async_wait<1>();   // v of tile 0 (tile 1 in flight)
      __syncthreads();
    }
    with_chunks<KJ>(nj, [&](auto n) {
      pv_step<D, decltype(n)::value>(st, sP, cV, x, j_lo);
    });
  }

  // -- epilogue ---------------------------------------------------------
  cp_async_wait<0>();   // no copy outlives the block (n_tiles == 0)
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float denom = group_sum<L>(st.l[i]);
    if (gr[i] < 0) continue;
    // a row with no live key at all: the uniform average of v over all
    // keys
    const int lo = window > 0 ? max(0, st.qp[i] - window + 1) : 0;
    const int hi = causal ? min(st.qp[i], sk - 1) : sk - 1;
    if (lo > hi) {
#pragma unroll
      for (int c = 0; c < NC; ++c) st.acc[i][c] = make_float4(0, 0, 0, 0);
      for (int j = 0; j < sk; ++j) {
        const float* vr = v + kv_base + (size_t)j * kv_pos + 4 * x;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          st.acc[i][c].x += vr[4 * L * c];
          st.acc[i][c].y += vr[4 * L * c + 1];
          st.acc[i][c].z += vr[4 * L * c + 2];
          st.acc[i][c].w += vr[4 * L * c + 3];
        }
      }
      denom = (float)sk;
    }
    const float inv = 1.f / fmaxf(denom, 1e-30f);
    float* orow = out + q_off(gr[i]) + 4 * x;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 o = make_float4(st.acc[i][c].x * inv, st.acc[i][c].y * inv,
                                   st.acc[i][c].z * inv, st.acc[i][c].w * inv);
      if (vec) {
        *reinterpret_cast<float4*>(orow + 4 * L * c) = o;
      } else {
        orow[4 * L * c] = o.x;
        orow[4 * L * c + 1] = o.y;
        orow[4 * L * c + 2] = o.z;
        orow[4 * L * c + 3] = o.w;
      }
    }
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, void* out, int b, int sq,
        int sk, int h, int kvh, int causal, int window, float scale,
        void* stream) {
  const cudaError_t err = opt_in_smem<flash_kernel<D>>(Plan<D>::BYTES);
  if (err != cudaSuccess) return err;
  const int nt = (sq * (h / kvh) + kRows - 1) / kRows;
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  flash_kernel<D><<<(nt + 1) / 2 * b * kvh, Plan<D>::THREADS, Plan<D>::BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), b, sq, sk, h,
      kvh, causal, window, scale * kLog2e, vec);
  return cudaGetLastError();
}

}  // namespace f32

namespace tc {

constexpr int kBQ = 128;           // query rows per block: two warpgroups
constexpr int kBK = 64;            // keys per tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kConsumers = 2;      // consumer warpgroups, 64 rows each
constexpr int kProducerWarp = kConsumers * 4;
constexpr int kThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of head dim D: q, k and v tiles are cut into
// panels of PC columns (64, or all 32 at D=32), one row of a panel is RB
// bytes (128 or 64) under the matching TMA / wgmma swizzle.
template <int D>
struct Geo {
  static constexpr int PC = D < 64 ? D : 64;
  static constexpr int RB = PC * 2;
  static constexpr int NP = D / PC;
  static constexpr int LAYOUT = RB == 128 ? 1 : 2;   // wgmma: 128B / 64B
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = kBK * D * 2;       // one k or v tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (d, head, position, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head),
      "r"(pos), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {   // every committed group
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching registers an in-flight wgmma owns
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
}

// S (64 x 64, f32) = [S +] A (64 x 16, bf16) . B (16 x 64, bf16), A and B
// read from shared memory, both K-major; accumulate when acc != 0.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// O (64 x N, f32) += A (64 x 16, bf16, registers) . B (16 x N, bf16), B
// read from shared memory MN-major (the transpose bit): v as it lies.
__device__ __forceinline__ void wgmma_pv(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// shared-memory address of stage s's k tile (its v tile follows)
template <int D>
__device__ __forceinline__ uint32_t stage_k(uint32_t base, int s) {
  return base + Geo<D>::Q_BYTES + s * 2 * Geo<D>::KV_BYTES;
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// S = q k^T for 64 rows and a 64-key tile, D / 16 steps of k16: q and k
// panels in shared memory, K-major; within a panel a step is 32 bytes on
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_rows,
                                         uint32_t ks) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / G::PC, off = (kk * 16 % G::PC) * 2;
    wgmma_qk(sc,
             desc(q_rows + p * kBQ * G::RB + off, 16, 8 * G::RB, G::LAYOUT),
             desc(ks + p * kBK * G::RB + off, 16, 8 * G::RB, G::LAYOUT),
             kk > 0);
  }
}

// O += p_hi v + p_lo v over the tile's 64 keys, four steps of k16: v in
// shared memory MN-major, 16 keys a step; LBO steps to the next panel of
// 64 columns, SBO to the next 8 keys
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&ph)[16],
                                         const uint32_t (&pl)[16],
                                         uint32_t vs) {
  using G = Geo<D>;
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const uint64_t bv =
        desc(vs + j * 16 * G::RB, kBK * G::RB, 8 * G::RB, G::LAYOUT);
    const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 1], ph[4 * j + 2],
                              ph[4 * j + 3]};
    const uint32_t a_lo[4] = {pl[4 * j], pl[4 * j + 1], pl[4 * j + 2],
                              pl[4 * j + 3]};
    wgmma_pv(o, a_hi, bv);
    wgmma_pv(o, a_lo, bv);
  }
}

__device__ __forceinline__ bool live(int kp, int qp, int sk, int causal,
                                     int window) {
  return kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

__device__ __forceinline__ bool no_live_key(int qp, int sq, int sk,
                                            int causal, int window) {
  const int lo = window > 0 ? max(0, qp - window + 1) : 0;
  const int hi = causal ? min(qp, sk - 1) : sk - 1;
  return qp < sq && lo > hi;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of one tile, in f32 on the score fragment: mask the
// dead pairs (only where the tile has some), take each row's max (a row
// lives on the four lanes of a quad), p = 2^(s * scale * log2 e - max)
// against a finite max so that no NaN arises, and a thread's share of l
// (the quad sums it once, at the end). sc holds p on return; al0 / al1
// rescale what the accumulator holds of rows r0 / r1.
__device__ __forceinline__ void softmax(float (&sc)[32], float& m0, float& m1,
                                        float& l0, float& l1, float& al0,
                                        float& al1, int k0, int a0, int r0,
                                        int r1, int tq, int sk, int causal,
                                        int window, float scale_log2) {
  const bool all_live = k0 + kBK <= sk && (!causal || k0 + kBK - 1 <= a0) &&
                        (window <= 0 || k0 > a0 + 63 - window);
  if (!all_live) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * i + 2 * tq + e;
        if (!live(kp, r0, sk, causal, window)) sc[4 * i + e] = -INFINITY;
        if (!live(kp, r1, sk, causal, window))
          sc[4 * i + 2 + e] = -INFINITY;
      }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
  const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
  al0 = exp2f((m0 - mu0) * scale_log2);
  al1 = exp2f((m1 - mu1) * scale_log2);
  const float nb0 = -mu0 * scale_log2, nb1 = -mu1 * scale_log2;
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sc[4 * i] = exp2f(fmaf(sc[4 * i], scale_log2, nb0));
    sc[4 * i + 1] = exp2f(fmaf(sc[4 * i + 1], scale_log2, nb0));
    sc[4 * i + 2] = exp2f(fmaf(sc[4 * i + 2], scale_log2, nb1));
    sc[4 * i + 3] = exp2f(fmaf(sc[4 * i + 3], scale_log2, nb1));
    rs0 += sc[4 * i] + sc[4 * i + 1];
    rs1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
}

// p = p_hi + p_lo, two bf16 terms packed as wgmma's A operand: about 16
// bits of p reach v
__device__ __forceinline__ void split_p(const float (&sc)[32],
                                        uint32_t (&ph)[16],
                                        uint32_t (&pl)[16]) {
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(sc[2 * x], sc[2 * x + 1]);
    const float2 hf = __bfloat1622float2(hi);
    ph[x] = as_u32(hi);
    pl[x] = as_u32(
        __floats2bfloat162_rn(sc[2 * x] - hf.x, sc[2 * x + 1] - hf.y));
  }
}

// Thread layout of a 64-row wgmma fragment (accumulator, and A from
// registers): warp w of the warpgroup holds rows 16w + g and 16w + g + 8,
// g = lane / 4; in column group i (8 columns) its values are the columns
// 8i + 2t, 8i + 2t + 1, t = lane % 4, at d[4i], d[4i + 1] (row g) and
// d[4i + 2], d[4i + 3] (row g + 8). A k16 A operand of registers takes
// the same pairs: the scores' columns 16j..16j+15 are A's registers
// pack(d[8j + 2r], d[8j + 2r + 1]), r < 4, with no shuffle.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int sq, int sk, int h,
                int kvh, int causal, int window, float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bar_q = base + G::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                 // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;   // [kStages]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // longest rows first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  // key tiles that can be live for some row of the block
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(sk, q0 + kBQ) : sk;
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi > t_lo * kBK ? (k_hi - t_lo * kBK + kBK - 1) / kBK
                                        : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);   // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // one elected thread keeps the ring full with TMA copies
    if (lane == 0) {
      mbar_expect_tx(bar_q, G::Q_BYTES);
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
        tma_load(s_q + p * kBQ * G::RB, &map_q, bar_q, p * G::PC, head, q0,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, (t / kStages - 1) & 1);
        const uint32_t ks = stage_k<D>(base, s);
        const uint32_t full = bar_full + 8 * s;
        const int k0 = (t_lo + t) * kBK;
        mbar_expect_tx(full, 2 * G::KV_BYTES);
#pragma unroll
        for (int p = 0; p < G::NP; ++p) {
          tma_load(ks + p * kBK * G::RB, &map_k, full, p * G::PC, kv_head, k0,
                   b);
          tma_load(ks + G::KV_BYTES + p * kBK * G::RB, &map_v, full,
                   p * G::PC, kv_head, k0, b);
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wg owns rows a0 .. a0 + 63 ----------------------
  const int wg = warp / 4;
  const int a0 = q0 + wg * 64;
  const int r0 = a0 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
  const int tq = lane % 4;
  const uint32_t q_rows = s_q + wg * 64 * G::RB;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = (t_lo + t) * kBK;
    const uint32_t ks = stage_k<D>(base, s);
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    // a tile with no live pair for these rows (the window's leading tiles;
    // for the first warpgroup, causal's last one) is only released
    if (!(a0 >= sq || (causal && k0 > a0 + 63) ||
          (window > 0 && k0 + kBK - 1 <= a0 - window))) {
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wg_fence();
      issue_qk<D>(sc, q_rows, ks);
      wg_commit();
      wg_wait();
      fence_regs(sc);
      float al0, al1;
      softmax(sc, m0, m1, l0, l1, al0, al1, k0, a0, r0, r1, tq, sk, causal,
              window, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
      }
      uint32_t ph[16], pl[16];
      split_p(sc, ph, pl);
      wg_fence();
      issue_pv<D>(o, ph, pl, ks + G::KV_BYTES);
      wg_commit();
      wg_wait();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
    }
    release(bar_empty + 8 * s, lane);
  }

  // -- epilogue -------------------------------------------------------------
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // a row with no live key at all: the uniform average of v over all keys
  const bool dead0 = no_live_key(r0, sq, sk, causal, window);
  const bool dead1 = no_live_key(r1, sq, sk, causal, window);
  if (dead0 || dead1) {
    const __nv_bfloat16* vb = v + ((size_t)b * sk * kvh + kv_head) * D;
    for (int j = 0; j < sk; ++j) {
      const __nv_bfloat16* vr = vb + (size_t)j * kvh * D + 2 * tq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vr + 8 * i));
        if (dead0) {
          o[4 * i] += x.x;
          o[4 * i + 1] += x.y;
        }
        if (dead1) {
          o[4 * i + 2] += x.x;
          o[4 * i + 3] += x.y;
        }
      }
    }
    if (dead0) l0 = (float)sk;
    if (dead1) l1 = (float)sk;
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const size_t q_pos = (size_t)h * D;
  __nv_bfloat16* ob = out + ((size_t)b * sq * h + head) * D + 2 * tq;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_pos + 8 * i) =
          __floats2bfloat162_rn(o[4 * i] / d0, o[4 * i + 1] / d0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * q_pos + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
  }
}

// cuTensorMapEncodeTiled, reached through the CUDA runtime's entry-point
// query, so that the library links without -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// the map of a (batch, seq, heads, D) bf16 tensor: boxes of `rows`
// positions x PC columns of one head, swizzled as wgmma reads them; rows
// past seq are filled with zeros
template <int D>
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int batch, int seq, int heads, int rows) {
  using G = Geo<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::PC, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int run(const void* q, const void* k, const void* v, void* out, int b, int sq,
        int sk, int h, int kvh, int causal, int window, float scale,
        void* stream) {
  EncodeTiled encode = nullptr;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v;
  if ((err = make_map<D>(encode, &map_q, q, b, sq, h, kBQ)) != cudaSuccess ||
      (err = make_map<D>(encode, &map_k, k, b, sk, kvh, kBK)) != cudaSuccess ||
      (err = make_map<D>(encode, &map_v, v, b, sk, kvh, kBK)) != cudaSuccess)
    return err;
  if ((err = opt_in_smem<flash_tc_kernel<D>>(Geo<D>::SMEM)) != cudaSuccess)
    return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_tc_kernel<D><<<grid, kThreads, Geo<D>::SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), sq, sk, h, kvh, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, KV, D), out (B, Sq, H, D), all contiguous
// in one dtype (bf16: 16-byte aligned, as TMA needs); window <= 0 means no
// window. Returns cudaGetLastError().
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int sq, int sk, int h, int kvh,
                                         int d, int causal, int window,
                                         float scale, void* stream) {
  switch (d) {
    case 32:
      return f32::run<32>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                          scale, stream);
    case 64:
      return f32::run<64>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                          scale, stream);
    case 128:
      return f32::run<128>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                           scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out, int b,
                                          int sq, int sk, int h, int kvh,
                                          int d, int causal, int window,
                                          float scale, void* stream) {
  switch (d) {
    case 32:
      return tc::run<32>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                         scale, stream);
    case 64:
      return tc::run<64>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                         scale, stream);
    case 128:
      return tc::run<128>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                          scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
