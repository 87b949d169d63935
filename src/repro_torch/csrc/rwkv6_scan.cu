// Hand-written Hopper kernel B10: the chunked RWKV6 wkv scan.
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// per (batch, head) over a sequence, from an initial state S_0 (zeros when
// no pointer is given), returning y and the final state in f32. It
// replaces src/repro/kernels/rwkv6_scan.py::rwkv6_scan, the Pallas TPU
// kernel, which runs the grid (B*H, S/C) with the chunk axis in order and
// keeps the D x D f32 state in VMEM. Per chunk of C tokens, with
// L_t = cumsum(log w) inside the chunk, both compute
//
//   y_t  = sum_{i<t} (sum_d r_td k_id e^{L_{t-1,d} - L_{i,d}}) v_i
//          + (r_t . (u * k_t)) v_t + (r_t * e^{L_{t-1}}) @ S
//   S   <- e^{L_C} * S + sum_i (k_i * e^{L_C - L_i}) v_i^T
//
// Every exponent is <= 0 (w in (0, 1]): the pairwise form of the TPU
// kernel, not the model path's k e^{-L} factorisation, which reaches
// e^{+64} at C = 16 and overflows f32 at C = 32 for w below e^{-2.75}.
//
// * What bounds it on the H100. rwkv6-7b's serving prefill (B=4, S=512,
//   H=64, D=64; r/k/v bf16, w f32, y f32) moves about 122 MB and does
//   about 2.7 GFLOP in f32 (the causal half of the C x C pairs, D long,
//   plus 2 D^2 a token each for the state read and the state update;
//   chip_smoke.py's b10_work counts them): 0.036 ms of bytes against
//   0.040 ms of f32 operations on the CUDA cores, about even. The
//   arithmetic is f32 on the CUDA cores (no TF32, no tensor cores),
//   exponentials through exp2 on log2-scaled decays.
// * One block of 256 threads owns one (batch, head) and all its value
//   columns (EV = D; 256 blocks at the serving shape), so each chunk's
//   C x C scores are computed once per head. The sequential chunk axis is
//   a loop inside the block, and the D x D state lives in shared memory
//   for the whole sequence. Where a head's buffers would not fit in
//   227 KB (D = 128 with C = 64) the value columns split over D / EV
//   blocks, each recomputing the scores.
// * Per chunk, four barriers apart:
//   1. prep: a thread owns one channel d and every G-th token (G = 256 /
//      D); log2 w and its cumulative sum L (log2 units) come from a scan
//      across the G lanes of a channel, row by row. It writes L, the
//      carry-in operand r e^{L_{t-1}} (transposed), the update operand
//      k e^{L_C - L_t}, v in f32 and the state's decay e^{L_C}.
//   2. scores: 2 C^2 tasks, 256 a round with no divergence inside a
//      warp: each causal pair (t, i) is summed over four interleaved
//      quarters of its channels by four neighbouring lanes (one exp2 per
//      pair and channel, every exponent <= 0), each bonus r.(u*k) over
//      two halves; shuffles add the parts.
//   3. y: one register-tiled product [A | r e^{L_{t-1}}] @ [v ; S], 4 x 4
//      outputs a thread, the operands read as float4 rows from shared
//      memory, the K = C + D sum split over KS groups of threads.
//   4. the KS partial sums are added and y is stored (float4), and each
//      thread updates a 4 x 4 tile of S in place.
// * r, k, v (as stored: f32 or bf16, widened where they are read) and w
//   of the next chunk are staged with 16-byte cp.async copies: into a
//   second stage at the top of a chunk where two stages fit, else into
//   the one stage after the scores (w then lands in the rows of L it
//   becomes), so the copies overlap the products. Inputs that are not
//   16-byte aligned are staged with plain loads.
// * Shared memory (74 KB at D = 64, C = 16, bf16: two blocks an SM at 128
//   registers a thread; up to 227 KB, one block an SM) is opted into once
//   per instantiation and device, before any CUDA graph captures a
//   launch. Row pitches are padded so that the prep pass's lanes, which
//   walk tokens G apart, hit distinct banks.
// * Timed side by side at the serving shape and dropped: the decays
//   factorised at four sub-chunk starts (a quarter of the exp2, but the
//   extra prep and the products' loads made bf16 slower), 512 threads a
//   block (spills at 64 registers), f32 copies of bf16 r and k for the
//   scores (slower than widening as they are read), and a second state
//   buffer that saves barrier 4 (no faster).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr size_t kSmemLimit = 232448;   // bytes a block may opt into (sm_90)

// Shared-memory plan of one instantiation: D channels, chunk C, EV value
// columns a block, NS stages, SZ bytes an r/k/v element.
constexpr int prep_lanes(int d) { return kThreads / d; }  // lanes a channel
constexpr int pitch_f32(int d) {     // [t][d] f32 rows: prep hits 32 banks
  return d + (prep_lanes(d) == 4 ? 8 : 4);
}
constexpr int pitch_in(int d, int sz) {
  return sz == 4 ? pitch_f32(d) : d + 8;
}
constexpr int k_split(int c, int ev) {   // groups a y tile's sum splits over
  return (c / 4) * (ev / 4) >= kThreads ? 1 : kThreads / ((c / 4) * (ev / 4));
}
constexpr size_t stage_bytes(int d, int c, int ev, int ns, int sz) {
  return 2 * (size_t)c * pitch_in(d, sz) * sz +           // r, k
         (ns == 2 ? (size_t)c * pitch_f32(d) * 4 : 0) +    // w
         (size_t)c * ev * sz;                              // v
}
constexpr size_t smem_floats(int d, int c, int ev) {
  return (size_t)(c + 1) * pitch_f32(d)   // L, after a zero row: L_{t-1}
         + (size_t)c * pitch_f32(d)       // k e^{L_C - L_t}
         + (size_t)(c + d) * (c + 4)      // A^T (causal scores), then r~^T
         + (size_t)(c + d) * ev           // v, then the state S
         + (k_split(c, ev) > 1 ? (size_t)k_split(c, ev) * c * ev : 0)
         + 2 * (size_t)d;                 // u, e^{L_C}
}
constexpr size_t smem_bytes(int d, int c, int ev, int ns, int sz) {
  return ns * stage_bytes(d, c, ev, ns, sz) + 4 * smem_floats(d, c, ev);
}
// the widest value split that fits, then two stages if they fit too
constexpr int choose_ev(int d, int c, int sz) {
  int ev = d;
  while (ev > 8 && smem_bytes(d, c, ev, 1, sz) > kSmemLimit) ev /= 2;
  return ev;
}
constexpr int choose_ns(int d, int c, int sz) {
  return smem_bytes(d, c, choose_ev(d, c, sz), 2, sz) <= kSmemLimit ? 2 : 1;
}

template <int D, int C, int EV, int NS, int SZ>
struct Layout {
  static constexpr int G = prep_lanes(D);
  static constexpr int SEG = C / G;             // tokens a prep lane owns
  static constexpr int PF = pitch_f32(D);
  static constexpr int PT = pitch_in(D, SZ);    // staged r, k row pitch
  static constexpr int CP = C + 4;              // [A | r~] transposed rows
  static constexpr int TE = EV / 4;             // 4-wide value tiles
  static constexpr int NTILE = (C / 4) * TE;    // 4 x 4 tiles of y
  static constexpr int KS = k_split(C, EV);
  static constexpr int KLEN = (C + D) / KS;     // rows of [A|r~] a group sums
  static constexpr size_t RK = (size_t)C * PT * SZ;
  static constexpr size_t W = NS == 2 ? (size_t)C * PF * 4 : 0;
  static constexpr size_t STAGE = stage_bytes(D, C, EV, NS, SZ);
  static constexpr size_t BYTES = smem_bytes(D, C, EV, NS, SZ);
  // blocks an SM holds by shared memory (1 KB reserved each): two, and so
  // 128 registers a thread, where they fit; else one, and up to 255
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= 233472 ? 2 : 1;
  static_assert(kThreads % D == 0 && C % G == 0 && (C + D) % KS == 0 &&
                NTILE * KS >= kThreads, "tiling does not divide");
  static_assert(STAGE % 16 == 0 && (EV * SZ) % 16 == 0 &&
                BYTES <= kSmemLimit, "no layout fits");
};

__device__ __forceinline__ float ex2(float x) {   // 2^x, x <= 0
  float out;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(x));
  return out;
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// four consecutive elements from shared memory, widened to f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

template <int D, int C, int EV, int NS, typename T>
__global__ void __launch_bounds__(
    kThreads, (Layout<D, C, EV, NS, (int)sizeof(T)>::MIN_BLOCKS))
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ sfin, int seq, int h,
             int vec) {
  using L = Layout<D, C, EV, NS, (int)sizeof(T)>;
  constexpr int G = L::G, PF = L::PF, PT = L::PT, CP = L::CP;
  constexpr int TE = L::TE, NTILE = L::NTILE, KS = L::KS, KLEN = L::KLEN;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sLz = reinterpret_cast<float*>(smem + NS * L::STAGE);
  float* const sKt = sLz + (C + 1) * PF;
  float* const sX = sKt + C * PF;
  float* const sVS = sX + (C + D) * CP;
  float* const sYp = sVS + (C + D) * EV;
  float* const sU = sYp + (KS > 1 ? KS * C * EV : 0);
  float* const sDec = sU + D;
  auto stage_r = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::STAGE);
  };
  auto stage_k = [&](int s) { return stage_r(s) + C * PT; };
  auto stage_w = [&](int s) {   // one stage: w lands in the rows of L
    return NS == 2 ? reinterpret_cast<float*>(smem + s * L::STAGE + 2 * L::RK)
                   : sLz + PF;
  };
  auto stage_v = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::STAGE + 2 * L::RK + L::W);
  };

  const int tid = threadIdx.x;
  const int e0 = blockIdx.y * EV;
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const size_t pos = (size_t)h * D;  // stride of one token
  const size_t base = (size_t)b * seq * pos + (size_t)head * D;
  const size_t sbase = (size_t)bh * D * D + e0;
  const int nch = seq / C;

  // stage chunk n's r, k, w and v into stage s
  auto stage_chunk = [&](int n, int s) {
    const size_t row0 = base + (size_t)n * C * pos;
    T* dr = stage_r(s);
    T* dk = stage_k(s);
    float* dw = stage_w(s);
    T* dv = stage_v(s);
    if (vec) {
      constexpr int E = 16 / sizeof(T);  // elements a 16-byte copy
      for (int i = tid; i < C * (D / E); i += kThreads) {
        const int t = i / (D / E), c = (i % (D / E)) * E;
        cp_async16(dr + t * PT + c, r + row0 + t * pos + c);
        cp_async16(dk + t * PT + c, k + row0 + t * pos + c);
      }
      for (int i = tid; i < C * (D / 4); i += kThreads) {
        const int t = i / (D / 4), c = (i % (D / 4)) * 4;
        cp_async16(dw + t * PF + c, w + row0 + t * pos + c);
      }
      for (int i = tid; i < C * (EV / E); i += kThreads) {
        const int t = i / (EV / E), c = (i % (EV / E)) * E;
        cp_async16(dv + t * EV + c, v + row0 + t * pos + e0 + c);
      }
    } else {
      for (int i = tid; i < C * D; i += kThreads) {
        const int t = i / D, c = i % D;
        const size_t off = row0 + t * pos + c;
        dr[t * PT + c] = r[off];
        dk[t * PT + c] = k[off];
        dw[t * PF + c] = w[off];
      }
      for (int i = tid; i < C * EV; i += kThreads) {
        const int t = i / EV, c = i % EV;
        dv[t * EV + c] = v[row0 + t * pos + e0 + c];
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < D; i += kThreads) sU[i] = u[(size_t)head * D + i];
  for (int i = tid; i < PF; i += kThreads) sLz[i] = 0.f;
  for (int i = tid; i < C * CP; i += kThreads) sX[i] = 0.f;  // A^T above t
  for (int i = tid; i < D * EV; i += kThreads) {
    const int d = i / EV, e = i % EV;
    sVS[(C + d) * EV + e] =
        s0 != nullptr ? s0[sbase + (size_t)d * D + e] : 0.f;
  }
  if (nch > 0) stage_chunk(0, 0);

  for (int n = 0; n < nch; ++n) {
    const int cur = NS == 2 ? (n & 1) : 0;
    cp_async_wait_all();
    __syncthreads();   // 1: chunk n staged; chunk n-1 done with S and y
    if (NS == 2 && n + 1 < nch) stage_chunk(n + 1, cur ^ 1);
    const T* stR = stage_r(cur);
    const T* stK = stage_k(cur);

    // -- 1. prep: L by a scan across the G lanes of a channel, row by row
    {
      const int g = tid % G, d = tid / G;
      const float* stW = stage_w(cur);
      float carry = 0.f;             // L of the token before this row
#pragma unroll 4
      for (int j = 0; j < L::SEG; ++j) {
        const int t = j * G + g;
        // with one stage, w sits in the row of L it becomes: read and
        // overwrite it through one pointer
        float* const lrow = sLz + (t + 1) * PF + d;
        float x = log2f(fmaxf(NS == 2 ? stW[t * PF + d] : *lrow, 1e-38f));
#pragma unroll
        for (int off = 1; off < G; off *= 2) {
          const float o = __shfl_up_sync(kAll, x, off, G);
          if (g >= off) x += o;
        }
        const float el = carry + x;                    // L_t
        float prev = __shfl_up_sync(kAll, el, 1, G);   // L_{t-1}
        if (g == 0) prev = carry;
        *lrow = el;
        sX[(C + d) * CP + t] = ld1(stR + t * PT + d) * exp2f(prev);
        carry = __shfl_sync(kAll, el, G - 1, G);
      }
      if (g == 0) sDec[d] = exp2f(carry);
#pragma unroll 4
      for (int j = 0; j < L::SEG; ++j) {
        const int t = j * G + g;
        sKt[t * PF + d] =
            ld1(stK + t * PT + d) * exp2f(carry - sLz[(t + 1) * PF + d]);
      }
      const T* stV = stage_v(cur);
      for (int i = tid; i < C * EV; i += kThreads) sVS[i] = ld1(stV + i);
    }
    __syncthreads();   // 2

    // -- 2. scores into A^T: 4 lanes a causal pair, 2 a bonus -------------
    {
      constexpr int NPAIR = C * (C - 1) / 2;
      static_assert((4 * NPAIR) % 32 == 0 && (2 * C * C) % kThreads == 0,
                    "score tasks split a warp");
      for (int task = tid; task < 2 * C * C; task += kThreads) {
        if (task < 4 * NPAIR) {
          const int p = task >> 2, s = task & 3;
          int t = (int)((1.f + sqrtf(8.f * p + 1.f)) * 0.5f);
          if (t * (t - 1) / 2 > p) --t;
          else if ((t + 1) * t / 2 <= p) ++t;
          const int i = p - t * (t - 1) / 2;
          const float* lp = sLz + t * PF;          // L_{t-1}
          const float* li = sLz + (i + 1) * PF;    // L_i
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            const int c = 16 * j + 4 * s;
            const float4 rr = ld4(stR + t * PT + c);
            const float4 kk = ld4(stK + i * PT + c);
            const float4 a = ld4(lp + c), bb = ld4(li + c);
            acc = fmaf(rr.x * kk.x, ex2(a.x - bb.x), acc);
            acc = fmaf(rr.y * kk.y, ex2(a.y - bb.y), acc);
            acc = fmaf(rr.z * kk.z, ex2(a.z - bb.z), acc);
            acc = fmaf(rr.w * kk.w, ex2(a.w - bb.w), acc);
          }
          acc += __shfl_xor_sync(kAll, acc, 1);
          acc += __shfl_xor_sync(kAll, acc, 2);
          if (s == 0) sX[i * CP + t] = acc;
        } else {
          const int q = task - 4 * NPAIR, t = q >> 1, half = q & 1;
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int c = 8 * j + 4 * half;
            const float4 rr = ld4(stR + t * PT + c);
            const float4 kk = ld4(stK + t * PT + c);
            const float4 uu = ld4(sU + c);
            acc = fmaf(rr.x * uu.x, kk.x, acc);
            acc = fmaf(rr.y * uu.y, kk.y, acc);
            acc = fmaf(rr.z * uu.z, kk.z, acc);
            acc = fmaf(rr.w * uu.w, kk.w, acc);
          }
          acc += __shfl_xor_sync(kAll, acc, 1);
          if (half == 0) sX[t * CP + t] = acc;
        }
      }
    }
    __syncthreads();   // 3: the stage is free again
    if (NS == 1 && n + 1 < nch) stage_chunk(n + 1, 0);

    // -- 3. y = [A | r~] @ [v ; S], 4 x 4 a thread, K split KS ways ------
    const size_t ybase = base + (size_t)n * C * pos + e0;
    for (int tile = tid % NTILE; tile < NTILE; tile += kThreads) {
      const int kp = KS > 1 ? tid / NTILE : 0;
      const int et = tile % TE, tt = tile / TE;
      const float* xa = sX + kp * KLEN * CP + 4 * tt;
      const float* xb = sVS + kp * KLEN * EV + 4 * et;
      float acc[4][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < KLEN; ++kk)
        fma4x4(acc, ld4(xa + kk * CP), ld4(xb + kk * EV));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                     acc[i][3]);
        if (KS > 1)
          *reinterpret_cast<float4*>(
              sYp + (kp * C + 4 * tt + i) * EV + 4 * et) = o;
        else
          *reinterpret_cast<float4*>(
              y + ybase + (4 * tt + i) * pos + 4 * et) = o;
      }
    }
    __syncthreads();   // 4: every read of S is done

    // -- 4. y from the partial sums; S <- e^{L_C} S + (k~)^T v ------------
    if (KS > 1) {
      for (int q = tid; q < C * TE; q += kThreads) {
        const int t = q / TE, c = (q % TE) * 4;
        float4 o = ld4(sYp + t * EV + c);
#pragma unroll
        for (int kp = 1; kp < KS; ++kp) {
          const float4 p = ld4(sYp + (kp * C + t) * EV + c);
          o.x += p.x; o.y += p.y; o.z += p.z; o.w += p.w;
        }
        *reinterpret_cast<float4*>(y + ybase + t * pos + c) = o;
      }
    }
    for (int tile = tid; tile < (D / 4) * TE; tile += kThreads) {
      const int et = tile % TE, dt = tile / TE;
      float* st = sVS + (C + 4 * dt) * EV + 4 * et;
      const float4 dec = ld4(sDec + 4 * dt);
      const float dv[4] = {dec.x, dec.y, dec.z, dec.w};
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 s4 = ld4(st + i * EV);
        acc[i][0] = dv[i] * s4.x; acc[i][1] = dv[i] * s4.y;
        acc[i][2] = dv[i] * s4.z; acc[i][3] = dv[i] * s4.w;
      }
#pragma unroll 4
      for (int t = 0; t < C; ++t)
        fma4x4(acc, ld4(sKt + t * PF + 4 * dt), ld4(sVS + t * EV + 4 * et));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(st + i * EV) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();

  for (int i = tid; i < D * EV; i += kThreads) {
    const int d = i / EV, e = i % EV;
    sfin[sbase + (size_t)d * D + e] = sVS[(C + d) * EV + e];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int D, int C, typename T>
int run(const void* r, const void* k, const void* v, const float* w,
        const float* u, const float* s0, float* y, float* sfin, int b,
        int seq, int h, void* stream) {
  constexpr int EV = choose_ev(D, C, sizeof(T));
  constexpr int NS = choose_ns(D, C, sizeof(T));
  constexpr size_t bytes = Layout<D, C, EV, NS, (int)sizeof(T)>::BYTES;
  auto kernel = rwkv6_kernel<D, C, EV, NS, T>;
  // opt in once per instantiation and device (and so never while a CUDA
  // graph captures a launch)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const int vec = aligned16(r) && aligned16(k) && aligned16(v) &&
                  aligned16(w);
  const dim3 grid(b * h, D / EV);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, sfin, seq, h, vec);
  return cudaGetLastError();
}

template <int D, typename T>
int by_chunk(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* sfin, int b,
             int seq, int h, int c, void* stream) {
  switch (c) {
    case 16:
      return run<D, 16, T>(r, k, v, w, u, s0, y, sfin, b, seq, h, stream);
    case 32:
      return run<D, 32, T>(r, k, v, w, u, s0, y, sfin, b, seq, h, stream);
    case 64:
      return run<D, 64, T>(r, k, v, w, u, s0, y, sfin, b, seq, h, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sfin, int b,
             int seq, int h, int d, int c, void* stream) {
  if (seq % c != 0) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(sfin);
  switch (d) {
    case 16:
      return by_chunk<16, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c,
                             stream);
    case 32:
      return by_chunk<32, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c,
                             stream);
    case 64:
      return by_chunk<64, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c,
                             stream);
    case 128:
      return by_chunk<128, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v (B, S, H, D) in one dtype, w (B, S, H, D) f32, u (H, D) f32, s0
// (B, H, D, D) f32 or null (zeros); y (B, S, H, D) f32, sfin (B, H, D, D)
// f32; all contiguous. S % chunk == 0, chunk 16, 32 or 64. Returns
// cudaGetLastError().
extern "C" int repro_rwkv6_scan_f32(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* s0, void* y,
                                    void* sfin, int b, int seq, int h, int d,
                                    int chunk, void* stream) {
  return dispatch<float>(r, k, v, w, u, s0, y, sfin, b, seq, h, d, chunk,
                         stream);
}

extern "C" int repro_rwkv6_scan_bf16(const void* r, const void* k,
                                     const void* v, const void* w,
                                     const void* u, const void* s0, void* y,
                                     void* sfin, int b, int seq, int h, int d,
                                     int chunk, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, sfin, b, seq, h, d,
                                 chunk, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
