// Hand-written Hopper kernels for the eq. 5 consensus exchange.
//
//   B1 flat_mix:       OUT = M + gamma * (ETA @ W - rowsum(ETA) * W)
//   B2 flat_consensus: OUT = A @ BUF
//   B8 consensus_mix:  OUT = W + gamma * sum_i eta_i (NB_i - W)
//
// B1/B2 work on the flat (K, P) parameter buffer and replace
// src/repro/kernels/consensus_mix.py::flat_mix (body _flat_mix_kernel,
// pallas_call at :77) and ::flat_consensus (body _flat_kernel, :109). The
// TPU versions hold the whole (K, K) operator in VMEM and run one MXU
// matmul per (K, block_cols) slab. B8, one node mixing N neighbor copies of
// its own tensor, is described at its kernel below. Here:
//
// * What bounds B1/B2 on the H100. At the paper's K=4, P=23,936 a call
//   moves about 1.15 MB (master, wire, out): under a microsecond of HBM
//   time, so it is launch-bound. At a fleet of K=256 it is 2*K*K*P = 3.1
//   GFLOP of f32 FMA against about 74 MB of traffic: 47 us at the CUDA
//   cores' 67 TFLOP/s against 22 us at 3.35 TB/s. The FMA rate bounds it:
//   every instruction that is not an FMA takes a cycle an FMA could use.
// * No tensor cores. TF32 keeps about three decimal digits and would break
//   the f32 delta form (src/repro/core/flatten.py, mix_flat), whose point is
//   to keep the cancellation at the f32 noise floor. bf16 is only a wire
//   format: each value reaches its FMA as the exact f32 of its bf16.
// * Two kernels, cut over at K = kTiledMinK = 25, where the tiled one was
//   timed faster on the card for B1 (f32 and bf16 wire) and B2 (PERF.md §6).
//   - K <= 24 (the paper's ring, the platoons; launch-bound): small_body.
//     A block owns TR = 4..32 rows by 128 columns, one column a thread with
//     TR accumulators. The (TR, 32) eta chunk is staged in shared memory and
//     read as a broadcast; the wire element comes straight from global
//     memory. One shared load feeds one FMA.
//   - K >= 25: tiled_body, register-tiled. A block of 2*BM threads owns BM x
//     128 outputs, each thread an 8 x 8 micro-tile of f32 accumulators. The
//     node index is walked in stages of 16 through two shared-memory
//     buffers: eta transposed (16 x BM) and the wire as it travels (16 x
//     128, f32 or bf16). Per node a thread reads its 8 rows of eta and its 8
//     columns of the wire with four 16- or 8-byte loads that feed 64 FMAs; a
//     warp covers 8 x 4 threads, so its wire reads of one node are 128 (f32)
//     or 64 (bf16) contiguous bytes. At 128 registers a thread an SM holds
//     512 threads. Stage s+1 is copied by cp.async while stage s is
//     multiplied: 4-byte copies for eta, which transpose it and land in 32
//     distinct banks a warp, and 16-byte copies for the wire where P and the
//     pointers allow, else 4-byte copies (f32) or plain 2-byte ones (bf16).
//     A bf16 value is widened when it is read from shared memory (a shift or
//     a mask); staging it as f32 through registers was timed slower at K=256.
//     BM is 64, and 128 for an f32 wire from K = 193 on, as timed. With a
//     bf16 wire, four stages before the end each row's master and wire tiles
//     are prefetched into L2 for the epilogue (timed faster from K = 65 on,
//     and slower for an f32 wire).
// * Sum order. Both kernels keep each output as one fmaf chain over the node
//   index in ascending order (no split-K), and sum each row of eta in
//   32-term partials, so the tiled kernel gives the numbers the small kernel
//   gives at the same K.
// * A variant axis (the counterpart of the Pallas kernels under jax.vmap in
//   the reference's batched sweeps, src/repro/core/cdfl.py:917-931):
//   blockIdx.z is the variant v of V. master, wire and out move by K*P a
//   variant, gamma by 1, and eta by eta_stride: 0 when every variant shares
//   one (K, K) stack (the reference's in_axes=None), K*K when each has its
//   own. A block sees only its variant's pointers, so each variant sums in
//   the order of a V = 1 launch and equals it bit for bit.
// * Any K >= 1 and P >= 1, any 4-byte (f32) or 2-byte (bf16) aligned start.
//   Rows and nodes past K are zero-filled in the stages and columns past P
//   are masked. A P that is not a multiple of the 16-byte vector width, or a
//   pointer that is not 16-byte aligned, takes scalar copies and scalar
//   epilogue accesses in the same kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Variant blockIdx.z's offset into the (V, K, P) buffers.
__device__ __forceinline__ size_t variant_offset(int k, int p) {
  return (size_t)blockIdx.z * k * p;
}

// ---------------------------------------------------------------------------
// B1/B2 at K < kTiledMinK: small_body.
constexpr int kCols = 128;   // threads per block = output columns per block
constexpr int kChunk = 32;   // inner node indices staged per pass

template <int TR, bool kMix, typename WireT>
__device__ __forceinline__ void small_body(
    const float* __restrict__ eta, const float* __restrict__ master,
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

template <int TR, typename WireT>
__global__ void __launch_bounds__(kCols)
flat_mix_kernel(const float* __restrict__ eta, const float* __restrict__ master,
                const WireT* __restrict__ wire,
                const float* __restrict__ gamma, float* __restrict__ out,
                int k, int p, int eta_stride) {
  const size_t o = variant_offset(k, p);
  small_body<TR, true>(eta + (size_t)blockIdx.z * eta_stride, master + o,
                       wire + o, gamma + blockIdx.z, out + o, k, p);
}

template <int TR>
__global__ void __launch_bounds__(kCols)
flat_consensus_kernel(const float* __restrict__ a,
                      const float* __restrict__ buf, float* __restrict__ out,
                      int k, int p, int a_stride) {
  const size_t o = variant_offset(k, p);
  small_body<TR, false, float>(a + (size_t)blockIdx.z * a_stride, nullptr,
                               buf + o, nullptr, out + o, k, p);
}

// ---------------------------------------------------------------------------
// B1/B2 at K >= kTiledMinK: tiled_body.
constexpr int kTiledMinK = 25;     // the smallest K that takes tiled_body
constexpr int kBm128MinK = 193;    // f32 (B1 and B2): the smallest K, BM=128
constexpr int kPrefetchStages = 4; // a bf16 B1's epilogue tiles, stages ahead
constexpr int kBN = 128;           // output columns a block
constexpr int kBK = 16;            // nodes a stage
constexpr int kTM = 8, kTN = 8;    // a thread's rows and columns
constexpr int kPadA = 4;           // eta rows stay 16-byte aligned
constexpr int kRowGroup = kChunk / kBK;   // stages a 32-term row-sum partial

// 16 x BM/8 threads a block; an SM holds 512 threads of them, so ptxas
// keeps a thread within 128 registers
__host__ __device__ constexpr int tiled_threads(int bm) { return 2 * bm; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; a dead copy (live false) zero-fills instead
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(live ? 16 : 0) : "memory");
}
// a bulk prefetch into L2: 16-byte aligned, a multiple of 16 bytes
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four consecutive values as f32 (16-byte aligned f32, 8-byte aligned
// bf16; the high half of an f32 is its bf16)
__device__ __forceinline__ void load4(const float* src, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// A block owns BM rows by kBN columns of OUT; thread (ty, tx) owns rows
// g*BM/2 + ty*4 + [0, 4) and columns g*64 + tx*4 + [0, 4) for g < 2. kVec:
// P is a multiple of the wire's 16-byte run and wire, master and out are
// 16-byte aligned.
template <int BM, bool kMix, typename WireT, bool kVec>
__device__ __forceinline__ void tiled_body(
    const float* __restrict__ eta, const float* __restrict__ master,
    const WireT* __restrict__ wire, const float* __restrict__ gamma,
    float* __restrict__ out, int k, int p) {
  constexpr int kThreads = tiled_threads(BM);
  __shared__ __align__(16) float s_a[2][kBK][BM + kPadA];
  // the wire as it travels, bf16 as its raw bits
  using StageT = std::conditional_t<sizeof(WireT) == 2, unsigned short, float>;
  __shared__ __align__(16) StageT s_b[2][kBK][kBN];
  __shared__ float s_row[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp is 8 columns by 4 rows of threads: its wire reads of one node
  // are 8 runs of 4 contiguous values, its eta reads 4 runs
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int stages = (k + kBK - 1) / kBK;

  // eta[m0 + r, i0 + tx] -> s_a[buf][tx][r] for r = ty + j*BM/8: a warp
  // reads 4 rows of 8 consecutive nodes and writes 32 distinct banks
  constexpr int kEtaRows = BM / kTM;              // rows a pass, j < kTM
  const float* a_src = eta + (size_t)(m0 + ty) * k + tx;
  auto stage_eta = [&](int s, int buf) {
    const int i0 = s * kBK;
    const bool col_live = i0 + tx < k;
    const float* src = a_src + i0;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const bool live = col_live && m0 + ty + j * kEtaRows < k;
      cp_async4(&s_a[buf][tx][ty + j * kEtaRows], live ? src : eta, live);
      src += (size_t)kEtaRows * k;
    }
  };

  // wire[i0 + kk, n0 + col] -> s_b[buf][kk][col] in runs of V values:
  // kRowThreads consecutive threads copy consecutive runs of one node
  constexpr int V = kVec ? 16 / sizeof(WireT) : 1;
  constexpr int kRuns = kBN / V;                   // runs a staged node
  constexpr int kRowThreads = kRuns < kThreads ? kRuns : kThreads;
  constexpr int kNodeStep = kThreads / kRowThreads;   // a thread's nodes apart
  const int w_kk = tid / kRowThreads, w_col = (tid % kRowThreads) * V;
  auto stage_wire = [&](int s, int buf) {
    const int i0 = s * kBK;
#pragma unroll
    for (int c = 0; c < kRuns / kRowThreads; ++c) {
      const int col = w_col + c * kRowThreads * V;
      const bool col_live = n0 + col < p;
      const WireT* src = wire + (size_t)(i0 + w_kk) * p + n0 + col;
#pragma unroll
      for (int it = 0; it < kBK / kNodeStep; ++it) {
        const int kk = w_kk + it * kNodeStep;
        const bool live = col_live && i0 + kk < k;
        if constexpr (kVec) {
          cp_async16(&s_b[buf][kk][col], live ? src : wire, live);
        } else if constexpr (sizeof(WireT) == 4) {
          cp_async4(&s_b[buf][kk][col], live ? src : wire, live);
        } else {
          // 2-byte values: no cp.async that small, a plain copy
          s_b[buf][kk][col] =
              live ? *reinterpret_cast<const StageT*>(src) : StageT{0};
        }
        src += (size_t)kNodeStep * p;
      }
    }
  };

  // B1 with a bf16 wire on whole 16-byte runs and more than
  // kPrefetchStages stages: that many stages before the end, thread tid <
  // BM asks L2 for row tid of the master and wire tiles of the epilogue
  constexpr bool kPrefetch = kMix && kVec && sizeof(WireT) == 2;
  const int prefetch_at = stages > kPrefetchStages ? stages - kPrefetchStages
                                                   : -1;
  auto prefetch_epilogue = [&]() {
    const int gr = m0 + tid;
    if (tid < BM && gr < k) {
      const uint32_t cols = min(kBN, p - n0);
      prefetch_l2(master + (size_t)gr * p + n0, cols * 4);
      prefetch_l2(wire + (size_t)gr * p + n0, cols * 2);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
  float part = 0.f, rsum = 0.f;   // tid < BM: row tid's sum of eta

  stage_eta(0, 0);
  stage_wire(0, 0);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < stages;
    if constexpr (kPrefetch) {
      if (s == prefetch_at) prefetch_epilogue();
    }
    if (more) {
      stage_eta(s + 1, buf ^ 1);
      stage_wire(s + 1, buf ^ 1);
    }
    cp_async_commit();       // one group a stage, empty on the last
    cp_async_wait_prior();   // stage s has landed
    __syncthreads();
    if constexpr (kMix) {
      if (tid < BM) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) part += s_a[buf][kk][tid];
        if ((s + 1) % kRowGroup == 0 || !more) {
          rsum += part;
          part = 0.f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        load4(&s_a[buf][kk][g * (BM / 2) + ty * 4], &a[4 * g]);
        load4(reinterpret_cast<const WireT*>(&s_b[buf][kk][g * 64 + tx * 4]),
              &b[4 * g]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();   // stage s is consumed before its buffer is refilled
  }

  if constexpr (kMix) {
    if (tid < BM) s_row[tid] = rsum;
    __syncthreads();
  }
  const float g = kMix ? *gamma : 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = (i / 4) * (BM / 2) + ty * 4 + (i % 4);
    const int gr = m0 + r;
    if (gr >= k) continue;
    const float rs = kMix ? s_row[r] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = n0 + h * 64 + tx * 4;
      const size_t o = (size_t)gr * p + gc;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j];
      if constexpr (kVec) {
        if (gc < p) {   // P % 4 == 0: the run is whole
          if constexpr (kMix) {
            float ws[4], ms[4];
            load4(wire + o, ws);
            load4(master + o, ms);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v[j] = ms[j] + g * (v[j] - rs * ws[j]);
            }
          }
          *reinterpret_cast<float4*>(out + o) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gc + j < p) {
            float x = v[j];
            if constexpr (kMix) {
              x = master[o + j] + g * (x - rs * to_f32(wire[o + j]));
            }
            out[o + j] = x;
          }
        }
      }
    }
  }
}

template <int BM, typename WireT, bool kVec>
__global__ void __launch_bounds__(tiled_threads(BM), 512 / tiled_threads(BM))
flat_mix_tiled(const float* __restrict__ eta, const float* __restrict__ master,
               const WireT* __restrict__ wire,
               const float* __restrict__ gamma, float* __restrict__ out,
               int k, int p, int eta_stride) {
  const size_t o = variant_offset(k, p);
  tiled_body<BM, true, WireT, kVec>(eta + (size_t)blockIdx.z * eta_stride,
                                    master + o, wire + o, gamma + blockIdx.z,
                                    out + o, k, p);
}

template <int BM, bool kVec>
__global__ void __launch_bounds__(tiled_threads(BM), 512 / tiled_threads(BM))
flat_consensus_tiled(const float* __restrict__ a,
                     const float* __restrict__ buf, float* __restrict__ out,
                     int k, int p, int a_stride) {
  const size_t o = variant_offset(k, p);
  tiled_body<BM, false, float, kVec>(a + (size_t)blockIdx.z * a_stride,
                                     nullptr, buf + o, nullptr, out + o, k,
                                     p);
}

int small_rows(int k) { return k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 32; }

template <typename WireT>
bool vector_ok(const void* master, const WireT* wire, const void* out,
               int p) {
  return p % (16 / sizeof(WireT)) == 0 && aligned16(wire) &&
         aligned16(out) && (master == nullptr || aligned16(master));
}

template <typename WireT>
int launch_mix(const float* eta, const float* master, const WireT* wire,
               const float* gamma, float* out, int k, int p, int v,
               int eta_stride, void* stream) {
  if (v < 1 || v > 65535) return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const float*, const float*, const WireT*, const float*,
                      float*, int, int, int);
  Fn fn;
  int rows, threads;
  if (k < kTiledMinK) {
    rows = small_rows(k);
    threads = kCols;
    fn = rows == 4 ? flat_mix_kernel<4, WireT>
       : rows == 8 ? flat_mix_kernel<8, WireT>
       : rows == 16 ? flat_mix_kernel<16, WireT> : flat_mix_kernel<32, WireT>;
  } else {
    // BM as timed on the card (PERF.md §6): 64 for a bf16 wire at every K,
    // 128 for an f32 wire from kBm128MinK on
    const bool vec = vector_ok(master, wire, out, p);
    rows = 64;
    fn = vec ? flat_mix_tiled<64, WireT, true>
             : flat_mix_tiled<64, WireT, false>;
    if constexpr (sizeof(WireT) == 4) {
      if (k >= kBm128MinK) {
        rows = 128;
        fn = vec ? flat_mix_tiled<128, WireT, true>
                 : flat_mix_tiled<128, WireT, false>;
      }
    }
    threads = tiled_threads(rows);
  }
  const dim3 grid((p + kBN - 1) / kBN, (k + rows - 1) / rows, v);
  fn<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      eta, master, wire, gamma, out, k, p, eta_stride);
  return static_cast<int>(cudaGetLastError());
}

int launch_consensus(const float* a, const float* buf, float* out, int k,
                     int p, int v, int a_stride, void* stream) {
  if (v < 1 || v > 65535) return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const float*, const float*, float*, int, int, int);
  Fn fn;
  int rows, threads;
  if (k < kTiledMinK) {
    rows = small_rows(k);
    threads = kCols;
    fn = rows == 4 ? flat_consensus_kernel<4>
       : rows == 8 ? flat_consensus_kernel<8>
       : rows == 16 ? flat_consensus_kernel<16> : flat_consensus_kernel<32>;
  } else {
    rows = k >= kBm128MinK ? 128 : 64;   // as B1 with an f32 wire
    threads = tiled_threads(rows);
    const bool vec = vector_ok<float>(nullptr, buf, out, p);
    fn = rows == 64 ? (vec ? flat_consensus_tiled<64, true>
                           : flat_consensus_tiled<64, false>)
                    : (vec ? flat_consensus_tiled<128, true>
                           : flat_consensus_tiled<128, false>);
  }
  const dim3 grid((p + kBN - 1) / kBN, (k + rows - 1) / rows, v);
  fn<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a, buf, out, k,
                                                              p, a_stride);
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

// v variants of (K, P) buffers; eta_stride 0 (one shared eta) or K*K
extern "C" int repro_flat_mix_f32(const void* eta, const void* master,
                                  const void* wire, const void* gamma,
                                  void* out, int k, int p, int v,
                                  int eta_stride, void* stream) {
  return launch_mix<float>(
      static_cast<const float*>(eta), static_cast<const float*>(master),
      static_cast<const float*>(wire), static_cast<const float*>(gamma),
      static_cast<float*>(out), k, p, v, eta_stride, stream);
}

extern "C" int repro_flat_mix_bf16(const void* eta, const void* master,
                                   const void* wire, const void* gamma,
                                   void* out, int k, int p, int v,
                                   int eta_stride, void* stream) {
  return launch_mix<__nv_bfloat16>(
      static_cast<const float*>(eta), static_cast<const float*>(master),
      static_cast<const __nv_bfloat16*>(wire),
      static_cast<const float*>(gamma), static_cast<float*>(out), k, p, v,
      eta_stride, stream);
}

// v variants; a_stride 0 (one shared operator) or K*K
extern "C" int repro_flat_consensus(const void* a, const void* buf, void* out,
                                    int k, int p, int v, int a_stride,
                                    void* stream) {
  return launch_consensus(static_cast<const float*>(a),
                          static_cast<const float*>(buf),
                          static_cast<float*>(out), k, p, v, a_stride,
                          stream);
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
