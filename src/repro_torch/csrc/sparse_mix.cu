// Hand-written Hopper kernels for the top-D sparse consensus exchange on the
// flat (K, P) parameter buffer.
//
//   B5 sparse_mix:  OUT_k = M_k + gamma   * (sum_d val[k,d] W[idx[k,d]] - rowsum_k W_k)
//   B6 cluster_mix: OUT_k = M_k + gamma_k * (sum_d val[k,d] W[idx[k,d]] - rowsum_k WSELF_k)
//
// Replaces src/repro/kernels/sparse_mix.py::sparse_mix and
// src/repro/kernels/cluster_mix.py::cluster_mix (the Pallas TPU kernels).
// The TPU versions run a (P/block, K, D) grid: the D neighbor indices ride
// the scalar-prefetch channel so each grid step's index map DMAs one
// gathered wire row, and the output block stays in VMEM across the D steps.
// Here:
//
// * What bounds it on the H100: bytes. Per element the kernel reads the f32
//   master, the self payload and D gathered wire rows, and writes the f32
//   output; there are 2*D+3 flops. Read once, the inputs are 10 B/element
//   at a bf16 wire (master 4 + wire 2 + out 4); gathering every row from HBM
//   would be 4 + 2 + 2*D + 4 B/element (26 at D=8).
// * The walk (B5, and B6 without a plan). Block (k, c) owns node k and a run
//   of 128*V columns. It loads its own D indices and weights into shared
//   memory first (this replaces the TPU's scalar prefetch); each thread then
//   walks the D gathered rows with one 16-byte load per row (V = 4 f32 or 8
//   bf16 values) and keeps V f32 accumulators. Node k is the fast grid
//   index, so at any moment the resident blocks of all K nodes work on the
//   same column run: a gathered row is fetched from HBM by its first reader
//   and served from the 50 MB L2 to the other nodes that list it (K*128*V*2
//   B = 1 MB of bf16 wire per run at K=1024). Every slot is a load through
//   L1/L2: at D=21 that is 21 gathered rows a receiver, 84 B/element at f32.
// * The staged walk (B6 with a plan). The intra tier is block-diagonal:
//   every member of a cluster gathers from the same few rows (at K=1024 on
//   the Manhattan fleet, 26 distinct rows for 11.5 members of 21 slots).
//   A plan built on the host from the indices alone groups the receivers
//   and lists each group's distinct rows (pads and each member's own row
//   included) and each slot's place among them. Block (g, c) owns group g
//   and two column tiles of 64 16-byte vectors: it copies the group's rows
//   of a tile into shared memory with cp.async (1 KB a row), then each
//   warp mixes one member at a time out of them, a lane two vectors, its
//   slots read as (row offset, weight) pairs from shared memory. A row thus
//   leaves L2 once a group and tile instead of once a slot (9.2x fewer row
//   reads on the fleet's round-0 table). Each receiver still sums ALL its slots
//   (zero weights too: 0 * NaN poisons the result as in the reference) in
//   slot order with the same fmaf sequence and row sum as the walk, so both
//   walks give the same bits. Where the self payload is the wire (and an
//   f32 master is the wire's buffer) it is read from the member's own
//   staged row, and the output leaves with evict-first stores so that L2
//   keeps the wire rows that other groups still stage. What is left bounds
//   it: the slots' shared-memory reads (84 B an element at f32, about 0.07
//   ms of the SMs' 128 B/clk at K=1024) beside the HBM traffic. Timed side
//   by side on the H100 and slower: two tile buffers (fewer blocks an SM),
//   one vector a lane, 4 and 1 tiles a block, 128 threads a block, two
//   members a warp side by side (registers).
// * Arithmetic. f32 FMAs on the CUDA cores; a bf16 wire is upcast before it
//   is accumulated. Zero-weight slots are gathered and multiplied by zero,
//   as the reference does, so padding slots cost a row read.
// * Index safety. Indices and plans are not checked here: the stacks are
//   checked once on the host where they are built (an out-of-range index
//   reads out of bounds).
// * Ragged P. The 16-byte paths need P % V == 0 and 16-byte aligned rows;
//   otherwise the launch takes the scalar walk (V = 1), plan or not.
//   Columns past P are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ void load(const float* p, float (&x)[1]) {
  x[0] = p[0];
}
__device__ __forceinline__ void load(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[1]) {
  x[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, const float (&x)[1]) {
  p[0] = x[0];
}
__device__ __forceinline__ void store(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
// the same, marked evict-first (st.global.cs): the output is not read
// again here, and L2 keeps the wire rows that other groups still stage
template <int V>
__device__ __forceinline__ void store_streaming(float* p,
                                                const float (&x)[V]) {
  static_assert(V % 4 == 0, "whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    __stcs(reinterpret_cast<float4*>(p + i),
           make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
  }
}

// kNodeGamma: gamma holds K per-node step sizes (B6), else one value (B5).
template <typename WireT, int V, bool kNodeGamma>
__global__ void __launch_bounds__(kThreads)
gather_mix_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                  const float* __restrict__ master,
                  const WireT* __restrict__ wself,
                  const WireT* __restrict__ wire,
                  const float* __restrict__ gamma, float* __restrict__ out,
                  int d, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(s_idx + d);
  const int k = blockIdx.x;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    s_idx[e] = idx[(size_t)k * d + e];
    s_val[e] = val[(size_t)k * d + e];
  }
  __syncthreads();
  const size_t col = ((size_t)blockIdx.y * kThreads + threadIdx.x) * V;
  if (col >= (size_t)p) return;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  float row = 0.f;
#pragma unroll 4
  for (int e = 0; e < d; ++e) {
    const float a = s_val[e];
    row += a;
    float w[V];
    load(wire + (size_t)s_idx[e] * p + col, w);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(a, w[v], acc[v]);
  }
  const float g = kNodeGamma ? gamma[k] : gamma[0];
  const size_t o = (size_t)k * p + col;
  float m[V], ws[V], r[V];
  load(master + o, m);
  load(wself + o, ws);
#pragma unroll
  for (int v = 0; v < V; ++v) r[v] = m[v] + g * (acc[v] - row * ws[v]);
  store(out + o, r);
}

constexpr int kStagedThreads = 256;
constexpr int kStagedWarps = kStagedThreads / 32;
constexpr int kLaneVecs = 2;      // 16-byte vectors a lane mixes
constexpr int kTileVecs = 32 * kLaneVecs;   // vectors of a row in one tile
constexpr int kTilesPerBlock = 2;
constexpr size_t kSmemLimit = 232448;   // 227 KB, the opt-in maximum
constexpr int kMaxDevices = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a member's slots padded to an even count, read two at a time
__host__ __device__ constexpr int slot_pairs(int d) { return (d + 1) / 2; }

// shared memory of the staged walk: the group's rows of one tile, then
// each member's slot pairs (row offset in vectors and weight bits, twice),
// its step size, id and own row's offset, and the rows' ids
__host__ __device__ constexpr size_t staged_smem(int d, int m_cap,
                                                 int s_cap) {
  return (size_t)s_cap * kTileVecs * 16 +
         (size_t)m_cap * slot_pairs(d) * 16 + (size_t)m_cap * 12 +
         (size_t)s_cap * 4;
}

// Block (g, c): group g of the plan (members[g, :counts[g, 0]] gather from
// rows[g, :counts[g, 1]], which also hold each member's own row at
// own[k]; pos[k, e] is slot (k, e)'s place in that list), column tiles
// [c * kTilesPerBlock, ...) of kTileVecs * V columns. Warp w mixes members
// w, w + 8, ... of each tile, a lane kLaneVecs vectors. kSelfStaged: the
// self payload is the wire, read from the member's own staged row;
// kMasterStaged likewise the master (an f32 wire that is the master
// buffer).
template <typename WireT, int V, bool kSelfStaged, bool kMasterStaged>
__global__ void __launch_bounds__(kStagedThreads)
staged_mix_kernel(const float* __restrict__ val, const float* master,
                  const WireT* wself, const WireT* wire,
                  const float* __restrict__ gamma, float* __restrict__ out,
                  const int* __restrict__ members,
                  const int* __restrict__ rows,
                  const int* __restrict__ counts,
                  const int* __restrict__ pos, const int* __restrict__ own,
                  int d, int p, int m_cap, int s_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* stage = reinterpret_cast<uint4*>(smem);
  int4* slot = reinterpret_cast<int4*>(stage + s_cap * kTileVecs);
  const int pairs = slot_pairs(d);
  float* s_gamma = reinterpret_cast<float*>(slot + m_cap * pairs);
  int* s_member = reinterpret_cast<int*>(s_gamma + m_cap);
  int* s_own = s_member + m_cap;
  int* s_rowid = s_own + m_cap;
  const int g = blockIdx.x, tid = threadIdx.x;
  // the group's padded lists are read beside its counts (m_cap and s_cap
  // are at most kStagedThreads)
  const int row_id = tid < s_cap ? rows[(size_t)g * s_cap + tid] : 0;
  const int member_id = tid < m_cap ? members[(size_t)g * m_cap + tid] : 0;
  const int n_mem = counts[2 * g], n_rows = counts[2 * g + 1];
  constexpr int kTileCols = kTileVecs * V;
  const int n_tiles = (p + kTileCols - 1) / kTileCols;
  const int t0 = blockIdx.y * kTilesPerBlock;
  const int t1 = min(t0 + kTilesPerBlock, n_tiles);
  if (n_mem == 0 || t0 >= t1) return;   // uniform across the block
  if (tid < n_rows) s_rowid[tid] = row_id;
  if (tid < n_mem) s_member[tid] = member_id;
  __syncthreads();
  auto stage_tile = [&](int t) {
    const size_t col0 = (size_t)t * kTileCols;
    for (int i = tid; i < n_rows * kTileVecs; i += kStagedThreads) {
      const int r = i / kTileVecs, v = i % kTileVecs;
      const size_t col = col0 + (size_t)v * V;
      if (col < (size_t)p) {
        cp_async16(stage + i, wire + (size_t)s_rowid[r] * p + col);
      }
    }
    cp_async_commit();
  };
  stage_tile(t0);
  int2* slot2 = reinterpret_cast<int2*>(slot);
  for (int i = tid; i < n_mem * 2 * pairs; i += kStagedThreads) {
    const int m = i / (2 * pairs), e = i - m * 2 * pairs;
    const size_t ke = (size_t)s_member[m] * d + e;
    slot2[i] = e < d ? make_int2(pos[ke] * kTileVecs, __float_as_int(val[ke]))
                     : make_int2(0, 0);
  }
  for (int i = tid; i < n_mem; i += kStagedThreads) {
    s_gamma[i] = gamma[s_member[i]];
    s_own[i] = own[s_member[i]] * kTileVecs;
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int t = t0; t < t1; ++t) {
    if (t > t0) stage_tile(t);
    cp_async_wait_all();
    __syncthreads();
    const WireT* src = reinterpret_cast<const WireT*>(stage) + lane * V;
    // lane's vectors h * 32 + lane of the tile
    size_t col[kLaneVecs];
    bool in[kLaneVecs];
#pragma unroll
    for (int h = 0; h < kLaneVecs; ++h) {
      col[h] = (size_t)t * kTileCols + (size_t)(h * 32 + lane) * V;
      in[h] = col[h] < (size_t)p;
    }
    for (int m = warp; m < n_mem; m += kStagedWarps) {
      const size_t o = (size_t)s_member[m] * p;
      float mv[kLaneVecs][V], ws[kLaneVecs][V], acc[kLaneVecs][V];
#pragma unroll
      for (int h = 0; h < kLaneVecs; ++h) {
        if constexpr (!kMasterStaged) {
          if (in[h]) load(master + o + col[h], mv[h]);
        }
        if constexpr (!kSelfStaged) {
          if (in[h]) load(wself + o + col[h], ws[h]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) acc[h][v] = 0.f;
      }
      float row = 0.f;
      const int4* ms = slot + m * pairs;
#pragma unroll 2
      for (int q = 0; q < pairs; ++q) {
        const int4 s = ms[q];
        const float a0 = __int_as_float(s.y);
        row += a0;
#pragma unroll
        for (int h = 0; h < kLaneVecs; ++h) {
          float w[V];
          load(src + (size_t)(s.x + h * 32) * V, w);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[h][v] = fmaf(a0, w[v], acc[h][v]);
        }
        if (2 * q + 1 < d) {
          const float a1 = __int_as_float(s.w);
          row += a1;
#pragma unroll
          for (int h = 0; h < kLaneVecs; ++h) {
            float w[V];
            load(src + (size_t)(s.z + h * 32) * V, w);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[h][v] = fmaf(a1, w[v], acc[h][v]);
            }
          }
        }
      }
      const float g_k = s_gamma[m];
#pragma unroll
      for (int h = 0; h < kLaneVecs; ++h) {
        if (!in[h]) continue;
        const WireT* own_row = src + (size_t)(s_own[m] + h * 32) * V;
        if constexpr (kSelfStaged) load(own_row, ws[h]);
        if constexpr (kMasterStaged) {
          static_assert(sizeof(WireT) == sizeof(float), "an f32 wire only");
          load(own_row, mv[h]);
        }
        float r[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          r[v] = mv[h][v] + g_k * (acc[h][v] - row * ws[h][v]);
        }
        store_streaming(out + o + col[h], r);
      }
    }
    __syncthreads();         // the next tile overwrites the rows
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename WireT, int V, bool kNodeGamma>
int launch_v(const int* idx, const float* val, const float* master,
             const WireT* wself, const WireT* wire, const float* gamma,
             float* out, int k, int d, int p, cudaStream_t s) {
  const int chunks = (p + kThreads * V - 1) / (kThreads * V);
  if (k < 1 || d < 1 || p < 1 || chunks > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(k, chunks);
  const size_t smem = (size_t)d * (sizeof(int) + sizeof(float));
  gather_mix_kernel<WireT, V, kNodeGamma><<<grid, kThreads, smem, s>>>(
      idx, val, master, wself, wire, gamma, out, d, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename WireT, bool kNodeGamma>
int launch(const void* idx, const void* val, const void* master,
           const void* wself, const void* wire, const void* gamma, void* out,
           int k, int d, int p, void* stream) {
  // 16-byte loads: 4 f32 or 8 bf16 values a thread
  constexpr int kVec = 16 / sizeof(WireT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int*>(idx);
  const auto* a = static_cast<const float*>(val);
  const auto* m = static_cast<const float*>(master);
  const auto* ws = static_cast<const WireT*>(wself);
  const auto* w = static_cast<const WireT*>(wire);
  const auto* g = static_cast<const float*>(gamma);
  auto* o = static_cast<float*>(out);
  const bool vec = p % kVec == 0 && aligned16(master) && aligned16(wself) &&
                   aligned16(wire) && aligned16(out);
  if (vec) {
    return launch_v<WireT, kVec, kNodeGamma>(i, a, m, ws, w, g, o, k, d, p, s);
  }
  return launch_v<WireT, 1, kNodeGamma>(i, a, m, ws, w, g, o, k, d, p, s);
}

// opt a kernel into the full dynamic shared memory once per device (and so
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

// B6: the staged walk when a plan is given and the rows take 16-byte
// copies, else the walk
template <typename WireT>
int launch_cluster(const void* idx, const void* val, const void* master,
                   const void* wself, const void* wire, const void* gamma,
                   void* out, const void* members, const void* rows,
                   const void* counts, const void* pos, const void* own,
                   int k, int d, int p, int groups, int m_cap, int s_cap,
                   void* stream) {
  constexpr int kVec = 16 / sizeof(WireT);
  constexpr bool kF32Wire = sizeof(WireT) == sizeof(float);
  const bool vec = p % kVec == 0 && aligned16(master) && aligned16(wself) &&
                   aligned16(wire) && aligned16(out);
  if (members == nullptr || !vec) {
    return launch<WireT, true>(idx, val, master, wself, wire, gamma, out, k,
                               d, p, stream);
  }
  constexpr int kTileCols = kTileVecs * kVec;
  const int tiles = (p + kTileCols - 1) / kTileCols;
  const int chunks = (tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  const size_t smem = staged_smem(d, m_cap, s_cap);
  if (k < 1 || d < 1 || p < 1 || groups < 1 || m_cap < 1 || s_cap < 1 ||
      m_cap > kStagedThreads || s_cap > kStagedThreads ||
      chunks > kMaxGridY || smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the self payload and the master read from the own staged row where
  // they are the wire's buffer
  const bool self_staged = wself == wire;
  const bool master_staged = self_staged && kF32Wire && master == wire;
  auto kernel = self_staged
      ? (master_staged ? staged_mix_kernel<WireT, kVec, true, kF32Wire>
                       : staged_mix_kernel<WireT, kVec, true, false>)
      : staged_mix_kernel<WireT, kVec, false, false>;
  static bool done[3][kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, smem,
                           done[self_staged + master_staged]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(groups, chunks), kStagedThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(val), static_cast<const float*>(master),
      static_cast<const WireT*>(wself), static_cast<const WireT*>(wire),
      static_cast<const float*>(gamma), static_cast<float*>(out),
      static_cast<const int*>(members), static_cast<const int*>(rows),
      static_cast<const int*>(counts), static_cast<const int*>(pos),
      static_cast<const int*>(own), d, p, m_cap, s_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_sparse_mix_f32(const void* idx, const void* val,
                                    const void* master, const void* wire,
                                    const void* gamma, void* out, int k,
                                    int d, int p, void* stream) {
  return launch<float, false>(idx, val, master, wire, wire, gamma, out, k, d,
                              p, stream);
}

extern "C" int repro_sparse_mix_bf16(const void* idx, const void* val,
                                     const void* master, const void* wire,
                                     const void* gamma, void* out, int k,
                                     int d, int p, void* stream) {
  return launch<__nv_bfloat16, false>(idx, val, master, wire, wire, gamma,
                                      out, k, d, p, stream);
}

// members/rows/counts/pos/own: the plan (kernels/cluster_mix.py
// ClusterPlan) of `groups` groups of at most m_cap members and s_cap rows;
// members NULL runs the walk
extern "C" int repro_cluster_mix_f32(const void* idx, const void* val,
                                     const void* master, const void* wself,
                                     const void* wire, const void* gamma,
                                     void* out, const void* members,
                                     const void* rows, const void* counts,
                                     const void* pos, const void* own, int k,
                                     int d, int p, int groups, int m_cap,
                                     int s_cap, void* stream) {
  return launch_cluster<float>(idx, val, master, wself, wire, gamma, out,
                               members, rows, counts, pos, own, k, d, p,
                               groups, m_cap, s_cap, stream);
}

extern "C" int repro_cluster_mix_bf16(const void* idx, const void* val,
                                      const void* master, const void* wself,
                                      const void* wire, const void* gamma,
                                      void* out, const void* members,
                                      const void* rows, const void* counts,
                                      const void* pos, const void* own, int k,
                                      int d, int p, int groups, int m_cap,
                                      int s_cap, void* stream) {
  return launch_cluster<__nv_bfloat16>(idx, val, master, wself, wire, gamma,
                                       out, members, rows, counts, pos, own,
                                       k, d, p, groups, m_cap, s_cap, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
