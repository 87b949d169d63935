// Hand-written Hopper kernels for the eq. 5 consensus exchange on the flat
// (K, P) parameter buffer.
//
//   B1 flat_mix:       OUT = M + gamma * (ETA @ W - rowsum(ETA) * W)
//   B2 flat_consensus: OUT = A @ BUF
//
// Replaces src/repro/kernels/consensus_mix.py::flat_mix and ::flat_consensus
// (the Pallas TPU kernels). The TPU versions hold the whole (K, K) operator
// in VMEM and run one MXU matmul per (K, block_cols) slab. Here:
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

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
