// Hand-written Hopper kernels for the CND sketch (paper Algorithm 1).
//
//   B3 cnd_bitmaps:  items (K, n, f) int32 -> (K, H, m/32) packed bitmaps
//   B4 cnd_popcount: (rows, W) bitmaps -> (rows,) set-bit counts
//
// Replaces src/repro/kernels/cnd_sketch.py::cnd_bitmaps and ::cnd_popcount
// (the Pallas TPU kernels). The TPU has no scatter unit, so its kernel sets
// bits with a one-hot compare of every item against every bitmap word. The
// H100 has shared-memory atomics, so B3 is the paper's own loop: hash each
// item H times and atomicOr one bit.
//
// * What bounds it on the H100: integer ALU work (H * (f + 1) avalanche
//   mixes per item, each a few multiplies, xors and shifts) and the shared
//   memory atomics. The bytes are small: at K=256, n=320, f=16 the items are
//   5.2 MB and the bitmaps 0.8 MB.
// * Design: one block per node. The node's H * m/32 words (3 KB at H=3,
//   m=8192) live in shared memory; the block's threads stride over the
//   node's items, each atomicOr lands in shared memory, and the block writes
//   its bitmaps out once after a barrier. Every node of the trainer is
//   sketched in one launch. The hash is the exact uint32 arithmetic of
//   src/repro/core/sketch.py::_mix32, so the bits match bit for bit.
// * B4 gives one warp to each bitmap row: __popc per word and a warp
//   shuffle reduction. It is bound by the bitmap bytes and by its launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t kPrimes[5] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                    0x27D4EB2Fu, 0x165667B1u};

// xxhash-style avalanche; the seed is uniform across a warp, so the
// constant-memory read is a broadcast
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed * 0x9E3779B9u + 0x7F4A7C15u;
  x *= kPrimes[seed % 5u];
  x ^= x >> 15;
  x *= 0x85EBCA77u;
  x ^= x >> 13;
  x *= 0xC2B2AE3Du;
  x ^= x >> 16;
  return x;
}

__global__ void cnd_bitmaps_kernel(const int32_t* __restrict__ items,
                                   uint32_t* __restrict__ out, int n, int f,
                                   int h, int m) {
  extern __shared__ uint32_t s_bm[];   // h * (m / 32) words
  const int words = m >> 5;
  const int total = h * words;
  for (int w = threadIdx.x; w < total; w += blockDim.x) s_bm[w] = 0u;
  __syncthreads();
  const int32_t* node = items + (size_t)blockIdx.x * n * f;
  for (int it = threadIdx.x; it < n; it += blockDim.x) {
    const int32_t* row = node + (size_t)it * f;
    for (int s = 0; s < h; ++s) {
      uint32_t hv = 0u;
      for (int j = 0; j < f; ++j) {
        hv = mix32(hv * 31u + static_cast<uint32_t>(row[j]),
                   static_cast<uint32_t>(s + j));
      }
      const uint32_t idx =
          mix32(hv, static_cast<uint32_t>(101 + s)) % static_cast<uint32_t>(m);
      atomicOr(&s_bm[s * words + (idx >> 5)], 1u << (idx & 31u));
    }
  }
  __syncthreads();
  uint32_t* dst = out + (size_t)blockIdx.x * total;
  for (int w = threadIdx.x; w < total; w += blockDim.x) dst[w] = s_bm[w];
}

__global__ void popcount_kernel(const uint32_t* __restrict__ bm,
                                int32_t* __restrict__ out, int rows,
                                int words) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;   // uniform across the warp
  const uint32_t* src = bm + (size_t)warp * words;
  int c = 0;
  for (int w = lane; w < words; w += 32) c += __popc(src[w]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lane == 0) out[warp] = c;
}

}  // namespace

extern "C" int repro_cnd_bitmaps(const void* items, void* out, int k, int n,
                                 int f, int h, int m, void* stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)h * (m / 32);
  cnd_bitmaps_kernel<<<k, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(items), static_cast<uint32_t*>(out), n, f,
      h, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_cnd_popcount(const void* bitmaps, void* out, int rows,
                                  int words, void* stream) {
  const int warps_per_block = 4;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  popcount_kernel<<<blocks, 32 * warps_per_block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmaps), static_cast<int32_t*>(out), rows,
      words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
