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
//
// * What bounds it on the H100. Causal prefill of qwen3-1.7b (B=4, S=2048,
//   H=16, D=128) does 4*B*H*D*S*(S+1)/2 = 69 GFLOP on 50 MB of q, k, v and
//   out: far above the ridge, so the operations bound it. This first
//   version does them as f32 FMAs on the CUDA cores (67 TFLOP/s), not on
//   the tensor cores: the scores, probabilities and accumulator stay in
//   f32 as in the TPU kernel, so a bf16 output differs from an f32
//   computation by its own rounding only. wgmma and TMA are later work.
// * Tiling. A block of 256 threads owns 64 query rows of one (batch, head)
//   and walks the key blocks of 64 in order: the loop inside the block
//   takes the place of the TPU's sequential grid axis. Thread (ty, tx),
//   ty, tx in [0, 16), owns query rows ty + 16i (i < 4), score columns
//   tx + 16j (j < 4) and output columns tx + 16c (c < D/16), so its running
//   max and denominator sit in registers and a row's reductions are four
//   shuffles within a half-warp. q (scaled in f32 as it is loaded) and k
//   are staged transposed, as [D][64 + 1] f32, so both operands of a score
//   FMA come from conflict-free shared-memory rows; the probabilities go
//   through shared memory ([64][80]) to meet the [64][D] v tile, which
//   reuses k's buffer. Inputs are read from (B, S, H, D) in place: the
//   kv head of query head h is h / G, and nothing is transposed or
//   repeated in device memory. At D=128 a block takes 85 KB of dynamic
//   shared memory (opted in), so two blocks share an SM.
// * Masks. Key blocks wholly outside the causal and window range are
//   skipped; inside a block, dead keys get -inf, and the exponentials are
//   taken against max(m, finite) so that no NaN arises. Sq and Sk may be
//   any size: the ragged edge is masked. A query row with no live key at
//   all gets the uniform average of v over all Sk keys, as the TPU kernel
//   and the reference attend (src/repro/models/attention.py) give it: the
//   TPU kernel's -1e30 scores make every p exactly 1 until a live key
//   arrives. Causal prefill always has the diagonal key, so no caller of
//   the model path reaches that branch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per block step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTPad = 1;       // row pad of the transposed q and k tiles
constexpr int kPStride = kBK + 16;  // probabilities row stride (no conflicts)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  // q^T [D][kBQ+1], k^T [D][kBK+1] (v [kBK][D] reuses it), p [kBQ][kPStride]
  return (size_t)D * (kBQ + kTPad) +
         ((size_t)D * (kBK + kTPad) > (size_t)kBK * D
              ? (size_t)D * (kBK + kTPad) : (size_t)kBK * D) +
         (size_t)kBQ * kPStride;
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int h, int kvh, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                                  // [D][kBQ + kTPad]
  float* s_kv = s_q + D * (kBQ + kTPad);              // k^T, then v
  float* s_p = smem + smem_floats<D>() - kBQ * kPStride;  // [kBQ][kPStride]
  constexpr int kDC = D / 16;                         // output cols a thread

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;    // longest rows first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const size_t q_pos = (size_t)h * D;                 // stride of a position
  const size_t kv_pos = (size_t)kvh * D;
  const T* qb = q + (size_t)b * sq * q_pos + (size_t)head * D;
  const T* kb = k + (size_t)b * sk * kv_pos + (size_t)kv_head * D;
  const T* vb = v + (size_t)b * sk * kv_pos + (size_t)kv_head * D;
  T* ob = out + (size_t)b * sq * q_pos + (size_t)head * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, qp = q0 + r;
    s_q[d * (kBQ + kTPad) + r] =
        qp < sq ? to_f32(qb[(size_t)qp * q_pos + d]) * scale : 0.f;
  }

  float acc[4][kDC], m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // keys that can be live for some row of this block
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();   // q staged (first pass); v and p consumed (later)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D, kp = k0 + c;
      s_kv[d * (kBK + kTPad) + c] =
          kp < sk ? to_f32(kb[(size_t)kp * kv_pos + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[d * (kBQ + kTPad) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = s_kv[d * (kBK + kTPad) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool live = kp < sk && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
        if (!live) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_i[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        s_p[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
      l_i[i] = l_i[i] * alpha + row_sum16(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // k consumed, p complete

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D, kp = k0 + c;
      s_kv[c * D + d] = kp < sk ? to_f32(vb[(size_t)kp * kv_pos + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[kDC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_p[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int cc = 0; cc < kDC; ++cc) vv[cc] = s_kv[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < kDC; ++cc)
          acc[i][cc] = fmaf(p[i], vv[cc], acc[i][cc]);
    }
  }

  // rows with no live key at all: the uniform average of v over all keys
  bool dead[4];
  bool any_dead = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    const int lo = window > 0 ? max(0, qp - window + 1) : 0;
    const int hi = causal ? min(qp, sk - 1) : sk - 1;
    dead[i] = qp < sq && lo > hi;
    any_dead |= dead[i];
  }
  if (__syncthreads_or(any_dead)) {
    for (int k0 = 0; k0 < sk; k0 += kBK) {
      __syncthreads();
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int c = e / D, d = e % D, kp = k0 + c;
        s_kv[c * D + d] = kp < sk ? to_f32(vb[(size_t)kp * kv_pos + d]) : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < kBK; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < kDC; ++cc)
            if (dead[i]) acc[i][cc] += s_kv[c * D + tx + 16 * cc];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (dead[i]) l_i[i] = (float)sk;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < kDC; ++cc)
      store(&ob[(size_t)qp * q_pos + tx + 16 * cc], acc[i][cc] / denom);
  }
}

template <int D, typename T>
int run(const void* q, const void* k, const void* v, void* out, int b, int sq,
        int sk, int h, int kvh, int causal, int window, float scale,
        void* stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  // opt in to more than 48 KB once per instantiation and device (and so
  // never while a CUDA graph captures a later launch)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_kernel<D, T><<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, h, kvh, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int sq, int sk, int h, int kvh, int d, int causal, int window,
             float scale, void* stream) {
  switch (d) {
    case 32:
      return run<32, T>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                        scale, stream);
    case 64:
      return run<64, T>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                        scale, stream);
    case 128:
      return run<128, T>(q, k, v, out, b, sq, sk, h, kvh, causal, window,
                         scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, KV, D), out (B, Sq, H, D), all contiguous
// in one dtype; window <= 0 means no window. Returns cudaGetLastError().
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int sq, int sk, int h, int kvh,
                                         int d, int causal, int window,
                                         float scale, void* stream) {
  return dispatch<float>(q, k, v, out, b, sq, sk, h, kvh, d, causal, window,
                         scale, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out, int b,
                                          int sq, int sk, int h, int kvh,
                                          int d, int causal, int window,
                                          float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, b, sq, sk, h, kvh, d, causal,
                                 window, scale, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
