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
//   0.040 ms of f32 operations on the CUDA cores, about even. This first version does the f32 arithmetic on the
//   CUDA cores (f32 means f32: no TF32, no tensor cores), exponentials
//   through exp2f on log2-scaled decays.
// * The sequential chunk axis is a loop inside one block, and the state
//   never leaves the chip: a block owns one (batch, head) and a slice of
//   kEV = 16 value columns, and keeps its D x kEV slice of S in shared
//   memory for the whole sequence. Column e of S depends only on v[:, e],
//   so the value dimension splits across D / 16 blocks (1,024 blocks of
//   256 threads at the serving shape, for 132 SMs); each recomputes the
//   chunk's C x C scores, which are shared by its columns.
// * Per chunk: r, k and log2 w of the C tokens (all D channels) and v's
//   kEV columns are staged in shared memory in f32, read in place from
//   (B, S, H, D) (a token's head row is D contiguous values; r/k/v in
//   f32 or bf16, upcast as they are loaded; w and u in f32). D threads
//   take the cumulative sums; one thread per (t, i) pair takes a score;
//   r and k are then scaled in place by their decays; one thread per
//   (t, e) output sums its scores and its state column; one thread per
//   state element applies the update. Rows are padded to D + 1 floats so
//   that the lanes of a warp, which walk different tokens, hit different
//   banks. At D = 64, C = 16 a block takes 23 KB of shared memory; at
//   D = 128, C = 64, 161 KB, opted in once per instantiation and device
//   (never while a CUDA graph captures a later launch).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEV = 16;          // value columns of S a block owns
constexpr int kMaxChunk = 64;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// r, k, L, L_prev [C][D+1]; v [C][kEV]; S [D][kEV]; scores [C][C+1]
__host__ __device__ constexpr size_t smem_floats(int d, int c) {
  return 4 * (size_t)c * (d + 1) + (size_t)c * kEV + (size_t)d * kEV +
         (size_t)c * (c + 1);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ sfin, int seq, int h,
             int c) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  float* s_r = smem;                 // r, then r e^{L_{t-1}}
  float* s_k = s_r + c * DP;         // k, then k e^{L_C - L_t}
  float* s_L = s_k + c * DP;         // log2 w, then L_t (log2 units)
  float* s_Lp = s_L + c * DP;        // L_{t-1}
  float* s_v = s_Lp + c * DP;        // [C][kEV]
  float* s_S = s_v + c * kEV;        // [D][kEV], the state slice
  float* s_sc = s_S + D * kEV;       // [C][C+1], bonus on the diagonal
  const int cp = c + 1;

  const int tid = threadIdx.x;
  const int e0 = blockIdx.y * kEV;
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const size_t pos = (size_t)h * D;  // stride of one token
  const size_t base = (size_t)b * seq * pos + (size_t)head * D;
  const float* ub = u + (size_t)head * D;
  const size_t sbase = (size_t)bh * D * D + e0;

  for (int i = tid; i < D * kEV; i += kThreads) {
    const int d = i / kEV, e = i % kEV;
    s_S[i] = s0 != nullptr ? s0[sbase + (size_t)d * D + e] : 0.f;
  }

  for (int t0 = 0; t0 < seq; t0 += c) {
    for (int i = tid; i < c * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const size_t off = base + (size_t)(t0 + t) * pos + d;
      s_r[t * DP + d] = to_f32(r[off]);
      s_k[t * DP + d] = to_f32(k[off]);
      s_L[t * DP + d] = log2f(fmaxf(w[off], 1e-38f));
    }
    for (int i = tid; i < c * kEV; i += kThreads) {
      const int t = i / kEV, e = i % kEV;
      s_v[i] = to_f32(v[base + (size_t)(t0 + t) * pos + e0 + e]);
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        s_Lp[t * DP + d] = acc;
        acc += s_L[t * DP + d];
        s_L[t * DP + d] = acc;
      }
    }
    __syncthreads();

    // scores[t][i] = sum_d r_td k_id 2^{L_{t-1,d} - L_{i,d}} for i < t
    for (int p = tid; p < c * c; p += kThreads) {
      const int t = p / c, i = p % c;
      float acc = 0.f;
      if (i < t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc = fmaf(s_r[t * DP + d] * s_k[i * DP + d],
                     exp2f(s_Lp[t * DP + d] - s_L[i * DP + d]), acc);
      } else if (i == t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc = fmaf(s_r[t * DP + d] * __ldg(ub + d), s_k[t * DP + d], acc);
      }
      s_sc[t * cp + i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < c * D; i += kThreads) {
      const int t = i / D, d = i % D;
      s_r[t * DP + d] *= exp2f(s_Lp[t * DP + d]);
      s_k[t * DP + d] *= exp2f(s_L[(c - 1) * DP + d] - s_L[t * DP + d]);
    }
    __syncthreads();

    for (int o = tid; o < c * kEV; o += kThreads) {
      const int t = o / kEV, e = o % kEV;
      float acc = 0.f;
      for (int i = 0; i <= t; ++i)
        acc = fmaf(s_sc[t * cp + i], s_v[i * kEV + e], acc);
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        acc = fmaf(s_r[t * DP + d], s_S[d * kEV + e], acc);
      y[base + (size_t)(t0 + t) * pos + e0 + e] = acc;
    }
    __syncthreads();   // every y has read S

    for (int i = tid; i < D * kEV; i += kThreads) {
      const int d = i / kEV, e = i % kEV;
      float acc = exp2f(s_L[(c - 1) * DP + d]) * s_S[i];
      for (int t = 0; t < c; ++t)
        acc = fmaf(s_k[t * DP + d], s_v[t * kEV + e], acc);
      s_S[i] = acc;
    }
    __syncthreads();   // the next chunk overwrites the staged tiles
  }

  for (int i = tid; i < D * kEV; i += kThreads) {
    const int d = i / kEV, e = i % kEV;
    sfin[sbase + (size_t)d * D + e] = s_S[i];
  }
}

template <int D, typename T>
int run(const void* r, const void* k, const void* v, const float* w,
        const float* u, const float* s0, float* y, float* sfin, int b,
        int seq, int h, int c, void* stream) {
  // opt in once per instantiation and device to the largest chunk's
  // shared memory (and so never while a CUDA graph captures a launch)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        rwkv6_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(D, kMaxChunk) * sizeof(float)));
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid(b * h, D / kEV);
  rwkv6_kernel<D, T><<<grid, kThreads, smem_floats(D, c) * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, sfin, seq, h, c);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sfin, int b,
             int seq, int h, int d, int c, void* stream) {
  if (c < 1 || c > kMaxChunk || seq % c != 0) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(sfin);
  switch (d) {
    case 16:
      return run<16, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c, stream);
    case 32:
      return run<32, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c, stream);
    case 64:
      return run<64, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c, stream);
    case 128:
      return run<128, T>(r, k, v, wf, uf, sf, yf, ff, b, seq, h, c, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v (B, S, H, D) in one dtype, w (B, S, H, D) f32, u (H, D) f32, s0
// (B, H, D, D) f32 or null (zeros); y (B, S, H, D) f32, sfin (B, H, D, D)
// f32; all contiguous. S % chunk == 0. Returns cudaGetLastError().
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
