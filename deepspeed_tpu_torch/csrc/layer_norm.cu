// RMSNorm forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/layer_norm.py `rms_norm` (the forward
// pallas_call, kernel body `_rms_fwd_kernel`).
//
//   y = x * rsqrt(mean(x^2, -1) + eps) * g      (statistics in fp32,
//                                                 y in x's dtype)
//
// What bounds it on the H100: memory bytes.  Each row is read once for the
// sum of squares and once more for the scale (the second read hits L1/L2),
// the output is written once; about 3 fp32 operations per byte moved, far
// below the ~20 operations per byte at which the fp32 vector units would
// become the limit.  On the serving path a call is one [rows, 4096] bf16
// tensor with rows <= 64 (prefill chunk) or num_slots (decode): under 1 MB,
// so a launch costs more than the bytes do.
//
// Design: one thread block per row (the Pallas kernel's row block becomes
// the CUDA block; the TPU's lane-axis reduction becomes a warp-shuffle
// reduction followed by one pass over per-warp partials in shared memory).
// Rows are read with 16-byte vector loads when the row length and the
// pointers allow it, else element by element.  Nothing is allocated here:
// the wrapper passes the output buffer and the stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// 16 bytes of T, loaded and stored as one vector.
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < kWarps ? partial[lane] : 0.f;
  return warp_sum(v);  // every warp reduces the same partials
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ y, int n, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * n;
  T* yr = y + static_cast<size_t>(blockIdx.x) * n;
  float ss = 0.f;
  if constexpr (kVec) {
    using P = Pack<T>;
    const int nv = n / P::N;
    const P* xv = reinterpret_cast<const P*>(xr);
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const P p = xv[i];
#pragma unroll
      for (int j = 0; j < P::N; ++j) {
        const float f = to_f32(p.v[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float rstd = rsqrtf(block_sum(ss) / static_cast<float>(n) + eps);
  if constexpr (kVec) {
    using P = Pack<T>;
    const int nv = n / P::N;
    const P* xv = reinterpret_cast<const P*>(xr);
    const P* gv = reinterpret_cast<const P*>(g);
    P* yv = reinterpret_cast<P*>(yr);
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const P px = xv[i];
      const P pg = gv[i];
      P out;
#pragma unroll
      for (int j = 0; j < P::N; ++j)
        out.v[j] = from_f32<T>(to_f32(px.v[j]) * rstd * to_f32(pg.v[j]));
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      yr[i] = from_f32<T>(to_f32(xr[i]) * rstd * to_f32(g[i]));
  }
}

template <typename T>
void launch(const void* x, const void* g, void* y, long long rows, int n,
            float eps, cudaStream_t stream) {
  const bool vec = n % Pack<T>::N == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const dim3 grid(static_cast<unsigned>(rows));
  if (vec)
    rms_norm_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y), n, eps);
  else
    rms_norm_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y), n, eps);
}

}  // namespace

extern "C" {

// x, y: [rows, n] contiguous; g: [n]; all of one dtype
// (0 = float32, 1 = bfloat16, 2 = float16).  Returns the cudaError_t of the
// launch (0 on success).
int ds_rms_norm_fwd(const void* x, const void* g, void* y, long long rows, int n,
                    float eps, int dtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, g, y, rows, n, eps, s); break;
    case 1: launch<__nv_bfloat16>(x, g, y, rows, n, eps, s); break;
    case 2: launch<__half>(x, g, y, rows, n, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
