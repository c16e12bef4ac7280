// RMSNorm forward and backward for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces: deepspeed_tpu/ops/pallas/layer_norm.py `rms_norm` (the forward
// pallas_call, kernel body `_rms_fwd_kernel`) and `_rms_norm_bwd_vjp`
// (kernel body `_rms_bwd_kernel`; see rms_norm_bwd_kernel below).
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

// Sum of two values over the block; every thread gets both totals.  Safe to
// call repeatedly (the shared partials are released before returning).
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 partial2[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) partial2[warp] = make_float2(a, b);
  __syncthreads();
  const float2 p = lane < kWarps ? partial2[lane] : make_float2(0.f, 0.f);
  const float2 out = make_float2(warp_sum(p.x), warp_sum(p.y));
  __syncthreads();
  return out;
}

// RMSNorm backward (replaces `_rms_norm_bwd_vjp` / `_rms_bwd_kernel`),
// statistics recomputed from x:
//   rstd = rsqrt(mean(x^2) + eps), xhat = x * rstd, wdy = dy * g,
//   c2 = mean(wdy * xhat), dx = (wdy - xhat * c2) * rstd,
//   dg = sum over rows of dy * xhat.
// The Pallas kernel sums dg across its sequential grid.  Here each block
// takes `rows_per_block` consecutive rows, keeps its dg partial for every
// column in shared memory (each thread always owns the same columns, so no
// two threads touch one entry) and writes it to `part[blockIdx.x]`;
// rms_dg_reduce_kernel then sums the partials in a fixed order.  No float
// atomics: the result does not depend on block scheduling.  Bound by bytes:
// x and dy are read (twice, the second time mostly from L2), dx written.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ part, long long rows, int n,
                    int rows_per_block, float eps) {
  extern __shared__ float sdg[];
  for (int i = threadIdx.x; i < n; i += kThreads) sdg[i] = 0.f;
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * n;
    const T* dyr = dy + r * n;
    T* dxr = dx + r * n;
    float ss = 0.f, sw = 0.f;   // sum x^2, sum wdy * x
    if constexpr (kVec) {
      using P = Pack<T>;
      const P* xv = reinterpret_cast<const P*>(xr);
      const P* dv = reinterpret_cast<const P*>(dyr);
      const P* gv = reinterpret_cast<const P*>(g);
      for (int i = threadIdx.x; i < n / P::N; i += kThreads) {
        const P px = xv[i], pd = dv[i], pg = gv[i];
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          const float f = to_f32(px.v[j]);
          ss += f * f;
          sw += to_f32(pd.v[j]) * to_f32(pg.v[j]) * f;
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float f = to_f32(xr[i]);
        ss += f * f;
        sw += to_f32(dyr[i]) * to_f32(g[i]) * f;
      }
    }
    const float2 tot = block_sum2(ss, sw);
    const float rstd = rsqrtf(tot.x / static_cast<float>(n) + eps);
    const float c2 = tot.y * rstd / static_cast<float>(n);
    if constexpr (kVec) {
      using P = Pack<T>;
      const P* xv = reinterpret_cast<const P*>(xr);
      const P* dv = reinterpret_cast<const P*>(dyr);
      const P* gv = reinterpret_cast<const P*>(g);
      P* ov = reinterpret_cast<P*>(dxr);
      for (int i = threadIdx.x; i < n / P::N; i += kThreads) {
        const P px = xv[i], pd = dv[i], pg = gv[i];
        P out;
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          const float xhat = to_f32(px.v[j]) * rstd;
          const float d = to_f32(pd.v[j]);
          out.v[j] = from_f32<T>((d * to_f32(pg.v[j]) - xhat * c2) * rstd);
          sdg[i * P::N + j] += d * xhat;
        }
        ov[i] = out;
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float xhat = to_f32(xr[i]) * rstd;
        const float d = to_f32(dyr[i]);
        dxr[i] = from_f32<T>((d * to_f32(g[i]) - xhat * c2) * rstd);
        sdg[i] += d * xhat;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    part[static_cast<size_t>(blockIdx.x) * n + i] = sdg[i];
}

// dg[c] = sum over blocks b (in order b = w, w + 8, ... per warp w, then the
// 8 warp sums in order) of part[b][c], cast to T.  32 columns per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_dg_reduce_kernel(const float* __restrict__ part, T* __restrict__ dg, int nblk, int n) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < n)
    for (int b = warp; b < nblk; b += kWarps) acc += part[static_cast<size_t>(b) * n + c];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < n) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[w][lane];
    dg[c] = from_f32<T>(tot);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg,
                       float* part, long long rows, int n, int nblk, float eps,
                       cudaStream_t stream) {
  const int rpb = static_cast<int>((rows + nblk - 1) / nblk);
  const bool vec = n % Pack<T>::N == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (vec)
    rms_norm_bwd_kernel<T, true><<<nblk, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(dy),
        static_cast<T*>(dx), part, rows, n, rpb, eps);
  else
    rms_norm_bwd_kernel<T, false><<<nblk, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(dy),
        static_cast<T*>(dx), part, rows, n, rpb, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_dg_reduce_kernel<T><<<(n + 31) / 32, kThreads, 0, stream>>>(part, static_cast<T*>(dg), nblk, n);
  return cudaGetLastError();
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

// RMSNorm backward: x, dy, dx [rows, n], g and dg [n], one dtype; part is
// float32 scratch [nblk, n] for the per-block dg partials (nblk <= rows;
// n * 4 bytes of shared memory per block, so n <= 12288).  Two launches
// (partials, then their fixed-order sum).  Returns the cudaError_t.
int ds_rms_norm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg, void* part,
                    long long rows, int n, int nblk, float eps, int dtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (nblk <= 0 || nblk > rows || n > 12288) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0: return static_cast<int>(launch_bwd<float>(x, g, dy, dx, dg, p, rows, n, nblk, eps, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(x, g, dy, dx, dg, p, rows, n, nblk, eps, s));
    case 2: return static_cast<int>(launch_bwd<__half>(x, g, dy, dx, dg, p, rows, n, nblk, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
