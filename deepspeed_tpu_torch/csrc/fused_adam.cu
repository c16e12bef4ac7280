// Fused Adam / AdamW update for Hopper (sm_90a), with a plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/fused_adam.py `fused_adam_update`
// (kernel `_adam_kernel`).  One pass over a parameter leaf:
//
//   g' = g + wd * p                      (L2 mode, adam_w_mode == 0)
//   m  = beta1 * m + (1 - beta1) * g'
//   v  = beta2 * v + (1 - beta2) * g' * g'
//   u  = (m * c1) / (sqrt(v * c2) + eps) (+ wd * p in AdamW mode)
//   p  = p - lr * u
//
// in fp32 whatever the dtypes of p and g (each fp32, bf16 or fp16; a 16-bit
// p is rounded back to nearest even, as the JAX function's astype); m and v
// are fp32.  lr, c1 =
// 1/(1 - beta1^t) and c2 = 1/(1 - beta2^t) are per-step arguments, never
// compiled in.  p, m and v are updated IN PLACE (the Pallas kernel returns
// new arrays; the port owns its buffers and saves a second copy of the
// optimizer state).
//
// What bounds it on the H100: memory bytes.  Per fp32 parameter with an fp32
// gradient it reads p, g, m, v and writes p, m, v: 28 bytes for ~15 fp32
// operations; llama-1b4's 1.34e9 parameters move 37.5 GB a step, 11.2 ms at
// 3.35 TB/s.  Design: a grid-stride loop over 4-element vectors (16-byte
// loads of every fp32 stream) with a scalar tail; no reduction, no reuse, no
// shared memory.  One launch per parameter leaf, as the JAX package issues
// one pallas_call per leaf.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

struct AdamArgs {
  float lr, c1, c2, beta1, beta2, omb1, omb2, eps, wd;
  int adam_w_mode;
};

// Each operation rounded on its own, in the plain version's order (no FMA
// contraction), so the kernel lands on the plain version's fp32 values.  It
// matters where g' = g + wd * p cancels to ~1e-10: there the eps term makes
// u follow the last bit of g', and a contracted g' moves an fp16 p by ulps.
__device__ __forceinline__ float adam_one(float p, float g, float& m, float& v, const AdamArgs& a) {
  if (!a.adam_w_mode && a.wd != 0.f) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  m = __fadd_rn(__fmul_rn(a.beta1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.beta2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  float u = __fdiv_rn(__fmul_rn(m, a.c1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, a.c2)), a.eps));
  if (a.adam_w_mode && a.wd != 0.f) u = __fadd_rn(u, __fmul_rn(a.wd, p));
  return __fsub_rn(p, __fmul_rn(a.lr, u));
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
adam_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
            float* __restrict__ v, long long n, AdamArgs a) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n4 = n / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float4 mv = reinterpret_cast<float4*>(m)[i];
    float4 vv = reinterpret_cast<float4*>(v)[i];
    float pf[4], gf[4];
    if constexpr (sizeof(P) == 4) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      pf[0] = t.x; pf[1] = t.y; pf[2] = t.z; pf[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) pf[j] = to_f32(p[4 * i + j]);
    }
    if constexpr (sizeof(G) == 4) {
      const float4 t = reinterpret_cast<const float4*>(g)[i];
      gf[0] = t.x; gf[1] = t.y; gf[2] = t.z; gf[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) gf[j] = to_f32(g[4 * i + j]);
    }
    float out[4];
    out[0] = adam_one(pf[0], gf[0], mv.x, vv.x, a);
    out[1] = adam_one(pf[1], gf[1], mv.y, vv.y, a);
    out[2] = adam_one(pf[2], gf[2], mv.z, vv.z, a);
    out[3] = adam_one(pf[3], gf[3], mv.w, vv.w, a);
    reinterpret_cast<float4*>(m)[i] = mv;
    reinterpret_cast<float4*>(v)[i] = vv;
    if constexpr (sizeof(P) == 4) {
      reinterpret_cast<float4*>(p)[i] = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[4 * i + j] = from_f32<P>(out[j]);
    }
  }
  // tail (n % 4 elements), taken by the first threads of block 0
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    float mi = m[i], vi = v[i];
    p[i] = from_f32<P>(adam_one(to_f32(p[i]), to_f32(g[i]), mi, vi, a));
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename P, typename G>
void launch(void* p, const void* g, void* m, void* v, long long n, const AdamArgs& a,
            cudaStream_t s) {
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  adam_kernel<P, G><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, a);
}

}  // namespace

extern "C" {

// p [n] (p_dtype 0 = float32, 1 = bfloat16, 2 = float16) and m, v [n]
// float32 updated in place from g [n] (g_dtype likewise); every pointer
// 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
int ds_fused_adam(void* p, const void* g, void* m, void* v, long long n, int p_dtype,
                  int g_dtype, float lr, float c1, float c2, float beta1, float beta2,
                  float one_minus_beta1, float one_minus_beta2, float eps, float weight_decay,
                  int adam_w_mode, void* stream) {
  if (n <= 0) return 0;
  if (((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) % 16) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const AdamArgs a{lr, c1, c2, beta1, beta2, one_minus_beta1, one_minus_beta2, eps,
                   weight_decay, adam_w_mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype < 0 || p_dtype > 2 || g_dtype < 0 || g_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p_dtype * 3 + g_dtype) {
    case 0: launch<float, float>(p, g, m, v, n, a, s); break;
    case 1: launch<float, __nv_bfloat16>(p, g, m, v, n, a, s); break;
    case 2: launch<float, __half>(p, g, m, v, n, a, s); break;
    case 3: launch<__nv_bfloat16, float>(p, g, m, v, n, a, s); break;
    case 4: launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, n, a, s); break;
    case 5: launch<__nv_bfloat16, __half>(p, g, m, v, n, a, s); break;
    case 6: launch<__half, float>(p, g, m, v, n, a, s); break;
    case 7: launch<__half, __nv_bfloat16>(p, g, m, v, n, a, s); break;
    default: launch<__half, __half>(p, g, m, v, n, a, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
