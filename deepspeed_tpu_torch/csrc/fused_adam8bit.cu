// Fused 8-bit-state AdamW update (+ stochastic rounding to bf16) for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/fused_adam8bit.py `fused_adam8bit_update`
// (kernel `_kernel`, pallas_call at :131).  For each row of `block`
// elements of a leaf, in fp32:
//
//   m  = mq * ms;  v = (vq * vs)^2            (dequant; v kept in sqrt space)
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + (1 - b2) * g * g
//   u  = (m * c1) / (sqrt(v * c2) + eps) + wd * p      (c = 1/(1 - beta^t))
//   p' = p - lr * u
//   (mq, ms) = absmax-int8(m),  (vq, vs) = absmax-int8(sqrt(v))   per row
//   p  = sr ? stochastic_round_bf16(p') : p' in p's dtype
//
// Every product, sum, quotient and root is written with its IEEE-rounded
// intrinsic (__fmul_rn, __fadd_rn, ...), so nvcc contracts nothing into an
// FMA and the result equals the plain PyTorch version's op for op, codes
// included.  Codes round half to even (rintf, as jnp.round / torch.round).
//
// Stochastic rounding: the TPU kernel adds the low 16 bits of its on-core
// PRNG to the fp32 bit pattern and clears the low 16 bits.  The same bit
// rule here takes its 16 bits from a counter-based hash of (seed, flat
// element index), `ds_sr_noise` below, which the plain version writes out
// identically, so the two give the same noise and the same bits.
//
// Layout (as deepspeed_tpu/ops/adam/adam8bit.py keeps its state): the
// codes are int8 [nb_pad, block] and the scales fp32 [nb_pad, 1], nb_pad =
// ceil(n / block) rounded up to 32 rows.  p and g are the leaf's own flat
// [n] buffers: positions past n are taken as the zeros that the JAX
// wrapper's pad2d would add, and p is never written there.  Rows wholly
// past n are processed too, so their codes stay 0 and their scales 1, as
// in the JAX state.  p, codes and scales are updated IN PLACE.
//
// What bounds it on the H100: memory bytes.  Per parameter with bf16 p
// and g it reads p, g and two codes and writes p and two codes: 10 bytes
// (plus 16 bytes of scales a row), 2.77 GB and 0.83 ms for the 276.8M-
// element MLP leaf of llama-1b4 at 3.35 TB/s; 16 bytes with fp32 p and g.
// Design: one CUDA block per row, block / 4 threads (32 to 256), each
// holding 4, 8 or 16 elements in registers across the two absmax
// reductions, so every input is read once and every output written once;
// 16-byte loads of fp32 (8 of bf16, 4 of codes) with an element-by-element
// tail at the ragged end of the leaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

struct Args {
  float lr, c1, c2, b1, b2, omb1, omb2, eps, wd;
  uint32_t key;  // ds_mix32(seed)
  int sr;
};

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T store_p(float v, uint32_t noise, int sr);
template <> __device__ __forceinline__ float store_p<float>(float v, uint32_t, int) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_p<__nv_bfloat16>(float v, uint32_t noise, int sr) {
  if (!sr) return __float2bfloat16_rn(v);
  const uint32_t bits = (__float_as_uint(v) + noise) & 0xFFFF0000u;
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
}

// loads of 4 consecutive elements (a vector, or element by element past n)
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  __device__ static void load(const float* s, float* d) {
    const float4 t = *reinterpret_cast<const float4*>(s);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  }
  __device__ static void store(float* d, const float* s) {
    *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* s, float* d) {
    const uint2 raw = *reinterpret_cast<const uint2*>(s);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = __bfloat162float(e[k]);
  }
  __device__ static void store(__nv_bfloat16* d, const __nv_bfloat16* s) {
    *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
  }
};

// max of two values over the CUDA block (every thread gets both)
__device__ __forceinline__ void block_max2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  if (nw == 1) return;
  if (lane == 0) { red[warp] = a; red[8 + warp] = b; }
  __syncthreads();
  a = 0.f; b = 0.f;
  for (int w = 0; w < nw; ++w) { a = fmaxf(a, red[w]); b = fmaxf(b, red[8 + w]); }
}

__device__ __forceinline__ int8_t code(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// V vectors of 4 elements per thread; blockDim.x * 4 * V == block
template <typename P, typename G, int V>
__global__ void __launch_bounds__(kMaxThreads)
adam8bit_kernel(P* __restrict__ p, const G* __restrict__ g, int8_t* __restrict__ mq,
                float* __restrict__ ms, int8_t* __restrict__ vq, float* __restrict__ vs,
                long long n, int block, Args a) {
  __shared__ float red[16];
  const long long row = blockIdx.x;
  const long long base = row * block;
  const float msr = ms[row], vsr = vs[row];
  float mm[4 * V], sv[4 * V], nw[4 * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = (k * blockDim.x + threadIdx.x) * 4;
    const long long e = base + j;
    float pf[4], gf[4];
    if (e + 4 <= n) {
      Vec4<P>::load(p + e, pf);
      Vec4<G>::load(g + e, gf);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool ok = e + t < n;
        pf[t] = ok ? to_f32(p[e + t]) : 0.f;
        gf[t] = ok ? to_f32(g[e + t]) : 0.f;
      }
    }
    const char4 cm = *reinterpret_cast<const char4*>(mq + base + j);
    const char4 cv = *reinterpret_cast<const char4*>(vq + base + j);
    const int8_t qm[4] = {cm.x, cm.y, cm.z, cm.w};
    const int8_t qv[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float gt = gf[t], pt = pf[t];
      float m = __fmul_rn(static_cast<float>(qm[t]), msr);
      const float rv = __fmul_rn(static_cast<float>(qv[t]), vsr);
      float v = __fmul_rn(rv, rv);
      m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, gt));
      v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, gt), gt));
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, a.c2)), a.eps);
      const float u = __fadd_rn(__fdiv_rn(__fmul_rn(m, a.c1), den), __fmul_rn(a.wd, pt));
      mm[4 * k + t] = m;
      sv[4 * k + t] = __fsqrt_rn(v);
      nw[4 * k + t] = __fsub_rn(pt, __fmul_rn(a.lr, u));
    }
  }
  float am = 0.f, av = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * V; ++i) {
    am = fmaxf(am, fabsf(mm[i]));
    av = fmaxf(av, sv[i]);
  }
  block_max2(am, av, red);
  const float sm = am == 0.f ? 1.f : __fdiv_rn(am, 127.f);
  const float ss = av == 0.f ? 1.f : __fdiv_rn(av, 127.f);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = (k * blockDim.x + threadIdx.x) * 4;
    const long long e = base + j;
    *reinterpret_cast<char4*>(mq + base + j) =
        make_char4(code(mm[4 * k], sm), code(mm[4 * k + 1], sm), code(mm[4 * k + 2], sm),
                   code(mm[4 * k + 3], sm));
    *reinterpret_cast<char4*>(vq + base + j) =
        make_char4(code(sv[4 * k], ss), code(sv[4 * k + 1], ss), code(sv[4 * k + 2], ss),
                   code(sv[4 * k + 3], ss));
    alignas(8) P out[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t noise =
          a.sr ? (mix32(static_cast<uint32_t>(e + t) ^ a.key) & 0xFFFFu) : 0u;
      out[t] = store_p<P>(nw[4 * k + t], noise, a.sr);
    }
    if (e + 4 <= n) {
      Vec4<P>::store(p + e, out);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (e + t < n) p[e + t] = out[t];
    }
  }
  if (threadIdx.x == 0) {
    ms[row] = sm;
    vs[row] = ss;
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, void* mq, void* ms, void* vq, void* vs, long long n,
           long long rows, int block, const Args& a, cudaStream_t s) {
  const int threads = block / 4 < kMaxThreads ? block / 4 : kMaxThreads;
  const int v = block / (4 * threads);
  const dim3 grid(static_cast<unsigned>(rows));
#define DS_ADAM8BIT_LAUNCH(V)                                                              \
  adam8bit_kernel<P, G, V><<<grid, threads, 0, s>>>(                                       \
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<int8_t*>(mq),              \
      static_cast<float*>(ms), static_cast<int8_t*>(vq), static_cast<float*>(vs), n, block, \
      a)
  switch (v) {
    case 1: DS_ADAM8BIT_LAUNCH(1); break;
    case 2: DS_ADAM8BIT_LAUNCH(2); break;
    case 4: DS_ADAM8BIT_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_ADAM8BIT_LAUNCH
  return 0;
}

}  // namespace

extern "C" {

// The SR noise's key for a seed (the plain version computes the same).
unsigned int ds_mix32(unsigned int x) { return mix32(x); }

// p [n] (p_dtype 0 = float32, 1 = bfloat16) updated in place from g [n]
// (g_dtype likewise); mq, vq int8 [rows, block] and ms, vs float32 [rows]
// updated in place; rows * block >= n, block a power of two in [128, 4096];
// p and g 16-byte aligned, mq and vq 4-byte aligned.  sr != 0 rounds a
// bf16 p stochastically with the noise of `seed`.  Returns the cudaError_t
// of the launch (0 on success).
int ds_fused_adam8bit(void* p, const void* g, void* mq, void* ms, void* vq, void* vs,
                      long long n, long long rows, int block, int p_dtype, int g_dtype,
                      float lr, float c1, float c2, float beta1, float beta2,
                      float one_minus_beta1, float one_minus_beta2, float eps,
                      float weight_decay, unsigned int seed, int sr, void* stream) {
  if (n <= 0) return 0;
  if (block < 128 || block > 4096 || (block & (block - 1)) != 0 || rows * block < n ||
      rows > 0x7fffffffLL || n > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g)) % 16) != 0 ||
      ((reinterpret_cast<uintptr_t>(mq) | reinterpret_cast<uintptr_t>(vq)) % 4) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{lr, c1, c2, beta1, beta2, one_minus_beta1, one_minus_beta2, eps,
               weight_decay, mix32(seed), sr && p_dtype == 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = 0;
  switch (p_dtype * 2 + g_dtype) {
    case 0: code = launch<float, float>(p, g, mq, ms, vq, vs, n, rows, block, a, s); break;
    case 1:
      code = launch<float, __nv_bfloat16>(p, g, mq, ms, vq, vs, n, rows, block, a, s);
      break;
    case 2:
      code = launch<__nv_bfloat16, float>(p, g, mq, ms, vq, vs, n, rows, block, a, s);
      break;
    case 3:
      code = launch<__nv_bfloat16, __nv_bfloat16>(p, g, mq, ms, vq, vs, n, rows, block, a, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
