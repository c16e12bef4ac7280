// Fused LAMB update for Hopper (sm_90a), with a plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/fused_lamb.py `fused_lamb_update`:
// `_lamb_phase1_kernel` (pallas_call at :110), the XLA trust-ratio combine
// after it (:121-126) and `_scale_kernel` (pallas_call at :128).  One LAMB
// step of one leaf, in fp32 whatever the dtypes of p and g:
//
//   m = b1 * m + (1 - b1) * g;   v = b2 * v + (1 - b2) * g * g
//   u = (m * c1) / (sqrt(v * c2) + eps) (+ wd * p when wd != 0)
//   w = ||p||, r = ||u||,  trust = (w > 0 && r > 0) ? w / r : 1
//   p = p - (lr * trust) * u
//
// Three launches, all on the caller's stream, with no host sync:
//  1. phase1: m and v IN PLACE, and per-block fp32 partial sums of p^2 and
//     u^2.  The Pallas kernel carries both sums across its sequential grid
//     in scratch; Hopper's blocks run in any order, so each block writes
//     its own pair and
//  2. reduce (one block) sums the pairs in a fixed order, so the norms are
//     bit-equal run to run, and stores w, r and lr * trust in device
//     memory;
//  3. scale: reads lr * trust from device memory, recomputes u from p and
//     the new m and v (the same rounded operations as phase 1, so the same
//     bits) and writes p IN PLACE.  Recomputing u instead of storing it
//     moves the same bytes (phase 1 no u write, phase 2 reads m, v in place
//     of u) and needs no leaf-sized u buffer (1.1 GB at the largest leaf).
//
// Every operation is written with its IEEE-rounded intrinsic, so nvcc
// contracts nothing into an FMA and m, v and u equal the plain version's
// op for op; only the norms' summation order differs from it.
//
// What bounds it on the H100: memory bytes.  With fp32 p, g, m, v it must
// read 16 bytes a parameter and write 12 (2.31 ms for the 276.8M-element
// leaf at 3.35 TB/s); this two-pass design moves 40 (phase 1 reads p, g,
// m, v and writes m, v; phase 2 reads p, m, v and writes p), 3.31 ms.
// Design: grid-stride loops over 4-element vectors (16-byte loads of every
// fp32 stream) with a scalar tail; phase 1 runs a fixed grid (a function of
// n alone) so the partials, and the sums, do not depend on the run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // phase 1's grid cap; the partials buffer holds 2x this

struct Args {
  float c1, c2, b1, b2, omb1, omb2, eps, wd;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ void load4(const T* s, long long i, float* d) {
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = to_f32(s[4 * i + k]);
}
template <> __device__ __forceinline__ void load4<float>(const float* s, long long i, float* d) {
  const float4 t = reinterpret_cast<const float4*>(s)[i];
  d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
}

__device__ __forceinline__ float lamb_u(float p, float m, float v, const Args& a) {
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, a.c2)), a.eps);
  float u = __fdiv_rn(__fmul_rn(m, a.c1), den);
  if (a.wd != 0.f) u = __fadd_rn(u, __fmul_rn(a.wd, p));
  return u;
}

// one element of phase 1: moments in place, u returned
__device__ __forceinline__ float phase1_one(float p, float g, float& m, float& v, const Args& a) {
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  return lamb_u(p, m, v, a);
}

// sum over the CUDA block in a fixed order (shuffle tree, then warps in order)
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { red[warp] = a; red[32 + warp] = b; }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.f; b = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      a = __fadd_rn(a, red[w]);
      b = __fadd_rn(b, red[32 + w]);
    }
  }
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                   float* __restrict__ v, float* __restrict__ partials, long long n, Args a) {
  __shared__ float red[64];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n4 = n / 4;
  float wsum = 0.f, usum = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float pf[4], gf[4];
    load4<P>(p, i, pf);
    load4<G>(g, i, gf);
    float4 mv = reinterpret_cast<float4*>(m)[i];
    float4 vv = reinterpret_cast<float4*>(v)[i];
    float mm[4] = {mv.x, mv.y, mv.z, mv.w}, vq[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float u = phase1_one(pf[k], gf[k], mm[k], vq[k], a);
      wsum = __fadd_rn(wsum, __fmul_rn(pf[k], pf[k]));
      usum = __fadd_rn(usum, __fmul_rn(u, u));
    }
    reinterpret_cast<float4*>(m)[i] = make_float4(mm[0], mm[1], mm[2], mm[3]);
    reinterpret_cast<float4*>(v)[i] = make_float4(vq[0], vq[1], vq[2], vq[3]);
  }
  // tail (n % 4 elements), taken by the first threads of block 0
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    const float pf = to_f32(p[i]);
    float mi = m[i], vi = v[i];
    const float u = phase1_one(pf, to_f32(g[i]), mi, vi, a);
    m[i] = mi;
    v[i] = vi;
    wsum = __fadd_rn(wsum, __fmul_rn(pf, pf));
    usum = __fadd_rn(usum, __fmul_rn(u, u));
  }
  block_sum2(wsum, usum, red);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = wsum;
    partials[2 * blockIdx.x + 1] = usum;
  }
}

// stats = {||p||, ||u||, lr * trust}
__global__ void __launch_bounds__(kThreads)
lamb_reduce_kernel(const float* __restrict__ partials, int nparts, float lr,
                   float* __restrict__ stats) {
  __shared__ float red[64];
  float w = 0.f, u = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) {
    w = __fadd_rn(w, partials[2 * i]);
    u = __fadd_rn(u, partials[2 * i + 1]);
  }
  block_sum2(w, u, red);
  if (threadIdx.x == 0) {
    const float wn = __fsqrt_rn(w), un = __fsqrt_rn(u);
    const float trust = (wn > 0.f && un > 0.f) ? __fdiv_rn(wn, un) : 1.f;
    stats[0] = wn;
    stats[1] = un;
    stats[2] = __fmul_rn(lr, trust);
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
lamb_scale_kernel(P* __restrict__ p, const float* __restrict__ m, const float* __restrict__ v,
                  const float* __restrict__ stats, long long n, Args a) {
  const float s = stats[2];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n4 = n / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float pf[4];
    load4<P>(p, i, pf);
    const float4 mv = reinterpret_cast<const float4*>(m)[i];
    const float4 vv = reinterpret_cast<const float4*>(v)[i];
    const float mm[4] = {mv.x, mv.y, mv.z, mv.w}, vq[4] = {vv.x, vv.y, vv.z, vv.w};
    float out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = __fsub_rn(pf[k], __fmul_rn(s, lamb_u(pf[k], mm[k], vq[k], a)));
    if constexpr (sizeof(P) == 4) {
      reinterpret_cast<float4*>(p)[i] = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) p[4 * i + k] = from_f32<P>(out[k]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    const float pf = to_f32(p[i]);
    p[i] = from_f32<P>(__fsub_rn(pf, __fmul_rn(s, lamb_u(pf, m[i], v[i], a))));
  }
}

int grid_for(long long n) {
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

bool misaligned(const void* a, const void* b, const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16) != 0;
}

}  // namespace

extern "C" {

// The number of partial pairs phase 1 writes for a leaf of n elements (the
// caller's partials buffer holds 2x this many floats).
int ds_lamb_partials(long long n) { return grid_for(n); }

// Phase 1 and the reduce: m, v [n] float32 updated in place from p [n] and
// g [n] (dtype 0 = float32, 1 = bfloat16); partials float32 [2 *
// ds_lamb_partials(n)] scratch; stats float32 [3] <- (||p||, ||u||, lr *
// trust).  Every pointer 16-byte aligned.  Returns the cudaError_t of the
// launches (0 on success).
int ds_lamb_phase1(const void* p, const void* g, void* m, void* v, void* partials, void* stats,
                   long long n, int p_dtype, int g_dtype, float lr, float c1, float c2,
                   float beta1, float beta2, float one_minus_beta1, float one_minus_beta2,
                   float eps, float weight_decay, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(p, g, m, v) || misaligned(partials, stats, m, v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{c1, c2, beta1, beta2, one_minus_beta1, one_minus_beta2, eps, weight_decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  float* part = static_cast<float*>(partials);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  switch (p_dtype * 2 + g_dtype) {
    case 0:
      lamb_phase1_kernel<float, float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(p), static_cast<const float*>(g), mf, vf, part, n, a);
      break;
    case 1:
      lamb_phase1_kernel<float, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(p), static_cast<const __nv_bfloat16*>(g), mf, vf, part, n,
          a);
      break;
    case 2:
      lamb_phase1_kernel<__nv_bfloat16, float><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(p), static_cast<const float*>(g), mf, vf, part, n,
          a);
      break;
    case 3:
      lamb_phase1_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(g), mf, vf,
          part, n, a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lamb_reduce_kernel<<<1, kThreads, 0, s>>>(part, blocks, lr, static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// Phase 2: p [n] (dtype as above) <- p - stats[2] * u(p, m, v), in place.
int ds_lamb_scale(void* p, const void* m, const void* v, const void* stats, long long n,
                  int p_dtype, float c1, float c2, float eps, float weight_decay,
                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(p, m, v, stats)) return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{c1, c2, 0.f, 0.f, 0.f, 0.f, eps, weight_decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  const float* st = static_cast<const float*>(stats);
  switch (p_dtype) {
    case 0:
      lamb_scale_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<float*>(p), mf, vf, st, n, a);
      break;
    case 1:
      lamb_scale_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<__nv_bfloat16*>(p), mf, vf, st, n, a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
