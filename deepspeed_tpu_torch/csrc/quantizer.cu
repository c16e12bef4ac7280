// Symmetric per-block quantization for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces: deepspeed_tpu/ops/pallas/quantizer.py `quantize` (kernel
// `_quant_kernel`, pallas_call at :64).  For each block of `block`
// consecutive elements of the flat input:
//
//   absmax = max |x|,  scale = absmax == 0 ? 1 : absmax / qmax,
//   q      = clip(rint(x / scale), -qmax, qmax)        (int8 codes)
//
// with qmax 127 (8 bits) or 7 (4 bits; codes stay one per byte, packing
// is the caller's).  rint rounds half to even, as jnp.round and
// torch.round (roundf would round half away from zero); the divisions are
// the IEEE ones (no fast math), so the codes and scales equal the plain
// version's bit for bit.
//
// The Pallas wrapper first materialises a zero-padded fp32 copy of x
// (quantizer.py:54-57); this kernel reads x in its own dtype (fp32, bf16 or
// fp16) and treats the positions past n of the last block as the zeros of
// that padding: their codes are written as 0.
//
// What bounds it on the H100: memory bytes.  It reads x once from device
// memory (4 bytes an element in fp32) and writes one code byte an element
// and 4 bytes a block: ~5 bytes an element, 0.41 ms for the 276.8M-element
// MLP leaf of llama-1b4 at 3.35 TB/s.  Design: one CUDA block per
// quantization block, with as many threads as the block has 16-byte
// vectors (32 to 256); pass 1 takes the block's absmax with 16-byte loads
// and a warp-shuffle + shared-memory max; pass 2 reads the block again
// (from L2: a block is at most 256 KB) and writes its codes, 4 or 8 a
// store.  A block whose length or start is not a multiple of the vector
// (a ragged last block) takes element-by-element loads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// max over the CUDA block (every thread gets the result); blockDim.x is a
// multiple of 32
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ int8_t code(float x, float scale, float qmax) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -qmax), qmax));
}

// VEC elements of T are 16 bytes
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                long long n, int block, float qmax) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[33];
  const int nt = blockDim.x;
  const long long b = blockIdx.x;
  const long long start = b * block;
  const long long rem = n - start;
  const int len = rem < block ? static_cast<int>(rem) : block;
  const T* xb = x + start;
  int8_t* qb = q + start;
  const bool vec = (len == block) && (block % VEC == 0) &&
                   ((reinterpret_cast<uintptr_t>(xb) & 15) == 0);

  float amax = 0.f;
  if (vec) {
    for (int i = threadIdx.x * VEC; i < block; i += nt * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xb + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) amax = fmaxf(amax, fabsf(to_f32(e[k])));
    }
  } else {
    for (int i = threadIdx.x; i < len; i += nt) amax = fmaxf(amax, fabsf(to_f32(xb[i])));
  }
  amax = block_max(amax, red);
  const float s = amax == 0.f ? 1.f : __fdiv_rn(amax, qmax);

  if (vec) {
    for (int i = threadIdx.x * VEC; i < block; i += nt * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xb + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      alignas(8) int8_t out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[k] = code(to_f32(e[k]), s, qmax);
      if constexpr (VEC == 4) {
        *reinterpret_cast<char4*>(qb + i) = *reinterpret_cast<const char4*>(out);
      } else {
        *reinterpret_cast<int2*>(qb + i) = *reinterpret_cast<const int2*>(out);
      }
    }
  } else {
    for (int i = threadIdx.x; i < block; i += nt)
      qb[i] = i < len ? code(to_f32(xb[i]), s, qmax) : static_cast<int8_t>(0);
  }
  if (threadIdx.x == 0) scale[b] = s;
}

template <typename T>
void launch(const void* x, void* q, void* scale, long long n, int block, float qmax,
            cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nb = (n + block - 1) / block;
  int threads = 32;
  while (threads < kMaxThreads && threads * VEC < block) threads *= 2;
  quantize_kernel<T><<<static_cast<unsigned>(nb), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), n, block,
      qmax);
}

}  // namespace

extern "C" {

// x [n] (dtype 0 = float32, 1 = bfloat16, 2 = float16) -> q int8
// [ceil(n / block), block], scale float32 [ceil(n / block)]; block in
// [1, 65536]; q 8-byte aligned.  Returns the cudaError_t of the launch.
int ds_quantize(const void* x, void* q, void* scale, long long n, int block, int dtype,
                float qmax, void* stream) {
  if (n <= 0) return 0;
  if (block < 1 || block > (1 << 16) || (n + block - 1) / block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) & 7) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, q, scale, n, block, qmax, s); break;
    case 1: launch<__nv_bfloat16>(x, q, scale, n, block, qmax, s); break;
    case 2: launch<__half>(x, q, scale, n, block, qmax, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
