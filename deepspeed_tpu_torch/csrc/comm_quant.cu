// Blockwise int8 codec of the quantized collectives for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces no Pallas kernel: the JAX package's codec
// (deepspeed_tpu/comm/quant.py `quantize_blockwise` /
// `dequantize_blockwise`, and the dequantize-and-sum stages of
// comm/collectives_q.py) is jnp that XLA fuses into each collective's
// program.  Run as PyTorch ops it would be ~8 elementwise launches a leaf;
// here it is two kernels.
//
// quantize_blockwise_kernel: x [rows, len] (fp32, bf16 or fp16) -> q int8
// [rows, nb, block], s fp32 [rows, nb], nb = ceil(len / block), each row
// zero-padded to nb * block on its own (a collective quantizes each
// destination's chunk apart).  For each block:
//
//   absmax = max |x|,  s = absmax * fl(1/127),
//   inv = s > 0 ? 1 / s : 0,  q = rint(x * inv)
//
// The product with fl(1/127) is what XLA compiles `absmax / 127.0` to
// under jit (it folds a division by a constant into a product with the
// reciprocal), and every JAX caller of the codec runs under jit.  The
// reciprocal is the IEEE quotient, the products are rounded on their own
// (__fmul_rn: no contraction, no fast math) and rint rounds half to even,
// so codes and scales equal the plain version's bit for bit.
//
// dequantize_blockwise_kernel: q int8 [P, nb, block], s fp32 [P, nb] ->
// either each source's first `keep` values q * s, concatenated in source
// order ([P * keep], the gather side: each source's padding stripped), or
// their sum over P ([keep], the reduce side), acc = fma(q, s, acc) from 0
// in source order: XLA's CPU backend fuses the JAX collectives' product
// and sum into that chain (each step rounded once); the result is stored
// in the output dtype.
//
// dequantize_error_kernel: the error-feedback residual of q_all_reduce,
// base [n] fp32 minus the sources' codes times their scales, the sources
// read as one flat run of whole blocks: out[i] = fma(-q[i], s[i / block],
// base[i]), rounded once, as XLA's CPU backend fuses `comp - q * s`.
//
// What bounds them on the H100: memory bytes.  The quantizer reads x once
// and writes a code byte an element and 4 bytes a block; the dequantizer
// reads a code byte an element (P of them for a sum) and writes the
// output.  Design: the quantizer takes a warp a quantization block, 8
// warps a CUDA block, no shared memory and no barrier (the absmax is a
// warp shuffle); at the default block of 256 over rows of whole 16-byte
// vectors, each lane holds its 8 values in registers between the absmax
// and the codes (one 16- or 32-byte load, one 8-byte store), otherwise
// the warp reads the block twice (the second pass from L1).  The
// dequantizer takes 8 consecutive outputs a thread where a block is whole
// 8-element groups (8 codes in one 8-byte load, the outputs in 16-byte
// stores), one output a thread otherwise; a grid-stride loop, the sources
// of a concatenation on the grid's y axis.  (The first version, a CUDA
// block a quantization block with two barriers and one element a thread
// everywhere, ran at 20-46 % of the bound: PERF.md.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // quantizer: warps (quant blocks) a CUDA block
constexpr int kDequantThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVecBlock = 256;            // the block the register path serves
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// 8 consecutive values (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = to_f32(h[k]);
}

// 8 consecutive outputs (16-byte aligned)
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float v[8]) {
  uint4 u;
  T* h = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = from_f32<T>(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t code(float x, float inv) {
  return static_cast<int8_t>(rintf(__fmul_rn(x, inv)));
}

// a warp a quantization block g = row * nb + index in the row; VEC: block
// kVecBlock, the row's length a multiple of 8 and x 16-byte aligned
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
quantize_blockwise_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ s, long long len, int block, long long nb,
                          long long total) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= total) return;
  const int lane = threadIdx.x & 31;
  const long long row = g / nb;
  const long long start = (g - row * nb) * block;
  const long long rem = len - start;
  const int n = rem < block ? static_cast<int>(rem) : block;
  const T* xb = x + row * len + start;
  int8_t* qb = q + g * block;
  if constexpr (VEC) {
    float v[8];
    const bool have = lane * 8 < n;          // n is a multiple of 8
    if (have) {
      load8(xb + lane * 8, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
    amax = warp_max(amax);
    const float sc = __fmul_rn(amax, kInv127);
    const float inv = sc > 0.f ? __fdiv_rn(1.f, sc) : 0.f;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[k], inv))) << (8 * k);
      hi |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[k + 4], inv))) << (8 * k);
    }
    reinterpret_cast<uint2*>(qb)[lane] = make_uint2(lo, hi);
    if (lane == 0) s[g] = sc;
    return;
  }
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(to_f32(xb[i])));
  amax = warp_max(amax);
  const float sc = __fmul_rn(amax, kInv127);
  const float inv = sc > 0.f ? __fdiv_rn(1.f, sc) : 0.f;
  for (int i = lane; i < block; i += 32)
    qb[i] = i < n ? code(to_f32(xb[i]), inv) : static_cast<int8_t>(0);
  if (lane == 0) s[g] = sc;
}

// VEC: 8 consecutive outputs a thread (block and keep multiples of 8, q
// and out 16-byte aligned)
template <typename T, bool SUM, bool VEC>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_blockwise_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                            T* __restrict__ out, int P, long long nb, int block,
                            long long keep) {
  const long long per = nb * block;
  constexpr int W = VEC ? 8 : 1;
  const long long groups = keep / W;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // a concatenation's source is the grid's y; a sum runs over all of them
  const int p0 = SUM ? 0 : static_cast<int>(blockIdx.y);
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < groups; t += stride) {
    const long long j = t * W;
    const long long b = j / block;
    float v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = 0.f;
    for (int p = p0; p < (SUM ? P : p0 + 1); ++p) {
      const int8_t* qp = q + p * per + j;
      const float sc = s[p * nb + b];
      alignas(8) int8_t c[W];
      if constexpr (VEC) {
        *reinterpret_cast<uint2*>(c) = *reinterpret_cast<const uint2*>(qp);
      } else {
        c[0] = qp[0];
      }
#pragma unroll
      for (int k = 0; k < W; ++k)
        v[k] = SUM ? __fmaf_rn(static_cast<float>(c[k]), sc, v[k])
                   : __fmul_rn(static_cast<float>(c[k]), sc);
    }
    T* o = out + (SUM ? 0 : static_cast<long long>(p0) * keep) + j;
    if constexpr (VEC) {
      store8(o, v);
    } else {
      o[0] = from_f32<T>(v[0]);
    }
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (!cached[device]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

// Makes CUDA device `device` current for a launch if it is not, and the
// previous one current again after it.
class OnDevice {
 public:
  explicit OnDevice(int device) : want_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != want_) err_ = cudaSetDevice(want_);
  }
  ~OnDevice() {
    if (err_ == cudaSuccess && prev_ != want_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int want_, prev_ = -1;
  cudaError_t err_;
};

// 8 consecutive elements a thread where VEC (block and n multiples of 8,
// every pointer 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_error_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                        const float* __restrict__ base, float* __restrict__ out, int block,
                        long long n) {
  constexpr int W = VEC ? 8 : 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < n / W;
       t += stride) {
    const long long i = t * W;
    const float sc = s[i / block];
    if constexpr (VEC) {
      alignas(8) int8_t c[8];
      *reinterpret_cast<uint2*>(c) = *reinterpret_cast<const uint2*>(q + i);
      float v[8];
      load8(base + i, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __fmaf_rn(-static_cast<float>(c[k]), sc, v[k]);
      store8(out + i, v);
    } else {
      out[i] = __fmaf_rn(-static_cast<float>(q[i]), sc, base[i]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* s, long long rows, long long len,
                            int block, cudaStream_t stream) {
  const long long nb = (len + block - 1) / block;
  const long long total = rows * nb;
  const unsigned grid = static_cast<unsigned>((total + kWarps - 1) / kWarps);
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (block == kVecBlock && len % 8 == 0 && aligned16(x) && aligned16(q))
    quantize_blockwise_kernel<T, true><<<grid, kWarps * 32, 0, stream>>>(xp, qp, sp, len, block,
                                                                        nb, total);
  else
    quantize_blockwise_kernel<T, false><<<grid, kWarps * 32, 0, stream>>>(xp, qp, sp, len, block,
                                                                         nb, total);
  return cudaGetLastError();
}

template <typename T, bool SUM>
cudaError_t launch_dequantize_as(const int8_t* q, const float* s, T* out, int P, long long nb,
                                 int block, long long keep, int device, cudaStream_t stream) {
  const bool vec = block % 8 == 0 && keep % 8 == 0 && aligned16(q) && aligned16(out);
  const long long groups = vec ? keep / 8 : keep;
  long long blocks = (groups + kDequantThreads - 1) / kDequantThreads;
  long long cap = static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  if (!SUM) cap = (cap + P - 1) / P;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), SUM ? 1u : static_cast<unsigned>(P));
  if (vec)
    dequantize_blockwise_kernel<T, SUM, true><<<grid, kDequantThreads, 0, stream>>>(
        q, s, out, P, nb, block, keep);
  else
    dequantize_blockwise_kernel<T, SUM, false><<<grid, kDequantThreads, 0, stream>>>(
        q, s, out, P, nb, block, keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequantize(const void* q, const void* s, void* out, int P, long long nb,
                              int block, long long keep, bool sum, int device,
                              cudaStream_t stream) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  T* op = static_cast<T*>(out);
  if (sum) return launch_dequantize_as<T, true>(qp, sp, op, P, nb, block, keep, device, stream);
  return launch_dequantize_as<T, false>(qp, sp, op, P, nb, block, keep, device, stream);
}

cudaError_t launch_error(const void* q, const void* s, const void* base, void* out, int block,
                         long long n, int device, cudaStream_t stream) {
  const bool vec = block % 8 == 0 && n % 8 == 0 && aligned16(q) && aligned16(base) &&
                   aligned16(out);
  const long long groups = vec ? n / 8 : n;
  long long blocks = (groups + kDequantThreads - 1) / kDequantThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(base);
  float* op = static_cast<float*>(out);
  if (vec)
    dequantize_error_kernel<true><<<static_cast<unsigned>(blocks), kDequantThreads, 0, stream>>>(
        qp, sp, bp, op, block, n);
  else
    dequantize_error_kernel<false><<<static_cast<unsigned>(blocks), kDequantThreads, 0, stream>>>(
        qp, sp, bp, op, block, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, len] contiguous (dtype 0 = float32, 1 = bfloat16, 2 = float16)
// -> q int8 [rows, ceil(len / block), block], s float32 [rows, ceil(len /
// block)].  Nothing is launched for an empty x.  Returns the launch's
// cudaError_t.
int ds_quantize_blockwise(const void* x, void* q, void* s, long long rows, long long len,
                          int block, int dtype, void* stream, int device) {
  if (rows <= 0 || len <= 0) return 0;
  if (block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (rows * ((len + block - 1) / block) + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_quantize<float>(x, q, s, rows, len, block, st));
    case 1:
      return static_cast<int>(launch_quantize<__nv_bfloat16>(x, q, s, rows, len, block, st));
    case 2: return static_cast<int>(launch_quantize<__half>(x, q, s, rows, len, block, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q int8 [P, nb, block], s float32 [P, nb] -> out (dtype as above): the
// first `keep` values of each source concatenated ([P * keep]), or with
// `sum` their sum over the sources ([keep]).  keep <= nb * block.
int ds_dequantize_blockwise(const void* q, const void* s, void* out, int P, long long nb,
                            int block, long long keep, int sum, int dtype, void* stream,
                            int device) {
  if (P <= 0 || keep <= 0) return 0;
  if (block < 1 || keep > nb * block || P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool add = sum != 0;
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_dequantize<float>(q, s, out, P, nb, block, keep, add, device, st));
    case 1:
      return static_cast<int>(
          launch_dequantize<__nv_bfloat16>(q, s, out, P, nb, block, keep, add, device, st));
    case 2:
      return static_cast<int>(
          launch_dequantize<__half>(q, s, out, P, nb, block, keep, add, device, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q int8 (whole blocks, flat), s float32 (one a block), base float32 [n]
// -> out float32 [n]: base - q * s, each element rounded once (fma).
int ds_dequantize_error(const void* q, const void* s, const void* base, void* out, int block,
                        long long n, void* stream, int device) {
  if (n <= 0) return 0;
  if (block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  return static_cast<int>(
      launch_error(q, s, base, out, block, n, device, static_cast<cudaStream_t>(stream)));
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
