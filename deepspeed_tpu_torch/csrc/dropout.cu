// Dropout drawn from JAX's threefry stream, for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces no Pallas kernel: the JAX package's dropout
// (deepspeed_tpu/models/transformer.py `_dropout`) is plain jnp,
//
//   keep = jax.random.bernoulli(key, 1 - rate, x.shape)
//   y    = where(keep, x / (1 - rate), 0)
//
// which XLA fuses into its neighbours.  The port needs a kernel for the card
// to run this path at all: nothing is stored between the forward and the
// backward, so every call (the forward, the backward, and each recompute
// under remat) draws the mask again from (key, flat index), and the plain
// PyTorch version of the draw is some 80 int64 elementwise passes over the
// tensor.  Here one pass does it: each element's 20-round Threefry-2x32 hash
// stays in registers, and x is read once and y written once.
//
// The bits are jax's, bit for bit (jax_threefry_partitionable on, its
// default): the element at row-major flat index i draws
//   bits = x0 ^ x1 of threefry2x32(key, (i >> 32, i & 0xffffffff)),
// and keeps the element when the uniform (bits >> 9) * 2^-23 is below
// float32(1 - rate), i.e. when bits >> 9 < thr = ceil(float32(1 - rate) *
// 2^23), which the wrapper computes.  The kept value is x * scale rounded to
// x's dtype, scale being what XLA's compiled division by the constant
// multiplies by on the CPU: the fp32 reciprocal of (1 - rate) rounded to x's
// dtype for fp32 and bf16 (bf16 computes in fp32 there), the fp16
// reciprocal for fp16.  The product is one rounding in fp32 (exact for
// fp16), then round-to-nearest-even to x's dtype.  The backward of dropout
// is the same function of dy with the same key, so one kernel serves both.
//
// What bounds it on the H100: 32-bit integer operations.  A hash is 20
// rounds of an add, a rotate (one funnel shift) and an xor, plus 6 key
// injections: about 80 integer instructions an element against 2 to 4
// bytes of x and as many of y, so at [4, 2048, 2048] bf16 some 1.3 G
// integer operations against 67 MB.  The design keeps every thread on
// integer work: 16-byte vectors of x (8 bf16 or fp16, 4 fp32 elements) a
// thread, a grid of a few waves striding over the tensor, the key words and
// the injection constants in registers.  No shared memory, no atomics, no
// read-back and no allocation, so a launch can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Chunk {
  T v[N];
};

// The key words and the parity word k0 ^ k1 ^ 0x1BD11BDA, held in
// registers for the kernel's life.
struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One Threefry round: x0 += x1; x1 = rotl(x1, r) ^ x0.
#define DS_MIX(r)        \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;

// x0 ^ x1 of the 20-round Threefry-2x32 hash of the counter (c0, c1).
__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t c0, uint32_t c1) {
  uint32_t x0 = c0 + k.k0, x1 = c1 + k.k1;
  DS_MIX(13) DS_MIX(15) DS_MIX(26) DS_MIX(6)
  x0 += k.k1; x1 += k.k2 + 1u;
  DS_MIX(17) DS_MIX(29) DS_MIX(16) DS_MIX(24)
  x0 += k.k2; x1 += k.k0 + 2u;
  DS_MIX(13) DS_MIX(15) DS_MIX(26) DS_MIX(6)
  x0 += k.k0; x1 += k.k1 + 3u;
  DS_MIX(17) DS_MIX(29) DS_MIX(16) DS_MIX(24)
  x0 += k.k1; x1 += k.k2 + 4u;
  DS_MIX(13) DS_MIX(15) DS_MIX(26) DS_MIX(6)
  x0 += k.k2; x1 += k.k0 + 5u;
  return x0 ^ x1;
}
#undef DS_MIX

template <typename T>
__device__ __forceinline__ T drop_one(T v, unsigned long long i, const Key& k, uint32_t thr,
                                      float scale) {
  const uint32_t bits =
      threefry_bits(k, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
  return (bits >> 9) < thr ? from_f32<T>(__fmul_rn(to_f32(v), scale)) : from_f32<T>(0.0f);
}

// y[i] = keep(i) ? x[i] * scale : 0 for i < n, V elements a 16-byte access
// (V = 1 for unaligned pointers); the n % V elements past the last vector go
// to the first threads of the grid.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, uint32_t k0,
                   uint32_t k1, uint32_t thr, float scale) {
  const Key k{k0, k1, k0 ^ k1 ^ kParity};
  const long long nv = n / V;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // one vector an iteration (its V hashes unrolled): the loop body is the
  // per-element work whose SASS chip_smoke.py counts for the bound
#pragma unroll 1
  for (long long v = tid; v < nv; v += stride) {
    const Chunk<T, V> in = reinterpret_cast<const Chunk<T, V>*>(x)[v];
    Chunk<T, V> out;
    const unsigned long long base = static_cast<unsigned long long>(v) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) out.v[j] = drop_one(in.v[j], base + j, k, thr, scale);
    reinterpret_cast<Chunk<T, V>*>(y)[v] = out;
  }
  const long long i = nv * V + tid;
  if (i < n) y[i] = drop_one(x[i], static_cast<unsigned long long>(i), k, thr, scale);
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        c <= 0)
      c = 132;
    counts[device] = c;
  }
  return counts[device];
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, uint32_t k0, uint32_t k1, uint32_t thr,
                   float scale, int device, cudaStream_t stream) {
  constexpr int V = static_cast<int>(16 / sizeof(T));
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long units = vec ? n / V : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vec)
    dropout_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xp, yp, n, k0, k1, thr, scale);
  else
    dropout_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xp, yp, n, k0, k1, thr, scale);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// y = dropout(x) over n contiguous elements of dtype (0 = float32,
// 1 = bfloat16, 2 = float16) under the threefry key (k0, k1): an element is
// kept when its draw's top 23 bits are below thr, and then multiplied by
// scale.  x and y may be the same buffer.  n <= 0 launches nothing.  Returns
// the launch's cudaError_t.
int ds_dropout(const void* x, void* y, long long n, unsigned k0, unsigned k1, unsigned thr,
               float scale, int dtype, void* stream, int device) {
  if (n <= 0) return 0;
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, y, n, k0, k1, thr, scale, device, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, y, n, k0, k1, thr, scale, device, s));
    case 2: return static_cast<int>(launch<__half>(x, y, n, k0, k1, thr, scale, device, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
