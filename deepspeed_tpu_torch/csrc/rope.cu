// Rotary position embedding (RoPE), forward and backward, for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/rope.py `_rope_fwd` (kernel body
// `_rope_kernel`, pallas_call :72) and `_rope_bwd_vjp` (:89, the same kernel
// with -sin), and the rotations that the decode paths write in plain jnp
// (deepspeed_tpu/models/fused_decode.py `rope_rows`,
// deepspeed_tpu/models/decoding.py `_rope_rows`), which XLA fuses there.
//
//   y[..., :h]   = x1 * c - x2 * s        x1 = x[..., :h], x2 = x[..., h:2h]
//   y[..., h:2h] = x2 * c + x1 * s        h = rd / 2; s -> -s in the backward
//   y[..., 2h:]  = x[..., 2h:]            (gpt-neox rotary_pct < 1)
//
// in fp32, each product, difference and sum rounded on its own (nvcc would
// otherwise contract x1 * c - x2 * s into an FMA), cast to x's dtype with
// round-to-nearest-even: the bits of the plain PyTorch version, which runs
// each operation as a kernel of its own.
//
// What bounds it on the H100: memory bytes.  Each element is read once and
// written once with three fp32 operations between; the cos and sin rows are
// a small fraction of the bytes.  At llama-1b4's training q and k ([4, 2048,
// 16 + 16, 128] bf16) that is 67 MB read and 67 MB written, a 40 us bound;
// on a decode step ([8, 32 + 8, 128]) 164 KB, where the launch costs more
// than the bytes.
//
// Design.  One launch rotates up to two tensors, q and k, each given by its
// base pointer and its batch, position and head strides in elements (the
// last dim contiguous): the projections' [B, S, Hx, Dh] views and the fused
// decode's [B, (H + 2 Hkv) Dh] QKV rows are read where they lie, with no copy
// before.  The outputs are written contiguous, [B, Hx, S, Dh] (the flash
// kernels' layout) or [B, S, Hx, Dh] (the backward's dx: the projections'
// layout, so autograd copies nothing after it).  A block takes one token
// (b, s): its threads are laid out [rows, columns], each thread holding one
// 16-byte column vector of the token's cos and sin row in registers and
// rotating that column of one head after another, so the table row is read
// once a block.  Where there are fewer tokens than twice the SMs (decode, a
// short prefill) the token's heads are split over blocks too (grid.y, one
// pass of the block's rows each), so that the launch spreads over the card.
// Rows whose halves are no 16-byte vectors (odd widths, unaligned views)
// take the same kernel element by element.  Nothing is allocated here: the
// wrapper passes the outputs, the stream and the device index (made current
// only where it is not), the rest packed in one buffer.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// fewer tokens than this (2 x the H100's 132 SMs): split a token's heads
// over blocks
constexpr long long kSplitTokens = 264;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch casts
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// N elements of T loaded or stored as one access (16 bytes, or one element).
template <typename T, int N>
struct alignas(sizeof(T) * N) Chunk {
  T v[N];
};

// N table entries from p, as fp32: 16-byte loads where N entries span 16
// bytes or more (an fp32 table beside 16-bit x takes two), else one entry.
template <typename TC, int N>
__device__ __forceinline__ void load_f32(const TC* p, float (&out)[N]) {
  constexpr int M = (N * sizeof(TC) >= 16) ? static_cast<int>(16 / sizeof(TC)) : N;
#pragma unroll
  for (int i = 0; i < N; i += M) {
    const Chunk<TC, M> c = *reinterpret_cast<const Chunk<TC, M>*>(p + i);
#pragma unroll
    for (int j = 0; j < M; ++j) out[i + j] = to_f32(c.v[j]);
  }
}

struct RopeArgs {
  const void* x0;
  const void* x1;
  void* y0;
  void* y1;
  long long xb0, xs0, xh0, xb1, xs1, xh1;  // input strides (batch, position, head)
  long long yb0, ys0, yh0, yb1, ys1, yh1;  // output strides
  const void* cos;
  const void* sin;
  long long cb, cs;  // table strides (batch, position); cb 0: one table
  int S, D, half;
  int nh0, nh1;  // heads of each tensor (nh1 0: one tensor)
  int heads_per_block;
  int neg;  // 1: rotate by -angle (the backward)
};

// One block: token blockIdx.x = b * S + s, heads [blockIdx.y * hpb, + hpb)
// of q's then k's; N elements a column vector (16 / sizeof(T), or 1).
template <typename T, typename TC, int N>
__global__ void __launch_bounds__(kThreads) rope_kernel(const RopeArgs a) {
  const int token = blockIdx.x;
  const int b = token / a.S;
  const int s = token - b * a.S;
  const int nht = a.nh0 + a.nh1;
  const int hb = blockIdx.y * a.heads_per_block;
  const int he = min(nht, hb + a.heads_per_block);
  const int P = a.half / N;  // column vectors of a half
  const TC* cr = static_cast<const TC*>(a.cos) + b * a.cb + s * a.cs;
  const TC* sr = static_cast<const TC*>(a.sin) + b * a.cb + s * a.cs;
  for (int c = threadIdx.x; c < P; c += blockDim.x) {
    float cv[N], sv[N];
    load_f32<TC, N>(cr + c * N, cv);
    load_f32<TC, N>(sr + c * N, sv);
    if (a.neg) {
#pragma unroll
      for (int j = 0; j < N; ++j) sv[j] = -sv[j];
    }
    for (int h = hb + threadIdx.y; h < he; h += blockDim.y) {
      const bool second = h >= a.nh0;
      const int hl = second ? h - a.nh0 : h;
      const T* xr = static_cast<const T*>(second ? a.x1 : a.x0) +
                    b * (second ? a.xb1 : a.xb0) + s * (second ? a.xs1 : a.xs0) +
                    hl * (second ? a.xh1 : a.xh0) + c * N;
      T* yr = static_cast<T*>(second ? a.y1 : a.y0) + b * (second ? a.yb1 : a.yb0) +
              s * (second ? a.ys1 : a.ys0) + hl * (second ? a.yh1 : a.yh0) + c * N;
      const Chunk<T, N> p1 = *reinterpret_cast<const Chunk<T, N>*>(xr);
      const Chunk<T, N> p2 = *reinterpret_cast<const Chunk<T, N>*>(xr + a.half);
      Chunk<T, N> o1, o2;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float x1 = to_f32(p1.v[j]);
        const float x2 = to_f32(p2.v[j]);
        o1.v[j] = from_f32<T>(__fsub_rn(__fmul_rn(x1, cv[j]), __fmul_rn(x2, sv[j])));
        o2.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(x2, cv[j]), __fmul_rn(x1, sv[j])));
      }
      *reinterpret_cast<Chunk<T, N>*>(yr) = o1;
      *reinterpret_cast<Chunk<T, N>*>(yr + a.half) = o2;
    }
  }
  // the head dims past 2 * half, copied through
  const int tail = (a.D - 2 * a.half) / N;
  if (tail > 0) {
    const int nthr = blockDim.x * blockDim.y;
    const int n = (he - hb) * tail;
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n; i += nthr) {
      const int h = hb + i / tail;
      const int c = 2 * a.half + (i - (i / tail) * tail) * N;
      const bool second = h >= a.nh0;
      const int hl = second ? h - a.nh0 : h;
      const T* xr = static_cast<const T*>(second ? a.x1 : a.x0) +
                    b * (second ? a.xb1 : a.xb0) + s * (second ? a.xs1 : a.xs0) +
                    hl * (second ? a.xh1 : a.xh0) + c;
      T* yr = static_cast<T*>(second ? a.y1 : a.y0) + b * (second ? a.yb1 : a.yb0) +
              s * (second ? a.ys1 : a.ys0) + hl * (second ? a.yh1 : a.yh0) + c;
      *reinterpret_cast<Chunk<T, N>*>(yr) = *reinterpret_cast<const Chunk<T, N>*>(xr);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Whether every access of the launch is a 16-byte vector: N = 16 / sizeof(T)
// divides the half, the head dim and every stride of x and y, 16 divides the
// table's strides in bytes, and every base pointer is 16-byte aligned.
template <typename T, typename TC>
bool vector_ok(const RopeArgs& a) {
  constexpr long long N = 16 / sizeof(T);
  const long long xs[] = {a.xb0, a.xs0, a.xh0, a.xb1, a.xs1, a.xh1,
                          a.yb0, a.ys0, a.yh0, a.yb1, a.ys1, a.yh1};
  for (long long v : xs)
    if (v % N) return false;
  const long long tb = static_cast<long long>(sizeof(TC));
  return a.half % N == 0 && a.D % N == 0 && (a.cb * tb) % 16 == 0 && (a.cs * tb) % 16 == 0 &&
         aligned16(a.x0) && aligned16(a.y0) && aligned16(a.cos) && aligned16(a.sin) &&
         (a.nh1 == 0 || (aligned16(a.x1) && aligned16(a.y1)));
}

template <typename T, typename TC>
cudaError_t launch(RopeArgs a, int B, cudaStream_t stream) {
  constexpr int kN = static_cast<int>(16 / sizeof(T));
  const bool vec = vector_ok<T, TC>(a);
  const int n = vec ? kN : 1;
  const int P = a.half / n;
  const int bx = P < kThreads ? P : kThreads;
  const int by = kThreads / bx;
  const long long tokens = static_cast<long long>(B) * a.S;
  const int nht = a.nh0 + a.nh1;
  // one block a token (the table row read once for all its heads), or, for
  // few tokens, one pass of the block's rows a block
  int hpb = tokens < kSplitTokens ? by : nht;
  if (hpb > nht) hpb = nht;
  a.heads_per_block = hpb;
  const dim3 grid(static_cast<unsigned>(tokens), static_cast<unsigned>((nht + hpb - 1) / hpb));
  const dim3 block(bx, by);
  if (vec)
    rope_kernel<T, TC, kN><<<grid, block, 0, stream>>>(a);
  else
    rope_kernel<T, TC, 1><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

// Makes CUDA device `device` current for a launch if it is not, and the
// previous one current again after it: the wrappers pass the index instead
// of entering a device context.
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

// The arguments of a launch, as the wrapper packs them: 24 int64s, the
// pointers as integers (one buffer through ctypes instead of 26 arguments:
// ~1 us of host a call instead of ~8).
struct RopeCall {
  long long x0, x1, y0, y1, cos, sin;
  long long xb0, xs0, xh0, xb1, xs1, xh1;
  long long cb, cs;
  long long B, S, h0, h1, D, half, layout, neg, dtype, table_dtype;
};
static_assert(sizeof(RopeCall) == 24 * sizeof(long long), "RopeCall is 24 int64s");

extern "C" {

// Rotate x0 ([B, S, h0 heads, D] by its strides xb0, xs0, xh0, in elements)
// and, when h1 > 0, x1 (h1 heads) in one launch, by the table rows cos, sin
// [.., half] at b * cb + s * cs (elements; half <= D / 2, even rd = 2 half
// rotated, the rest copied), into y0 and y1 written contiguous:
// layout 0 [B, heads, S, D], layout 1 [B, S, heads, D].  neg 1 rotates by
// -angle.  dtype (x and y): 0 = float32, 1 = bfloat16, 2 = float16;
// table_dtype: 0 (float32) or dtype.  Returns the launch's cudaError_t.
int ds_rope(const RopeCall* c, void* stream, int device) {
  const long long B = c->B, S = c->S, h0 = c->h0, h1 = c->h1, D = c->D, half = c->half;
  if (B <= 0 || S <= 0 || h0 + h1 <= 0 || D <= 0) return 0;
  if (h0 <= 0 || h1 < 0 || half <= 0 || 2 * half > D || h0 + h1 > 0x7fffffffLL ||
      D > 0x7fffffffLL || (c->layout != 0 && c->layout != 1) || B * S > 0x7fffffffLL ||
      (c->table_dtype != 0 && c->table_dtype != c->dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  RopeArgs a;
  a.x0 = reinterpret_cast<const void*>(c->x0);
  a.x1 = reinterpret_cast<const void*>(h1 ? c->x1 : c->x0);
  a.y0 = reinterpret_cast<void*>(c->y0);
  a.y1 = reinterpret_cast<void*>(h1 ? c->y1 : c->y0);
  // a stride of a dim of size 1 is never used: 0 keeps the vector test true
  a.xb0 = B > 1 ? c->xb0 : 0;
  a.xs0 = S > 1 ? c->xs0 : 0;
  a.xh0 = h0 > 1 ? c->xh0 : 0;
  a.xb1 = B > 1 && h1 ? c->xb1 : 0;
  a.xs1 = S > 1 && h1 ? c->xs1 : 0;
  a.xh1 = h1 > 1 ? c->xh1 : 0;
  for (int t = 0; t < 2; ++t) {
    const long long nh = t ? h1 : h0;
    long long yb, ys, yh;
    if (c->layout == 0) {
      yb = nh * S * D;
      yh = S * D;
      ys = D;
    } else {
      yb = S * nh * D;
      ys = nh * D;
      yh = D;
    }
    if (B == 1) yb = 0;
    if (S == 1) ys = 0;
    if (nh <= 1) yh = 0;
    if (t) {
      a.yb1 = yb;
      a.ys1 = ys;
      a.yh1 = yh;
    } else {
      a.yb0 = yb;
      a.ys0 = ys;
      a.yh0 = yh;
    }
  }
  a.cos = reinterpret_cast<const void*>(c->cos);
  a.sin = reinterpret_cast<const void*>(c->sin);
  a.cb = B > 1 ? c->cb : 0;
  a.cs = S > 1 ? c->cs : 0;
  a.S = static_cast<int>(S);
  a.D = static_cast<int>(D);
  a.half = static_cast<int>(half);
  a.nh0 = static_cast<int>(h0);
  a.nh1 = static_cast<int>(h1);
  a.heads_per_block = 0;
  a.neg = c->neg ? 1 : 0;
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B);
  const bool f32 = c->table_dtype == 0;
  switch (c->dtype) {
    case 0: return static_cast<int>(launch<float, float>(a, b, s));
    case 1:
      return static_cast<int>(f32 ? launch<__nv_bfloat16, float>(a, b, s)
                                  : launch<__nv_bfloat16, __nv_bfloat16>(a, b, s));
    case 2:
      return static_cast<int>(f32 ? launch<__half, float>(a, b, s)
                                  : launch<__half, __half>(a, b, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
