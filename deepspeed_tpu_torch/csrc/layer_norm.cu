// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/layer_norm.py `layer_norm` (kernel body
// `_ln_fwd_kernel`), `_layer_norm_bwd_vjp` (`_ln_bwd_kernel`), `rms_norm`
// (`_rms_fwd_kernel`) and `_rms_norm_bwd_vjp` (`_rms_bwd_kernel`).
//
//   RMSNorm:   y = x * rsqrt(mean(x^2, -1) + eps) * g
//   LayerNorm: y = (x - mean) * rsqrt(mean((x - mean)^2, -1) + eps) * g + b
//   (statistics in fp32, y in x's dtype)
//
// What bounds them on the H100: memory bytes.  Each row is read once and
// written once; a few fp32 operations per byte moved, far below the ~20
// operations per byte at which the fp32 vector units would become the
// limit.  On the serving path a call is one [rows, D] tensor with rows <= 64
// (prefill chunk) or num_slots (decode): under 1 MB, so a launch and the
// trips to memory it waits on cost more than the bytes do.  At the training
// rows ([8192, 1600], [8192, 2048]) the bytes are 52-67 MB: the rate of the
// stream is what counts.
//
// Design.  The Pallas kernel's row block becomes a warp (or a few warps) of
// the CUDA block; the TPU's lane-axis reduction becomes warp shuffles.  The
// forwards keep rows in 16-byte vectors in registers:
//   - the row kernels (layer_norm_fwd_row_kernel, rms_norm_fwd_row_kernel;
//     decode and prefill rows, RMSNorm's training rows, rows wider than a
//     warp): a block of warps a row, 2 vectors a thread.  x, g (and b) are
//     asked for together before any reduction, so a row waits on one trip
//     to memory, not two;
//   - layer_norm_fwd_stream_kernel (LayerNorm over more rows of up to 2048
//     16-bit elements than 8 an SM: training):
//     one wave of blocks of 8 warps, g and b staged once a block in shared
//     memory, each warp streaming rows r, r + W, ... with the next row's x
//     in flight, y stored with the streaming hint;
//   - the rest (rows that are no 16-byte vectors; LayerNorm rows past 2048,
//     RMSNorm rows past 16 warps' registers): one block of 256 threads a
//     row, reading the row again from L1/L2 for each pass.
// The backwards: dγ (and dβ) partials a block, summed by a second launch in
// a fixed order.  16-bit rows in 16-byte vectors stream through registers,
// one wave of blocks, the next row's x and dy in flight: LayerNorm's rows of
// up to 2048 elements a warp a row, RMSNorm's of up to 8192 a block of warps
// a row; the rest one block per row group, the partials in shared memory.
// Nothing is allocated here: the wrapper passes the output buffers, the
// stream and the device index (made current only where it is not).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// RMSNorm forward, one block of 256 threads a row, two passes over the row
// (the second from L1/L2): rows that are no 16-byte vectors (kVec false), or
// longer than the register kernels below hold.
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
// It serves fp32, rows that are not 16-byte vectors and rows longer than
// 8192; other 16-bit rows take rms_norm_bwd_row_kernel (below).
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

// out[c] = sum over blocks b (in order b = w, w + 8, ... per warp w, then
// the 8 warp sums in order) of part[b][c], cast to T: the partials' fixed-
// order sum.  32 columns a block at a time, striding over the grid.
template <typename T>
__device__ __forceinline__ void ordered_col_sum(const float* __restrict__ part,
                                                T* __restrict__ out, int nblk, int n) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c0 = blockIdx.x * 32; c0 < n; c0 += gridDim.x * 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    if (c < n)
      for (int b = warp; b < nblk; b += kWarps) acc += part[static_cast<size_t>(b) * n + c];
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && c < n) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += red[w][lane];
      out[c] = from_f32<T>(tot);
    }
    __syncthreads();
  }
}

// RMSNorm's dg from its [nblk, n] partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_dg_reduce_kernel(const float* __restrict__ part, T* __restrict__ dg, int nblk, int n) {
  ordered_col_sum(part, dg, nblk, n);
}

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------

constexpr int kWarpRowMax = 2048;     // longest 16-bit row one warp holds

// ---------------------------------------------------------------------------
// The forwards of rows in 16-byte vectors, held in registers
// ---------------------------------------------------------------------------

constexpr int kLaneVecs = 8;          // 16-byte vectors of a row a streaming lane holds
constexpr int kFwdWarps = 8;          // warps (rows in flight) a streaming block
constexpr int kRowVecs = 2;           // 16-byte vectors of a row a row-kernel thread holds
constexpr int kRowWarpsMax = 16;      // warps a row at most in the row kernels

// Sum of v over the block's warps, every thread gets it; the warps' sums are
// added in warp order, so a second call gives the same bits.  `k` picks one
// of two shared arrays: the two sums of a LayerNorm row need a barrier each.
__device__ __forceinline__ float group_sum(float v, int k) {
  __shared__ float part[2][kRowWarpsMax];
  v = warp_sum(v);
  const int nw = blockDim.x >> 5;
  if (nw == 1) return v;
  if ((threadIdx.x & 31) == 0) part[k][threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += part[k][w];
  return s;
}

// A row's statistics {mean, rstd} from the vectors a thread holds (slots i
// with c = t + span * i < nv): LayerNorm's mean and then the variance of the
// centred values, as `_ln_fwd_kernel` computes them (never E[x^2] - mean^2,
// which cancels in fp32 for rows with a large mean); RMSNorm's mean of
// squares (mean 0), as `_rms_fwd_kernel`.  `sum(v, k)` adds v over the
// threads that hold the row.
template <bool kLayer, typename P, int kV, typename Sum>
__device__ __forceinline__ float2 norm_stats(const P (&v)[kV], int t, int span, int nv, int n,
                                             float eps, Sum sum) {
  float mean = 0.f;
  if constexpr (kLayer) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (t + span * i < nv)
#pragma unroll
        for (int j = 0; j < P::N; ++j) s += to_f32(v[i].v[j]);
    mean = sum(s, 0) / static_cast<float>(n);
  }
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (t + span * i < nv)
#pragma unroll
      for (int j = 0; j < P::N; ++j) {
        const float d = kLayer ? to_f32(v[i].v[j]) - mean : to_f32(v[i].v[j]);
        sq += d * d;
      }
  return make_float2(mean, rsqrtf(sum(sq, 1) / static_cast<float>(n) + eps));
}

// One output vector: (x - mean) * rstd * g + b, or x * rstd * g, in fp32.
template <bool kLayer, typename T>
__device__ __forceinline__ Pack<T> norm_out(const Pack<T>& x, const Pack<T>& g, const Pack<T>& b,
                                            float2 st) {
  Pack<T> o;
#pragma unroll
  for (int j = 0; j < Pack<T>::N; ++j) {
    if constexpr (kLayer)
      o.v[j] = from_f32<T>((to_f32(x.v[j]) - st.x) * st.y * to_f32(g.v[j]) + to_f32(b.v[j]));
    else
      o.v[j] = from_f32<T>(to_f32(x.v[j]) * st.y * to_f32(g.v[j]));
  }
  return o;
}

// Stores a vector with the streaming hint (st.global.cs, evict first): y is
// not read again here, and the rows of x still to come should keep L2.
template <typename P>
__device__ __forceinline__ void store_streaming(P* dst, const P& v) {
  float4 w;
  __builtin_memcpy(&w, &v, sizeof(w));
  __stcs(reinterpret_cast<float4*>(dst), w);
}

// A few rows (decode, prefill) and rows wider than a warp: a block of
// G = blockDim.x / 32 warps a row of at most G * 32 * kRowVecs vectors.  Each
// thread asks for its vectors of x, g and b at once, so the row waits on one
// trip to memory; the statistics are warp shuffles and, for G > 1, one pass
// over the G warps' sums.  Few vectors a thread and many threads a row (256
// for a 4096-wide 16-bit row): a row's requests leave from many warps at
// once, and few registers let many rows be resident (generate's 1600-row
// prefill).  A warp a row with 8 vectors a lane, a block keeping its rows'
// g and b, and a block taking a second row were slower (ln_bwd_probe.py,
// PERF.md section 6).
template <typename T, bool kLayer>
__device__ __forceinline__ void norm_fwd_row(const T* __restrict__ x, const T* __restrict__ g,
                                             const T* __restrict__ b, T* __restrict__ y, int n,
                                             float eps) {
  using P = Pack<T>;
  const int t = threadIdx.x, span = blockDim.x, nv = n / P::N;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const P* xv = reinterpret_cast<const P*>(x + off);
  const P* gv = reinterpret_cast<const P*>(g);
  const P* bv = reinterpret_cast<const P*>(b);
  P px[kRowVecs], pg[kRowVecs], pb[kRowVecs];
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = t + span * i;
    if (c < nv) {
      px[i] = xv[c];
      pg[i] = gv[c];
      if constexpr (kLayer) pb[i] = bv[c];
    }
  }
  const float2 st = norm_stats<kLayer>(px, t, span, nv, n, eps,
                                       [](float v, int k) { return group_sum(v, k); });
  P* yv = reinterpret_cast<P*>(y + off);
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = t + span * i;
    if (c < nv) yv[c] = norm_out<kLayer, T>(px[i], pg[i], pb[i], st);
  }
}

// LayerNorm over many rows of at most a warp's width (training): one wave
// of blocks of kFwdWarps warps.  g and b are staged once a block in shared
// memory; each warp takes rows r, r + W, ... (W the grid's warps) and asks
// for the next row's x before it reduces the current one (registers as a
// double buffer); y goes out with the streaming hint.  At most 128
// registers, so that 2 blocks share an SM: at 148 (g copied to registers
// too) one block ran, 21.5 us at [8192, 1600] instead of 18.7.  Against the
// row
// kernel, which reads g and b again for every row (twice the row's bytes
// from L2), it gains ~4.8 us at [8192, 1600]; read from global memory in
// every row, g and b cost 1.3-3.1 us, and without the double buffer
// 3.9-6.7 us more.  RMSNorm, with its one scale row, streams faster
// through the row kernel (ln_bwd_probe.py, PERF.md section 6).
template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32, 2)
layer_norm_fwd_stream_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             const T* __restrict__ b, T* __restrict__ y, long long rows, int n,
                             float eps) {
  using P = Pack<T>;
  __shared__ P sg[32 * kLaneVecs], sb[32 * kLaneVecs];
  const int lane = threadIdx.x & 31, nv = n / P::N;
  const long long stride = static_cast<long long>(gridDim.x) * kFwdWarps;
  long long r = static_cast<long long>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  auto load = [&](long long row, P (&px)[kLaneVecs]) {
    const P* xv = reinterpret_cast<const P*>(x + row * n);
#pragma unroll
    for (int i = 0; i < kLaneVecs; ++i)
      if (lane + 32 * i < nv) px[i] = xv[lane + 32 * i];
  };
  P cx[kLaneVecs];
  if (r < rows) load(r, cx);                    // in flight while g and b are staged
  const P* gv = reinterpret_cast<const P*>(g);
  const P* bv = reinterpret_cast<const P*>(b);
  for (int c = threadIdx.x; c < nv; c += kFwdWarps * 32) {
    sg[c] = gv[c];
    sb[c] = bv[c];
  }
  __syncthreads();
  for (; r < rows; r += stride) {
    P nx[kLaneVecs];
    if (r + stride < rows) load(r + stride, nx);
    const float2 st = norm_stats<true>(cx, lane, 32, nv, n, eps,
                                       [](float v, int) { return warp_sum(v); });
    P* yv = reinterpret_cast<P*>(y + r * n);
#pragma unroll
    for (int i = 0; i < kLaneVecs; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        const P pb = sb[c];     // g read in place: a copy of both, 148 registers
        store_streaming(yv + c, norm_out<true, T>(cx[i], sg[c], pb, st));
      }
    }
#pragma unroll
    for (int i = 0; i < kLaneVecs; ++i) cx[i] = nx[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowWarpsMax * 32)
layer_norm_fwd_row_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ b, T* __restrict__ y, int n, float eps) {
  norm_fwd_row<T, true>(x, g, b, y, n, eps);
}

template <typename T>
__global__ void __launch_bounds__(kRowWarpsMax * 32)
rms_norm_fwd_row_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                        int n, float eps) {
  norm_fwd_row<T, false>(x, g, g, y, n, eps);
}

// LayerNorm forward, one block per row: any row length, any alignment.  Three
// passes over the row (mean, centred variance, output); the second and third
// read it from L1/L2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_block_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const T* __restrict__ b, T* __restrict__ y, int n, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * n;
  T* yr = y + static_cast<size_t>(blockIdx.x) * n;
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) sum += to_f32(xr[i]);
  const float mean = block_sum2(sum, 0.f).x / static_cast<float>(n);
  float sq = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d = to_f32(xr[i]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum2(sq, 0.f).x / static_cast<float>(n) + eps);
  for (int i = threadIdx.x; i < n; i += kThreads)
    yr[i] = from_f32<T>((to_f32(xr[i]) - mean) * rstd * to_f32(g[i]) + to_f32(b[i]));
}

// LayerNorm backward (replaces `_layer_norm_bwd_vjp` / `_ln_bwd_kernel`),
// statistics recomputed from x:
//   xc = x - mean, rstd = rsqrt(mean(xc^2) + eps), xhat = xc * rstd,
//   wdy = dy * g, c1 = mean(wdy), c2 = mean(wdy * xhat),
//   dx = (wdy - c1 - xhat * c2) * rstd,
//   dg = sum over rows of dy * xhat, db = sum over rows of dy.
// The Pallas kernel adds dg and db into one (1, n) block along its
// sequential grid.  Here, as in rms_norm_bwd_kernel, each block takes
// `rows_per_block` consecutive rows and keeps fp32 partials of dg and db for
// every column in shared memory (2n floats; a thread always owns the same
// columns), writes them to `part[blockIdx.x]` as [dg | db], and
// layer_norm_dgb_sum_kernel sums the partials of all 2n columns in a fixed
// order.  No float atomics: the same bits on every call.  Bound by bytes: x
// and dy are read (three times: the mean and sum(wdy), the centred sums, the
// outputs; the repeats mostly from L1/L2), dx written.  It serves fp32, rows
// longer than 2048 and rows that are not 16-byte vectors; 16-bit rows of up
// to 2048 elements take layer_norm_bwd_warp_kernel.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                      long long rows, int n, int rows_per_block, float eps) {
  extern __shared__ float sdg[];          // [dg partials | db partials]
  float* sdb = sdg + n;
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) sdg[i] = 0.f;
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(n);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * n;
    const T* dyr = dy + r * n;
    T* dxr = dx + r * n;
    float sx = 0.f, sw = 0.f;             // sum x, sum wdy
    if constexpr (kVec) {
      using P = Pack<T>;
      const P* xv = reinterpret_cast<const P*>(xr);
      const P* dv = reinterpret_cast<const P*>(dyr);
      const P* gv = reinterpret_cast<const P*>(g);
      for (int i = threadIdx.x; i < n / P::N; i += kThreads) {
        const P px = xv[i], pd = dv[i], pg = gv[i];
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          sx += to_f32(px.v[j]);
          sw += to_f32(pd.v[j]) * to_f32(pg.v[j]);
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        sx += to_f32(xr[i]);
        sw += to_f32(dyr[i]) * to_f32(g[i]);
      }
    }
    const float2 t1 = block_sum2(sx, sw);
    const float mean = t1.x * inv_n;
    const float c1 = t1.y * inv_n;
    float sq = 0.f, swx = 0.f;            // sum xc^2, sum wdy * xc
    if constexpr (kVec) {
      using P = Pack<T>;
      const P* xv = reinterpret_cast<const P*>(xr);
      const P* dv = reinterpret_cast<const P*>(dyr);
      const P* gv = reinterpret_cast<const P*>(g);
      for (int i = threadIdx.x; i < n / P::N; i += kThreads) {
        const P px = xv[i], pd = dv[i], pg = gv[i];
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          const float xc = to_f32(px.v[j]) - mean;
          sq += xc * xc;
          swx += to_f32(pd.v[j]) * to_f32(pg.v[j]) * xc;
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float xc = to_f32(xr[i]) - mean;
        sq += xc * xc;
        swx += to_f32(dyr[i]) * to_f32(g[i]) * xc;
      }
    }
    const float2 t2 = block_sum2(sq, swx);
    const float rstd = rsqrtf(t2.x * inv_n + eps);
    const float c2 = t2.y * rstd * inv_n;
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
          const float xhat = (to_f32(px.v[j]) - mean) * rstd;
          const float d = to_f32(pd.v[j]);
          out.v[j] = from_f32<T>((d * to_f32(pg.v[j]) - c1 - xhat * c2) * rstd);
          sdg[i * P::N + j] += d * xhat;
          sdb[i * P::N + j] += d;
        }
        ov[i] = out;
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float xhat = (to_f32(xr[i]) - mean) * rstd;
        const float d = to_f32(dyr[i]);
        dxr[i] = from_f32<T>((d * to_f32(g[i]) - c1 - xhat * c2) * rstd);
        sdg[i] += d * xhat;
        sdb[i] += d;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * n; i += kThreads)
    part[static_cast<size_t>(blockIdx.x) * 2 * n + i] = sdg[i];
}

// LayerNorm backward, one warp a row, for 16-bit rows of n <= 2048 elements
// in 16-byte vectors (gpt2-xl's [8192, 1600] and bloom-1b7's [8192, 2048]
// on their train paths), the formula of layer_norm_bwd_kernel.  What bounds
// it: bytes (x and dy read once, dx written once: 78.6 and 100.7 MB, 23.5
// and 30.1 us at 3.35 TB/s).  The block-per-row kernel paid latency instead:
// three passes over each row with two block-wide barriers between them.
// Here:
//   - a lane keeps its vectors of the row's x and dy (c = lane + 32 i, at
//     most 8 each) in registers in their 16-bit form, so each is read from
//     HBM once; the four sums (x, wdy, then xc^2 and wdy * xc) are warp
//     shuffles, with no block barrier per row;
//   - a warp streams rows r, r + W, ... (W the grid's warps: one wave of the
//     blocks the card holds), and asks for the next row's x and dy before it
//     reduces the current one (registers as a double buffer: one block of 8
//     warps an SM);
//   - gamma is staged in shared memory once a block: read from global
//     memory in each of a row's three passes, one vector at a time behind
//     the guard of a ragged row, it cost ~8 us a call (the rows streaming
//     through L1 likely evict it, so each read waits on L2);
//   - dg and db partials: each warp keeps its own slice of shared memory,
//     [dg | db][vector i][half][lane] as float4 (a warp's accesses are 16
//     consecutive bytes a lane: no bank conflicts), which only that warp
//     touches, so the rows need no barrier; at the end the block sums its
//     warps' slices in warp order into part[blockIdx.x] = [dg | db], and
//     layer_norm_dgb_sum_kernel sums the blocks' partials in a fixed order.
//     No float atomics: a second call gives the same bits.
// Staging gamma took the rows from ~1.9 to ~2.4 TB/s (torch.add over the
// same bytes: ~3); rows asked into L2 further ahead, x and dy loaded past
// L1, and 4 warps a block measured no faster, a third block of 4 warps an
// SM (168 registers) slower (ln_bwd_probe.py; PERF.md section 6).
constexpr int kBwdWarps = 8;          // rows in flight a block, one a warp

// Dynamic shared memory of a warp-path block for rows of n elements: the
// warps' dg and db slices, then gamma.
template <typename T>
size_t ln_bwd_warp_smem(int n) {
  const int kvl = (n / Pack<T>::N + 31) / 32;      // vectors a lane, at most
  return (static_cast<size_t>(kBwdWarps) * 2 * kvl * 64 + kvl * 32) * sizeof(float4);
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
layer_norm_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ part, long long rows, int n, float eps) {
  using P = Pack<T>;
  constexpr int kV = kWarpRowMax / 32 / P::N;   // vectors a lane at most
  extern __shared__ float4 slices[];            // [kBwdWarps][2][kvl][2][32], gamma
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = n / P::N;
  const int kvl = (nv + 31) / 32;
  const int per = 2 * kvl * 64;                 // float4s of a warp's slice
  float4* mine = slices + warp * per;
  for (int q = lane; q < per; q += 32) mine[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv_n = 1.f / static_cast<float>(n);
  const P* gv = reinterpret_cast<const P*>(g);
  P* gs = reinterpret_cast<P*>(slices + kBwdWarps * per);   // gamma, staged once
  for (int c = threadIdx.x; c < nv; c += kBwdWarps * 32) gs[c] = gv[c];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kBwdWarps;
  long long r = static_cast<long long>(blockIdx.x) * kBwdWarps + warp;
  auto load = [&](long long row, P (&px)[kV], P (&pd)[kV]) {
    const P* xv = reinterpret_cast<const P*>(x + row * n);
    const P* dv = reinterpret_cast<const P*>(dy + row * n);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        px[i] = xv[c];
        pd[i] = dv[c];
      }
    }
  };
  P cx[kV], cd[kV];
  if (r < rows) load(r, cx, cd);
  for (; r < rows; r += stride) {
    P nx[kV], nd[kV];
    if (r + stride < rows) load(r + stride, nx, nd);
    float sx = 0.f, sw = 0.f;                   // sum x, sum wdy
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        const P pg = gs[c];
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          sx += to_f32(cx[i].v[j]);
          sw += to_f32(cd[i].v[j]) * to_f32(pg.v[j]);
        }
      }
    }
    const float mean = warp_sum(sx) * inv_n;
    const float c1 = warp_sum(sw) * inv_n;
    float sq = 0.f, swx = 0.f;                  // sum xc^2, sum wdy * xc
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        const P pg = gs[c];
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          const float xc = to_f32(cx[i].v[j]) - mean;
          sq += xc * xc;
          swx += to_f32(cd[i].v[j]) * to_f32(pg.v[j]) * xc;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_n + eps);
    const float c2 = warp_sum(swx) * rstd * inv_n;
    P* ov = reinterpret_cast<P*>(dx + r * n);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        const P pg = gs[c];
        float pdg[P::N], pdb[P::N];
        P out;
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          const float xhat = (to_f32(cx[i].v[j]) - mean) * rstd;
          const float d = to_f32(cd[i].v[j]);
          out.v[j] = from_f32<T>((d * to_f32(pg.v[j]) - c1 - xhat * c2) * rstd);
          pdg[j] = d * xhat;
          pdb[j] = d;
        }
        ov[c] = out;
#pragma unroll
        for (int h = 0; h < P::N / 4; ++h) {
          float4* sg = mine + (i * 2 + h) * 32 + lane;
          float4* sb = sg + kvl * 64;
          float4 a = *sg, b = *sb;
          a.x += pdg[4 * h]; a.y += pdg[4 * h + 1]; a.z += pdg[4 * h + 2]; a.w += pdg[4 * h + 3];
          b.x += pdb[4 * h]; b.y += pdb[4 * h + 1]; b.z += pdb[4 * h + 2]; b.w += pdb[4 * h + 3];
          *sg = a;
          *sb = b;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      cx[i] = nx[i];
      cd[i] = nd[i];
    }
  }
  __syncthreads();
  // the block's partial: its warps' slices summed in warp order
  float* pb = part + static_cast<size_t>(blockIdx.x) * 2 * n;
  for (int q = threadIdx.x; q < per; q += kBwdWarps * 32) {
    float4 t = slices[q];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) {
      const float4 u = slices[w * per + q];
      t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
    }
    const int half = q / (kvl * 64), rem = q % (kvl * 64);   // [dg | db]
    const int c = (rem % 32) + 32 * (rem / 64);
    if (c < nv)
      *reinterpret_cast<float4*>(pb + half * n + c * P::N + ((rem / 32) % 2) * 4) = t;
  }
}

// LayerNorm's dg and db from its [nblk, 2n] partials (either kernel's).
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_dgb_sum_kernel(const float* __restrict__ part, T* __restrict__ dgb, int nblk, int n) {
  ordered_col_sum(part, dgb, nblk, n);
}

// ---------------------------------------------------------------------------
// RMSNorm backward, 16-bit rows in 16-byte vectors held in registers
// ---------------------------------------------------------------------------
//
// The formula of rms_norm_bwd_kernel: one pair of row sums (x^2 and
// wdy * x), then dx and the row's dg terms.  What bounds it: bytes (x and dy
// read once, dx written once: 100.7 MB at [8192, 2048], 201.3 MB at
// [8192, 4096]; 30.1 and 60.1 us at 3.35 TB/s).  The block kernel paid
// latency instead: each block walked its rows one after another, each row a
// block-wide reduction with its barriers, x, dy and g read twice and a
// shared-memory read-modify-write of dg for every element, with nothing of
// the next row in flight.  rms_norm_bwd_row_kernel takes every such row of
// up to 8192 elements (llama-1b4's 2048, mixtral-8x7b's and llama3-8b's
// 4096, mixtral-tiny's 256): one wave of the blocks the card holds, a block
// of warps a row (2 vectors a thread, as the forward's row kernel), rows
// r, r + grid, ..., the next row's x and dy in flight; the two sums one
// reduction over the block's warps in warp order, one barrier a row (the
// warps' sums alternate between two shared arrays by the row's parity); a
// thread always owns the same columns, so it keeps gamma and its dg partial
// in registers and writes the partial once, to part[blockIdx.x].
// rms_dg_reduce_kernel sums the blocks' partials in a fixed order.  No float atomics: a second call gives the
// same bits.

template <typename T>
__global__ void __launch_bounds__(kRowWarpsMax * 32)
rms_norm_bwd_row_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, long long rows, int n, float eps) {
  using P = Pack<T>;
  __shared__ float2 wsum[2][kRowWarpsMax];      // the warps' two sums, by row parity
  const int t = threadIdx.x, span = blockDim.x, nv = n / P::N;
  const int lane = t & 31, warp = t >> 5, nw = span >> 5;
  const float inv_n = 1.f / static_cast<float>(n);
  const P* gsrc = reinterpret_cast<const P*>(g);
  P pg[kRowVecs];
  float acc[kRowVecs][P::N];                    // this thread's columns of dg
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    if (t + span * i < nv) pg[i] = gsrc[t + span * i];
#pragma unroll
    for (int j = 0; j < P::N; ++j) acc[i][j] = 0.f;
  }
  auto fetch = [&](long long rr, P (&xa)[kRowVecs], P (&da)[kRowVecs]) {
    const P* xs = reinterpret_cast<const P*>(x + rr * n);
    const P* ds = reinterpret_cast<const P*>(dy + rr * n);
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i)
      if (t + span * i < nv) {
        xa[i] = xs[t + span * i];
        da[i] = ds[t + span * i];
      }
  };
  long long row = blockIdx.x;
  P x0[kRowVecs], d0[kRowVecs];
  if (row < rows) fetch(row, x0, d0);
  for (int parity = 0; row < rows; row += gridDim.x, parity ^= 1) {
    P x1[kRowVecs], d1[kRowVecs];
    if (row + gridDim.x < rows) fetch(row + gridDim.x, x1, d1);
    float ss = 0.f, sw = 0.f;                   // sum x^2, sum wdy * x
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i)
      if (t + span * i < nv)
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          const float f = to_f32(x0[i].v[j]);
          ss += f * f;
          sw += to_f32(d0[i].v[j]) * to_f32(pg[i].v[j]) * f;
        }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sw += __shfl_xor_sync(0xffffffffu, sw, off);
    }
    if (lane == 0) wsum[parity][warp] = make_float2(ss, sw);
    __syncthreads();
    ss = 0.f;
    sw = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float2 s = wsum[parity][w];
      ss += s.x;
      sw += s.y;
    }
    const float rstd = rsqrtf(ss * inv_n + eps);
    const float c2 = sw * rstd * inv_n;
    P* dst = reinterpret_cast<P*>(dx + row * n);
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int c = t + span * i;
      if (c < nv) {
        P o;
#pragma unroll
        for (int j = 0; j < P::N; ++j) {
          const float xh = to_f32(x0[i].v[j]) * rstd;
          const float d = to_f32(d0[i].v[j]);
          o.v[j] = from_f32<T>((d * to_f32(pg[i].v[j]) - xh * c2) * rstd);
          acc[i][j] += d * xh;
        }
        dst[c] = o;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      x0[i] = x1[i];
      d0[i] = d1[i];
    }
  }
  float* pb = part + static_cast<size_t>(blockIdx.x) * n;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = t + span * i;
    if (c < nv)
#pragma unroll
      for (int h = 0; h < P::N / 4; ++h)
        *reinterpret_cast<float4*>(pb + c * P::N + 4 * h) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

// A block's default limit is 48 KB of static plus dynamic shared memory; a
// kernel that asks for more dynamic shared memory opts in first (the static
// reduction scratch comes on top of the dynamic partials).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem + 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// True when rows of n elements at these pointers can be read and written as
// 16-byte vectors.
template <typename T>
bool aligned16(const void* a, const void* b, const void* c, const void* d, int n) {
  return n % Pack<T>::N == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16) == 0;
}

// The SMs of CUDA device `dev`, asked once a device.
cudaError_t sm_count(int dev, int* sms) {
  static int cache[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

// Warps a row of the row kernels: 32 * kRowVecs vectors each.
template <typename T>
unsigned row_threads(int n) {
  return 32 * ((n / Pack<T>::N + 32 * kRowVecs - 1) / (32 * kRowVecs));
}

// LayerNorm forward: rows of up to 2048 elements in 16-byte vectors in
// registers (more rows of at most a warp's width than one block of
// kFwdWarps an SM has warps: the streaming kernel, one wave of the blocks
// an SM holds, asked once; fewer: the row kernel), the rest one block of
// 256 threads a row.
template <typename T>
cudaError_t launch_ln_fwd(const void* x, const void* g, const void* b, void* y, long long rows,
                          int n, float eps, cudaStream_t stream, int dev) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* bt = static_cast<const T*>(b);
  const unsigned grid = static_cast<unsigned>(rows);
  if (n > kWarpRowMax || !aligned16<T>(x, g, b, y, n)) {
    layer_norm_fwd_block_kernel<T><<<grid, kThreads, 0, stream>>>(xt, gt, bt, static_cast<T*>(y),
                                                                  n, eps);
    return cudaGetLastError();
  }
  int sms = 0;
  cudaError_t e = sm_count(dev, &sms);
  if (e != cudaSuccess) return e;
  if (n / Pack<T>::N <= 32 * kLaneVecs && rows > static_cast<long long>(sms) * kFwdWarps) {
    static int per_sm = 0;
    if (per_sm == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_norm_fwd_stream_kernel<T>,
                                                        kFwdWarps * 32, 0);
      if (e != cudaSuccess) return e;
      if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    }
    const long long want = (rows + kFwdWarps - 1) / kFwdWarps;
    layer_norm_fwd_stream_kernel<T>
        <<<static_cast<unsigned>(std::min<long long>(want, sms * per_sm)), kFwdWarps * 32, 0,
           stream>>>(xt, gt, bt, static_cast<T*>(y), rows, n, eps);
  } else {
    layer_norm_fwd_row_kernel<T><<<grid, row_threads<T>(n), 0, stream>>>(
        xt, gt, bt, static_cast<T*>(y), n, eps);
  }
  return cudaGetLastError();
}

// RMSNorm forward: rows in 16-byte vectors that a block of kRowWarpsMax
// warps holds in registers (8192 16-bit or 4096 fp32 elements) take the row
// kernel, the rest one block of 256 threads a row.
template <typename T>
cudaError_t launch_rms_fwd(const void* x, const void* g, void* y, long long rows, int n,
                           float eps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (!aligned16<T>(x, g, y, y, n))
    rms_norm_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, gt, static_cast<T*>(y), n, eps);
  else if (n / Pack<T>::N <= kRowWarpsMax * 32 * kRowVecs)
    rms_norm_fwd_row_kernel<T><<<grid, row_threads<T>(n), 0, stream>>>(xt, gt, static_cast<T*>(y),
                                                                       n, eps);
  else
    rms_norm_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, gt, static_cast<T*>(y), n, eps);
  return cudaGetLastError();
}

// Blocks of layer_norm_bwd_warp_kernel<T> an SM holds at rows of n
// elements (0 on an error), asked once for each vector count a lane.  The
// kernel is opted in to the slices of the longest row, so that a row of
// another width never lowers the limit a cached count relies on.
template <typename T>
int ln_bwd_warp_resident(int n) {
  static int cache[kWarpRowMax / 32 / Pack<T>::N + 1];
  const int kvl = (n / Pack<T>::N + 31) / 32;
  if (cache[kvl] == 0) {
    int nb = 0;
    if (allow_smem(layer_norm_bwd_warp_kernel<T>, ln_bwd_warp_smem<T>(kWarpRowMax)) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, layer_norm_bwd_warp_kernel<T>,
                                                      kBwdWarps * 32,
                                                      ln_bwd_warp_smem<T>(n)) == cudaSuccess)
      cache[kvl] = nb;
  }
  return cache[kvl];
}

template <typename T>
cudaError_t launch_ln_bwd(const void* x, const void* g, const void* dy, void* dx, void* dgb,
                          float* part, long long rows, int n, int nblk, float eps,
                          cudaStream_t stream, int dev) {
  cudaError_t e;
  bool warp_path = false;
  if constexpr (!std::is_same<T, float>::value) {
    if (n <= kWarpRowMax && aligned16<T>(x, g, dy, dx, n)) {
      // one wave of warp-path blocks, each streaming rows, at most nblk partials
      const int per_sm = ln_bwd_warp_resident<T>(n);
      if (per_sm <= 0) return cudaErrorInvalidConfiguration;
      int sms = 0;
      e = sm_count(dev, &sms);
      if (e != cudaSuccess) return e;
      const long long want = (rows + kBwdWarps - 1) / kBwdWarps;
      nblk = static_cast<int>(std::min<long long>(std::min(nblk, sms * per_sm), want));
      layer_norm_bwd_warp_kernel<T><<<nblk, kBwdWarps * 32, ln_bwd_warp_smem<T>(n), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(dy),
          static_cast<T*>(dx), part, rows, n, eps);
      warp_path = true;
    }
  }
  if (!warp_path) {
    const int rpb = static_cast<int>((rows + nblk - 1) / nblk);
    const size_t smem = static_cast<size_t>(2 * n) * sizeof(float);
    if (aligned16<T>(x, g, dy, dx, n)) {
      e = allow_smem(layer_norm_bwd_kernel<T, true>, smem);
      if (e != cudaSuccess) return e;
      layer_norm_bwd_kernel<T, true><<<nblk, kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(dy),
          static_cast<T*>(dx), part, rows, n, rpb, eps);
    } else {
      e = allow_smem(layer_norm_bwd_kernel<T, false>, smem);
      if (e != cudaSuccess) return e;
      layer_norm_bwd_kernel<T, false><<<nblk, kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(dy),
          static_cast<T*>(dx), part, rows, n, rpb, eps);
    }
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // dg and db are the two halves of one [2, n] buffer: one ordered sum
  layer_norm_dgb_sum_kernel<T><<<(2 * n + 31) / 32, kThreads, 0, stream>>>(
      part, static_cast<T*>(dgb), nblk, 2 * n);
  return cudaGetLastError();
}

// Blocks of rms_norm_bwd_row_kernel<T> of `threads` threads an SM holds (0 on
// an error), asked once for each block size.
template <typename T>
int rms_bwd_row_resident(unsigned threads) {
  static int cache[kRowWarpsMax + 1];
  const int nw = static_cast<int>(threads / 32);
  if (cache[nw] == 0) {
    int nb = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, rms_norm_bwd_row_kernel<T>,
                                                      static_cast<int>(threads), 0) ==
        cudaSuccess)
      cache[nw] = nb;
  }
  return cache[nw];
}

// RMSNorm backward: 16-bit rows in 16-byte vectors of up to 8192 elements
// take the row kernel, one wave of at most nblk blocks; the
// rest (fp32, rows that are no 16-byte vectors, rows past 8192) the block
// kernel over nblk blocks.  Then the partials' ordered sum.
template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg,
                       float* part, long long rows, int n, int nblk, float eps,
                       cudaStream_t stream, int dev) {
  const bool vec = aligned16<T>(x, g, dy, dx, n);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  cudaError_t e;
  bool streamed = false;
  if constexpr (!std::is_same<T, float>::value) {
    if (vec && n / Pack<T>::N <= kRowWarpsMax * 32 * kRowVecs) {
      int sms = 0;
      e = sm_count(dev, &sms);
      if (e != cudaSuccess) return e;
      const unsigned threads = row_threads<T>(n);
      const int per_sm = rms_bwd_row_resident<T>(threads);
      if (per_sm <= 0) return cudaErrorInvalidConfiguration;
      nblk = static_cast<int>(std::min<long long>(std::min(nblk, sms * per_sm), rows));
      rms_norm_bwd_row_kernel<T><<<nblk, threads, 0, stream>>>(xt, gt, dyt, dxt, part, rows, n,
                                                                eps);
      streamed = true;
    }
  }
  if (!streamed) {
    const int rpb = static_cast<int>((rows + nblk - 1) / nblk);
    const size_t smem = static_cast<size_t>(n) * sizeof(float);
    e = vec ? allow_smem(rms_norm_bwd_kernel<T, true>, smem)
            : allow_smem(rms_norm_bwd_kernel<T, false>, smem);
    if (e != cudaSuccess) return e;
    if (vec)
      rms_norm_bwd_kernel<T, true><<<nblk, kThreads, smem, stream>>>(xt, gt, dyt, dxt, part,
                                                                     rows, n, rpb, eps);
    else
      rms_norm_bwd_kernel<T, false><<<nblk, kThreads, smem, stream>>>(xt, gt, dyt, dxt, part,
                                                                      rows, n, rpb, eps);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_dg_reduce_kernel<T><<<(n + 31) / 32, kThreads, 0, stream>>>(part, static_cast<T*>(dg), nblk, n);
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

extern "C" {

// Every entry takes the CUDA device of its tensors, `device`, made current for
// the launch only if it is not already, and returns the cudaError_t of its
// launches (0 on success).  dtype: 0 = float32, 1 = bfloat16, 2 = float16.

// RMSNorm forward: x, y [rows, n] contiguous; g [n]; all of one dtype.
int ds_rms_norm_fwd(const void* x, const void* g, void* y, long long rows, int n,
                    float eps, int dtype, void* stream, int device) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_rms_fwd<float>(x, g, y, rows, n, eps, s));
    case 1: return static_cast<int>(launch_rms_fwd<__nv_bfloat16>(x, g, y, rows, n, eps, s));
    case 2: return static_cast<int>(launch_rms_fwd<__half>(x, g, y, rows, n, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// RMSNorm backward: x, dy, dx [rows, n], g and dg [n], one dtype; part is
// float32 scratch [nblk, n] for the per-block dg partials (nblk <= rows).
// 16-bit rows of up to 8192 elements in 16-byte vectors take the row
// kernel, one wave of at most nblk blocks; the rest the block kernel,
// which keeps n * 4 bytes of shared memory per block, so n <= 12288.  Two
// launches (partials, then their fixed-order sum); none for no row (the
// wrapper passes a zeroed dg).
int ds_rms_norm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg, void* part,
                    long long rows, int n, int nblk, float eps, int dtype, void* stream,
                    int device) {
  if (rows <= 0 || n <= 0) return 0;
  if (nblk <= 0 || nblk > rows || n > 12288) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_bwd<float>(x, g, dy, dx, dg, p, rows, n, nblk, eps, s, device));
    case 1:
      return static_cast<int>(
          launch_bwd<__nv_bfloat16>(x, g, dy, dx, dg, p, rows, n, nblk, eps, s, device));
    case 2:
      return static_cast<int>(
          launch_bwd<__half>(x, g, dy, dx, dg, p, rows, n, nblk, eps, s, device));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// LayerNorm forward: x, y [rows, n] contiguous; g, b [n]; one dtype.
int ds_layer_norm_fwd(const void* x, const void* g, const void* b, void* y, long long rows,
                      int n, float eps, int dtype, void* stream, int device) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_ln_fwd<float>(x, g, b, y, rows, n, eps, s, device));
    case 1:
      return static_cast<int>(launch_ln_fwd<__nv_bfloat16>(x, g, b, y, rows, n, eps, s, device));
    case 2: return static_cast<int>(launch_ln_fwd<__half>(x, g, b, y, rows, n, eps, s, device));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// LayerNorm backward: x, dy, dx [rows, n]; g [n]; dgb [2, n] receives dg then
// db; one dtype; part is float32 scratch [nblk, 2n] for the per-block
// partials (nblk <= rows; the block-per-row kernel keeps 8n bytes of shared
// memory per block, so n <= 6144; 16-bit rows of up to 2048 elements in
// 16-byte vectors take the warp-per-row kernel, one wave of at most nblk
// blocks).  Two launches (partials, then their fixed-order sum); none for no
// row (the wrapper passes a zeroed dgb).
int ds_layer_norm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dgb,
                      void* part, long long rows, int n, int nblk, float eps, int dtype,
                      void* stream, int device) {
  if (rows <= 0 || n <= 0) return 0;
  if (nblk <= 0 || nblk > rows || n > 6144) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_ln_bwd<float>(x, g, dy, dx, dgb, p, rows, n, nblk, eps, s, device));
    case 1:
      return static_cast<int>(
          launch_ln_bwd<__nv_bfloat16>(x, g, dy, dx, dgb, p, rows, n, nblk, eps, s, device));
    case 2:
      return static_cast<int>(
          launch_ln_bwd<__half>(x, g, dy, dx, dgb, p, rows, n, nblk, eps, s, device));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
