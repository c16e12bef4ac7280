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
// What bounds them on the H100: memory bytes.  Each row is read once for the
// statistics and once more for the scale (the second read hits L1/L2, or the
// row stays in registers), the output is written once; a few fp32
// operations per byte moved, far below the ~20 operations per byte at which
// the fp32 vector units would become the limit.  On the serving path a call
// is one [rows, D] tensor with rows <= 64 (prefill chunk) or num_slots
// (decode): under 1 MB, so a launch costs more than the bytes do.
//
// Design: one thread block per row (the Pallas kernel's row block becomes
// the CUDA block; the TPU's lane-axis reduction becomes a warp-shuffle
// reduction followed by one pass over per-warp partials in shared memory);
// the LayerNorm forward, and its backward in 16 bits, give a row of up to
// 2048 elements to one warp, which keeps it in registers.  Rows are read with 16-byte vector loads when
// the row length and the pointers allow it, else element by element.
// Nothing is allocated here: the wrapper passes the output buffer and the
// stream.

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

constexpr int kRowWarps = 4;          // rows (one per warp) per block
constexpr int kWarpRowMax = 2048;     // longest row one warp keeps in registers

// LayerNorm forward, one warp per row of n <= 2048 elements (n a multiple of
// the 16-byte vector, pointers 16-byte aligned).  The row is loaded once
// into registers as fp32 (64 values per lane; lanes past the row's end hold
// nothing: n = 1600 is 200 vectors of 8 bf16, 6.25 per lane) and the two
// statistics are two passes over those registers, the mean first and then
// the variance of the centred values, as `_ln_fwd_kernel` computes them
// (not E[x^2] - mean^2, which cancels in fp32 for rows with a large mean).
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
layer_norm_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const T* __restrict__ b, T* __restrict__ y, long long rows, int n,
                           float eps) {
  using P = Pack<T>;
  constexpr int kV = kWarpRowMax / 32 / P::N;   // vectors per lane
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                      // the whole warp leaves together
  const int nv = n / P::N;
  const P* xv = reinterpret_cast<const P*>(x + row * n);
  float v[kV][P::N];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      const P p = xv[c];
#pragma unroll
      for (int j = 0; j < P::N; ++j) {
        v[i][j] = to_f32(p.v[j]);
        sum += v[i][j];
      }
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(n);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int j = 0; j < P::N; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(n) + eps);
  const P* gv = reinterpret_cast<const P*>(g);
  const P* bv = reinterpret_cast<const P*>(b);
  P* yv = reinterpret_cast<P*>(y + row * n);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      const P pg = gv[c], pb = bv[c];
      P out;
#pragma unroll
      for (int j = 0; j < P::N; ++j)
        out.v[j] = from_f32<T>(v[i][j] * rstd * to_f32(pg.v[j]) + to_f32(pb.v[j]));
      yv[c] = out;
    }
  }
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

template <typename T>
cudaError_t launch_ln_fwd(const void* x, const void* g, const void* b, void* y, long long rows,
                          int n, float eps, cudaStream_t stream) {
  if (n <= kWarpRowMax && aligned16<T>(x, g, b, y, n)) {
    const unsigned grid = static_cast<unsigned>((rows + kRowWarps - 1) / kRowWarps);
    layer_norm_fwd_warp_kernel<T><<<grid, kRowWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
        static_cast<T*>(y), rows, n, eps);
  } else {
    layer_norm_fwd_block_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
        static_cast<T*>(y), n, eps);
  }
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
                          cudaStream_t stream) {
  cudaError_t e;
  bool warp_path = false;
  if constexpr (!std::is_same<T, float>::value) {
    if (n <= kWarpRowMax && aligned16<T>(x, g, dy, dx, n)) {
      // one wave of warp-path blocks, each streaming rows, at most nblk partials
      const int per_sm = ln_bwd_warp_resident<T>(n);
      if (per_sm <= 0) return cudaErrorInvalidConfiguration;
      int dev = 0, sms = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg,
                       float* part, long long rows, int n, int nblk, float eps,
                       cudaStream_t stream) {
  const int rpb = static_cast<int>((rows + nblk - 1) / nblk);
  const bool vec = aligned16<T>(x, g, dy, dx, n);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t ok = vec ? allow_smem(rms_norm_bwd_kernel<T, true>, smem)
                       : allow_smem(rms_norm_bwd_kernel<T, false>, smem);
  if (ok != cudaSuccess) return ok;
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
  const bool vec = aligned16<T>(x, g, y, y, n);
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
// (0 = float32, 1 = bfloat16, 2 = float16), on CUDA device `device`, which
// is made current for the launch only if it is not already (the wrapper
// passes the index instead of entering a device context).  Returns the
// cudaError_t of the launch (0 on success).
int ds_rms_norm_fwd(const void* x, const void* g, void* y, long long rows, int n,
                    float eps, int dtype, void* stream, int device) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, g, y, rows, n, eps, s); break;
    case 1: launch<__nv_bfloat16>(x, g, y, rows, n, eps, s); break;
    case 2: launch<__half>(x, g, y, rows, n, eps, s); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
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

// LayerNorm forward: x, y [rows, n] contiguous; g, b [n]; one dtype.
int ds_layer_norm_fwd(const void* x, const void* g, const void* b, void* y, long long rows,
                      int n, float eps, int dtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_ln_fwd<float>(x, g, b, y, rows, n, eps, s));
    case 1: return static_cast<int>(launch_ln_fwd<__nv_bfloat16>(x, g, b, y, rows, n, eps, s));
    case 2: return static_cast<int>(launch_ln_fwd<__half>(x, g, b, y, rows, n, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// LayerNorm backward: x, dy, dx [rows, n]; g [n]; dgb [2, n] receives dg then
// db; one dtype; part is float32 scratch [nblk, 2n] for the per-block
// partials (nblk <= rows; the block-per-row kernel keeps 8n bytes of shared
// memory per block, so n <= 6144; 16-bit rows of up to 2048 elements in
// 16-byte vectors take the warp-per-row kernel, one wave of at most nblk
// blocks).  Two launches (partials, then their fixed-order sum).
int ds_layer_norm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dgb,
                      void* part, long long rows, int n, int nblk, float eps, int dtype,
                      void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (nblk <= 0 || nblk > rows || n > 6144) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0: return static_cast<int>(launch_ln_bwd<float>(x, g, dy, dx, dgb, p, rows, n, nblk, eps, s));
    case 1:
      return static_cast<int>(
          launch_ln_bwd<__nv_bfloat16>(x, g, dy, dx, dgb, p, rows, n, nblk, eps, s));
    case 2: return static_cast<int>(launch_ln_bwd<__half>(x, g, dy, dx, dgb, p, rows, n, nblk, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
