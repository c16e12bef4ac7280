// Fused per-layer decode kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/decode.py that the
// serving engine's default (kernel-injected) decode step launches per layer:
//
//   fused_norm_qkv      (decode.py:123, pallas_call :147) -> norm_qkv_mma_kernel
//                          (bf16, fp16), norm_qkv_kernel (fp32)
//   _flash_decode_paged (decode.py:252, pallas_call :311) -> flash_decode_kernel
//   fused_proj_norm     (decode.py:433, pallas_call :460) -> proj_norm_mma_kernel
//                          (bf16, fp16), proj_norm_kernel (fp32)
//   fused_mlp           (decode.py:546, pallas_call :591) -> mlp_act_mma_kernel
//                          + mlp_down_mma_kernel (bf16, fp16), mlp_act_kernel
//                          + mlp_down_kernel (fp32)
//   flash_decode        (decode.py:319, pallas_call :390) -> flash_decode_kernel
//     over a contiguous [L, B, Hkv, Smax, Dh] cache (generate()), through
//     its own entry, ds_flash_decode_contig
//
// and the int8-weight bodies of the three GEMV kernels (their `quant=True`
// branch, `_deq` decode.py:88), each through its own entry (the `_int8`
// functions below): norm_qkv_int8_mma_kernel and proj_norm_int8_mma_kernel
// on the tensor-core core, and for fused_mlp two kernels of their own on the
// tensor cores, mlp_act_int8_mma_kernel + mlp_down_int8_mma_kernel.
//
// What bounds them on the H100: memory bytes.  A decode step multiplies
// num_slots (8) activation rows by each weight matrix: about 8 flops per
// weight byte against the ~295 at which the bf16 tensor cores would become
// the limit.  At llama3-8b the three GEMV kernels stream 50.3 MB (QKV),
// 33.6 MB (out-projection) and 352.3 MB (MLP) of weights per layer, bounds
// of 15.0, 10.0 and 105.2 us at 3.35 TB/s; the attention kernel reads the
// K/V rows up to each slot's depth (9.8 MB for 8 slots at depth 300).  With
// int8 weights the GEMVs read half the bytes: 25.2, 16.8 and 176.2 MB, bounds
// of 7.5, 5.0 and 52.6 us.
//
// Design of the FFMA GEMV kernels (fp32 norm_qkv, proj_norm and MLP; one
// shared core, gemv_partial + reduce_tile): the
// grid splits the output columns into tiles of kCV 16-byte vectors; each
// block streams its [K, tile] slice of the weight once
// with 16-byte loads, its threads splitting the contraction K into
// interleaved row groups, each thread loading kUnroll weight rows before it
// multiplies any and keeping kBT x 8 fp32 accumulators (FFMA: no tensor
// cores, so an fp32 model computes in full fp32, never TF32).  The kernels
// are memory-latency bound, so warps in flight count most: at most 128
// registers a thread and 16 warps per SM: two 256-thread blocks per SM
// where the grid has more blocks than SMs, else one 512-thread block (a
// register double buffer measured slower on the H100: it took 156-161
// registers and halved the warps per SM).  The row
// groups' partials are summed in a fixed order (warp shuffles, then shared
// memory): no float atomics, the same bits on every run.  Blocks run in any
// order, so nothing carries from block to block as the Pallas grid carries
// its scratch:
//   - norm_qkv stages x (L2-resident) into shared memory in every block,
//     16 bytes at a time, and normalises it there in place (one warp per
//     row), rounded to the activation dtype as the jnp reference rounds it;
//   - proj_norm needs whole rows of the fp32 sum resid + ctx @ wo, which span
//     every block: each block writes its columns to an fp32 scratch, takes a
//     ticket after a __threadfence, and the last block normalises all rows
//     (16-byte reads) and resets the ticket;
//   - the MLP is two launches: mlp_act writes a = act(h @ Wg) * (h @ Wu),
//     rounded to the activation dtype as the reference rounds it, as [F, B]
//     (so the down projection reads a row's B values as 16-byte vectors),
//     and mlp_down computes r + a @ Wd over output-column tiles.
//
// bf16 and fp16 norm_qkv, proj_norm and the MLP, and the int8 norm_qkv and
// proj_norm, take the products to the tensor cores (mma.sync over weight
// tiles the TMA streams into a ring): their design note is above G16Cfg.
//
// int8 weights (bf16 activations only, as the JAX int8 engine serves).
// Each element is dequantized as the reference's `_deq` does it: code x
// scale in fp32, rounded to bf16, then the product with the bf16 activation
// summed in fp32.  Every int8 body takes the products to the tensor cores
// (mma.sync m16n8k16 over the dequantized bf16 codes and the pass's 8 rows)
// and dequantizes with a byte permute and two fp32 operations an element,
// so the stream of codes sets their time.  (An FFMA body, which spent an
// I2F, the scale, a round to bf16 and back and kBT FFMAs on each element,
// was bound by issue at 7.7x its bound: PERF.md section 6.)  norm_qkv and
// proj_norm are the tensor-core core's (the note above G16Cfg); the MLP's
// design note is above mlp_act_int8_mma_kernel.
//
// Design of flash_decode_kernel (both caches).  Bound by bytes: each K/V
// row up to a slot's depth is read once; at llama3-8b's GQA group of 4 that
// is ~4 flops a byte, so CUDA cores in fp32 serve (q, k, v widened, as the
// reference's fp32 dot_general).  What the kernel does about the bytes:
//   - Each (slot, KV head) row's keys are cut into chunks of 16 to 128 keys
//     (16 KB of K rows: 64 keys at Dh 128 in bf16) and the chunks split over
//     `splits` blocks of 256 threads (grid (B * Hkv, splits)), as many as
//     fill one wave of the blocks the card holds (the runtime's occupancy
//     times the SMs); the host sizes the grid from a bound on the depth (the
//     scalar depth itself, or Smax, or maxp * page), reading nothing back,
//     so the launch stays capturable.  A block reads its row's depth, takes
//     whole chunks, ceil(chunks / splits) of them, and returns at once where
//     its share starts past the depth: keys past a row's depth are neither
//     read nor computed.
//   - Its chunks come into shared memory by bulk copies (the TMA, one a run
//     of rows within a page: a contiguous chunk is one copy), K and V each
//     completing on an mbarrier: the chunk's scores run while its V is in
//     flight, its P.V while the next chunk's K is.  The paged pool's
//     page-table entries for a chunk come by 8-byte cp.async into one of two
//     slots of `chunk` entries, so shared memory grows with neither Smax nor
//     maxp; the contiguous cache is a pool whose page is Smax and whose page
//     of row b is b.  (A second stage of K/V, a chunk ahead, and 16-byte
//     cp.async by every thread measured no faster: PERF.md, section 6.)
//   - Scores: threads own keys (256 / chunk threads a key split Dh and meet
//     in 1-4 shuffles), each 16-byte K vector widened once for every query
//     head of the GQA group.  The chunk's online softmax: a warp a head.
//     P.V: a thread owns two head-dim columns of every head over every n-th
//     key, the key groups summed in group order.
//   - The splits' fp32 (acc, m, l) go to scratch; the last of a row's live
//     splits to take its ticket (the GEMVs' tickets, left at 0) merges them
//     in split order, in one pass with every split's loads in flight.  No
//     float atomics: a repeat gives the same bits.  A row with no key (pos
//     < 0) gives zeros, as l == 0 does in the Pallas kernel.  Rows beyond
//     the tickets (4096 a launch) run in passes.
// The layer's slice is addressed in place (the wrapper offsets the stacked
// pointer): no copy, no gather.  The position is a per-row [B] vector, or
// one scalar for the whole batch (generate()'s loop: no position tensor is
// built per token).  Any Smax >= 1 and page >= 1.

// Nothing is allocated here: the wrappers pass outputs, scratch, the
// tickets and the stream.  Every entry point returns the cudaError_t of its
// launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)

namespace {

// GEMV blocks are NT threads, a template parameter chosen per launch from the
// grid (narrow_blocks below): at most 128 registers a thread either way, so
// 16 warps stay resident per SM.  NT / kCV row groups split the contraction.
constexpr int kThreadsWide = 512;
constexpr int kThreadsNarrow = 256;
constexpr int kBT = 8;                  // batch rows per pass
constexpr int kCV = 4;                  // 16-byte column vectors per block tile
constexpr int kUnroll = 4;              // weight rows in flight per thread
constexpr int kSmemDefault = 48 * 1024;
constexpr float kNegInf = -1e30f;       // decode.py NEG_INF
static_assert(kThreadsNarrow / 32 >= kBT, "one warp per batch row for the row statistics");
static_assert(kBT % 8 == 0, "a pass's activations fill whole 16-byte vectors");

constexpr int kFdThreads = 256;         // flash decode: threads a block
constexpr int kFdChunkBytes = 16384;    // a chunk's K rows, at most
constexpr int kFdMaxSplits = 256;       // blocks a row

enum NormKind { kRms = 0, kLayer = 1 };
enum Act { kSilu = 0, kGelu = 1, kGeluExact = 2, kRelu = 3 };

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

// 16 bytes of T, loaded as one vector.
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

__device__ __forceinline__ float act_fn(int act, float x) {
  switch (act) {
    case kSilu:
      return x / (1.f + expf(-x));
    case kGelu:  // tanh approximation (jax.nn.gelu(approximate=True))
      return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case kGeluExact:
      return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
    default:
      return fmaxf(x, 0.f);
  }
}

// Statistics of one row, computed by one warp; every lane gets them.
// rmsnorm: mean 0, rstd = rsqrt(mean(x^2) + eps).  layernorm: the mean
// first, then the centred variance, as decode.py `_normalize` computes them.
template <class Src>
__device__ __forceinline__ void warp_row_stats(Src src, int n, int kind, float eps,
                                               float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  mean = 0.f;
  if (kind == kLayer) {
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s += src(i);
    mean = warp_sum(s) / static_cast<float>(n);
  }
  float ss = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float c = src(i) - mean;
    ss += c * c;
  }
  rstd = rsqrtf(warp_sum(ss) / static_cast<float>(n) + eps);
}

__device__ __forceinline__ float normalize(float v, float mean, float rstd, float scale,
                                           float bias, int kind) {
  const float y = (v - mean) * rstd * scale;
  return kind == kLayer ? y + bias : y;
}

// Copy n elements of global rows into shared memory with all threads,
// 16 bytes at a time when the source allows it.
template <typename T, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int n) {
  using P = Pack<T>;
  if (n % P::N == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const P* s = reinterpret_cast<const P*>(src);
    P* d = reinterpret_cast<P*>(dst);
    for (int i = threadIdx.x; i < n / P::N; i += NT) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
  }
}

// One thread's share of its block's column tile: rows d = rs, rs + kRS, ...
// of Wm [K, N] at the 16-byte vector of V columns starting at `col`, times
// the pass's activations of each row (act_row(d, a) fills a[0..kBT), zero
// past the pass's rows), summed in fp32.  The main loop loads kUnroll weight
// rows, unconditionally, before it multiplies any.
template <typename T, int NT, class ActRow>
__device__ __forceinline__ void gemv_partial(const T* __restrict__ Wm, int K, int N, int col,
                                             bool col_ok, int rs, ActRow act_row,
                                             float (&acc)[kBT][Pack<T>::N]) {
  constexpr int V = Pack<T>::N;
  using P = Pack<T>;
#pragma unroll
  for (int b = 0; b < kBT; ++b)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[b][j] = 0.f;
  if (!col_ok) return;
  constexpr int kRS = NT / kCV;
  const T* wp = Wm + col;
  auto fma_row = [&](const P& w, int d) {
    float a[kBT];
    act_row(d, a);
#pragma unroll
    for (int b = 0; b < kBT; ++b)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[b][j] = fmaf(a[b], to_f32(w.v[j]), acc[b][j]);
  };
  int d = rs;
  for (; d + (kUnroll - 1) * kRS < K; d += kUnroll * kRS) {
    P w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      w[u] = *reinterpret_cast<const P*>(wp + static_cast<size_t>(d + u * kRS) * N);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fma_row(w[u], d + u * kRS);
  }
  for (; d < K; d += kRS)
    fma_row(*reinterpret_cast<const P*>(wp + static_cast<size_t>(d) * N), d);
}

// act_row over activations staged row-major in shared memory, [kBT, K].
template <typename T>
struct StagedRows {
  const T* s;
  int K, bc;
  __device__ __forceinline__ void operator()(int d, float (&a)[kBT]) const {
#pragma unroll
    for (int b = 0; b < kBT; ++b) a[b] = b < bc ? to_f32(s[b * K + d]) : 0.f;
  }
};

// Sum the row groups' partials of the block tile in a fixed order and hand
// each output (b, c) of the tile (kBT rows x kCV * V columns) to epi(b, c, y).
// `red` holds NT / 32 * kCV * kBT * V floats.  Ends with a barrier, so the
// caller may reuse its shared buffers afterwards.
template <typename T, int NT, class Epi>
__device__ __forceinline__ void reduce_tile(float (&acc)[kBT][Pack<T>::N], float* red, int bc,
                                            Epi epi) {
  constexpr int V = Pack<T>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lanes kCV apart hold the same columns for different rows: fold them
#pragma unroll
  for (int b = 0; b < kBT; ++b)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = acc[b][j];
#pragma unroll
      for (int off = kCV; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[b][j] = v;
    }
  if (lane < kCV) {
#pragma unroll
    for (int b = 0; b < kBT; ++b)
#pragma unroll
      for (int j = 0; j < V; ++j) red[((warp * kCV + lane) * kBT + b) * V + j] = acc[b][j];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kBT * kCV * V; o += NT) {
    const int b = o / (kCV * V);
    const int c = o % (kCV * V);
    const int cv = c / V, j = c % V;
    if (b < bc) {
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) y += red[((w * kCV + cv) * kBT + b) * V + j];
      epi(b, c, y);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// fused_norm_qkv: out[B, N] = (norm(x)[B, D] rounded to T) @ W[D, N] (+ bqkv)
// ---------------------------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
norm_qkv_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ bias, const T* __restrict__ w,
                const T* __restrict__ bqkv, T* __restrict__ out, int B, int D, int N,
                int kind, float eps) {
  constexpr int V = Pack<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h = reinterpret_cast<T*>(smem_raw);  // [kBT, D]
  __shared__ float red[NT / 32 * kCV * kBT * V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * kCV * V;
  const int col = tile0 + (threadIdx.x % kCV) * V;
  const int rs = threadIdx.x / kCV;
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int bc = min(kBT, B - b0);
    stage_rows<T, NT>(h, x + static_cast<size_t>(b0) * D, bc * D);
    __syncthreads();
    if (warp < bc) {  // normalise row `warp` in place
      T* row = h + warp * D;
      float mean, rstd;
      warp_row_stats([&](int i) { return to_f32(row[i]); }, D, kind, eps, mean, rstd);
      for (int i = lane; i < D; i += 32)
        row[i] = from_f32<T>(normalize(to_f32(row[i]), mean, rstd, to_f32(scale[i]),
                                       bias ? to_f32(bias[i]) : 0.f, kind));
    }
    __syncthreads();
    float acc[kBT][V];
    gemv_partial<T, NT>(w, D, N, col, col < N, rs, StagedRows<T>{h, D, bc}, acc);
    reduce_tile<T, NT>(acc, red, bc, [&](int b, int c, float y) {
      const int n = tile0 + c;
      if (n < N) {
        if (bqkv) y += to_f32(bqkv[n]);
        out[static_cast<size_t>(b0 + b) * N + n] = from_f32<T>(y);
      }
    });
  }
}

// ---------------------------------------------------------------------------
// fused_proj_norm: r = resid + ctx @ wo (+ bo); h = norm(r in fp32 | resid)
// ---------------------------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
proj_norm_kernel(const T* __restrict__ ctx, const T* __restrict__ resid,
                 const T* __restrict__ wo, const T* __restrict__ bo,
                 const T* __restrict__ scale, const T* __restrict__ bias,
                 T* __restrict__ r_out, T* __restrict__ h_out, float* __restrict__ r32,
                 unsigned int* __restrict__ ticket, int B, int M, int D, int kind, float eps,
                 int parallel) {
  constexpr int V = Pack<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_s = reinterpret_cast<T*>(smem_raw);  // [kBT, M]
  __shared__ float red[NT / 32 * kCV * kBT * V];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * kCV * V;
  const int col = tile0 + (threadIdx.x % kCV) * V;
  const int rs = threadIdx.x / kCV;
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int bc = min(kBT, B - b0);
    stage_rows<T, NT>(c_s, ctx + static_cast<size_t>(b0) * M, bc * M);
    __syncthreads();
    float acc[kBT][V];
    gemv_partial<T, NT>(wo, M, D, col, col < D, rs, StagedRows<T>{c_s, M, bc}, acc);
    reduce_tile<T, NT>(acc, red, bc, [&](int b, int c, float y) {
      const int n = tile0 + c;
      if (n < D) {
        if (bo) y += to_f32(bo[n]);
        const size_t i = static_cast<size_t>(b0 + b) * D + n;
        const float r = to_f32(resid[i]) + y;
        r_out[i] = from_f32<T>(r);
        r32[i] = r;
      }
    });
  }
  // The norm reads whole rows of r32, and every block wrote a slice of each:
  // the last block to take a ticket normalises all rows.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // One warp per row; each lane takes 4 consecutive columns at a time (D is
  // a multiple of 4: the wrapper checks it), r32 read 16 bytes at a time
  // with __ldcg, through L2, never from a stale L1 line.
  for (int b = warp; b < B; b += NT / 32) {
    const size_t row = static_cast<size_t>(b) * D;
    auto load4 = [&](int i, float (&v)[4]) {
      if (parallel) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = to_f32(resid[row + i + k]);
      } else {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(r32 + row + i));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
    };
    float mean = 0.f, v[4];
    if (kind == kLayer) {
      float sum = 0.f;
      for (int i = lane * 4; i < D; i += 128) {
        load4(i, v);
        sum += (v[0] + v[1]) + (v[2] + v[3]);
      }
      mean = warp_sum(sum) / static_cast<float>(D);
    }
    float ss = 0.f;
    for (int i = lane * 4; i < D; i += 128) {
      load4(i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) ss += (v[k] - mean) * (v[k] - mean);
    }
    const float rstd = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
    for (int i = lane * 4; i < D; i += 128) {
      load4(i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h_out[row + i + k] = from_f32<T>(normalize(v[k], mean, rstd, to_f32(scale[i + k]),
                                                   bias ? to_f32(bias[i + k]) : 0.f, kind));
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch on this stream
}

// ---------------------------------------------------------------------------
// fused_mlp, launch (a): a_t[F, B] = act(h @ Wg (+bg)) * (h @ Wu (+bu)), or
// act(h @ Wu (+bu)) without a gate, rounded to T
// ---------------------------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
mlp_act_kernel(const T* __restrict__ h, const T* __restrict__ wu, const T* __restrict__ wg,
               const T* __restrict__ bu, const T* __restrict__ bg, T* __restrict__ a_t,
               int B, int D, int F, int act) {
  constexpr int V = Pack<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h_s = reinterpret_cast<T*>(smem_raw);  // [kBT, D]
  __shared__ float red[NT / 32 * kCV * kBT * V];
  __shared__ float up_s[kBT * kCV * V];
  const int tile0 = blockIdx.x * kCV * V;
  const int col = tile0 + (threadIdx.x % kCV) * V;
  const int rs = threadIdx.x / kCV;
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int bc = min(kBT, B - b0);
    stage_rows<T, NT>(h_s, h + static_cast<size_t>(b0) * D, bc * D);
    __syncthreads();
    const StagedRows<T> hval{h_s, D, bc};
    float acc[kBT][V];
    gemv_partial<T, NT>(wu, D, F, col, col < F, rs, hval, acc);
    reduce_tile<T, NT>(acc, red, bc, [&](int b, int c, float y) {
      const int n = tile0 + c;
      if (n < F) {
        if (bu) y += to_f32(bu[n]);
        if (wg)
          up_s[b * kCV * V + c] = y;
        else
          a_t[static_cast<size_t>(n) * B + b0 + b] = from_f32<T>(act_fn(act, y));
      }
    });
    if (wg) {
      gemv_partial<T, NT>(wg, D, F, col, col < F, rs, hval, acc);
      reduce_tile<T, NT>(acc, red, bc, [&](int b, int c, float g) {
        const int n = tile0 + c;
        if (n < F) {
          if (bg) g += to_f32(bg[n]);
          a_t[static_cast<size_t>(n) * B + b0 + b] =
              from_f32<T>(act_fn(act, g) * up_s[b * kCV * V + c]);
        }
      });
    }
  }
}

// ---------------------------------------------------------------------------
// fused_mlp, launch (b): out[B, D] = r + (a @ Wd (+ bd)), a read as a_t[F, B]
// ---------------------------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
mlp_down_kernel(const T* __restrict__ a_t, const T* __restrict__ wd, const T* __restrict__ bd,
                const T* __restrict__ r, T* __restrict__ out, int B, int F, int D) {
  constexpr int V = Pack<T>::N;
  __shared__ float red[NT / 32 * kCV * kBT * V];
  const int tile0 = blockIdx.x * kCV * V;
  const int col = tile0 + (threadIdx.x % kCV) * V;
  const int rs = threadIdx.x / kCV;
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int bc = min(kBT, B - b0);
    // a_t row d holds the B activations of contraction row d: with B ==
    // kBT they are kBT * sizeof(T) / 16 aligned 16-byte vectors
    auto act_row = [&](int d, float (&a)[kBT]) {
      const T* p = a_t + static_cast<size_t>(d) * B + b0;
      if (B == kBT) {
#pragma unroll
        for (int q = 0; q < kBT / V; ++q) {
          const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(p + q * V);
#pragma unroll
          for (int j = 0; j < V; ++j) a[q * V + j] = to_f32(pk.v[j]);
        }
      } else {
#pragma unroll
        for (int b = 0; b < kBT; ++b) a[b] = b < bc ? to_f32(p[b]) : 0.f;
      }
    };
    float acc[kBT][V];
    gemv_partial<T, NT>(wd, F, D, col, col < D, rs, act_row, acc);
    reduce_tile<T, NT>(acc, red, bc, [&](int b, int c, float y) {
      const int n = tile0 + c;
      if (n < D) {
        if (bd) y += to_f32(bd[n]);
        const size_t i = static_cast<size_t>(b0 + b) * D + n;
        out[i] = from_f32<T>(to_f32(r[i]) + y);
      }
    });
  }
}

// ---------------------------------------------------------------------------
// fused_mlp with int8 weights, on the tensor cores (mma.sync m16n8k16, bf16)
// ---------------------------------------------------------------------------
//
// Two launches a pass of kBT rows, as the FFMA bodies: mlp_act_int8_mma_kernel
// writes a = act(h @ deq(Wg) (+bg)) * (h @ deq(Wu) (+bu)), or act(h @ deq(Wu)
// (+bu)) without a gate, rounded to bf16 as [kBT, F] rows; then
// mlp_down_int8_mma_kernel writes r + (a @ deq(Wd) (+bd)).  A block owns a
// tile of kQ8TN output columns over one split of the contraction.
//
//   - The product: A = 16 dequantized output columns x 16 contraction rows,
//     B = the pass's 8 activation rows (n = 8 exactly), fp32 sums.  A's
//     k-pairs run down the row-major [K, N] codes: ldmatrix.trans of the
//     staged tile, read as 16-bit column pairs, gives a thread the codes of
//     rows 2t, 2t+1 in two adjacent columns (four bytes); the even column
//     feeds one m16 tile and the odd column the next, so one x4 load feeds
//     two mma over a 32-column strip.
//   - The dequant is `_deq`'s, bit for bit: byte ^ 0x80 permuted into the
//     low byte of 2^23 and 2^23 + 128 subtracted (the exact int8 -> fp32,
//     no I2F), times the column's fp32 scale (__fmul_rn), rounded to bf16
//     two at a time (__floats2bfloat162_rn, round to nearest even).
//   - The bytes: 16-byte cp.async (8-byte where N is not a multiple of 16)
//     into a ring of kQ8Stages stages of kQ8TK rows, with the pass's
//     activations for those rows beside them (zero filled past the pass's
//     rows and past K), the 16-byte chunks of a code row swizzled so that
//     ldmatrix reads without bank conflicts.
//   - The grid: one block an SM, 16 warps (4 a strip, each taking 2 of a
//     stage's 8 k16 steps; their sums meet in shared memory in warp order).
//     Block b takes column tile b % tiles, so the blocks that run together
//     read the same rows of the codes: the order the H100's memory streams
//     best (a stream-K split, which fills every SM but spreads the blocks
//     over the rows, ran slower).  Where the column tiles are fewer than
//     the SMs (the down projection: 32 at llama3-8b), the contraction is
//     split into runs of chunks: each split writes fp32 partials, and the
//     last block of a tile to take its ticket sums them in split order,
//     finishes the tile and resets the ticket.  No float atomics: every
//     call gives the same bits.
//   - Measured on the H100 (PERF.md §6): compute is not the limit (taking
//     out the dequant and the mma saved about a tenth); the act launch runs
//     a few us behind a bare cp.async read of the same tiles in the same
//     order.

constexpr int kQ8Threads = 512;                          // 16 warps
constexpr int kQ8Warps = kQ8Threads / 32;
constexpr int kQ8TN = 128;                               // output columns of a tile
constexpr int kQ8TK = 128;                               // contraction rows of a stage
constexpr int kQ8Stages = 4;
constexpr int kQ8Strips = kQ8TN / 32;                    // 32-column strips of a tile
constexpr int kQ8WarpsAStrip = kQ8Warps / kQ8Strips;
constexpr int kQ8Steps = kQ8TK / 16 / kQ8WarpsAStrip;    // k16 steps a warp a stage
constexpr int kQ8XStride = kQ8TK + 8;                    // bf16 a staged activation row
constexpr int kQ8CodeBytes = kQ8TK * kQ8TN;              // one matrix's codes a stage
constexpr int kQ8XBytes = kBT * kQ8XStride * 2;
constexpr int kQ8MaxTiles = 4096;                        // tickets the wrapper provides
static_assert(kQ8Warps % kQ8Strips == 0 && kQ8Steps * kQ8WarpsAStrip * 16 == kQ8TK &&
                  kQ8TN == 128,
              "every (strip, k16 step) of a stage has one warp; a code row is a 128-byte line");

__host__ __device__ constexpr int q8_stage_bytes(int nm) { return nm * kQ8CodeBytes + kQ8XBytes; }

// Chunk c of code row r lands at chunk c ^ (r & 7) of its shared row: the 8
// rows an ldmatrix reads at one chunk fall on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int q8_swizzle(int r, int c) { return c ^ (r & 7); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [k0, k0 + kQ8TK) x columns [n0, n0 + kQ8TN) of the [K, N] codes into the
// stage at `dst`, swizzled; rows past K and columns past N zero filled (N is
// a multiple of the chunk).
template <bool kWide>
__device__ __forceinline__ void q8_load_codes(uint32_t dst, const int8_t* __restrict__ w, int K,
                                              int N, int k0, int n0) {
  constexpr int kChunk = kWide ? 16 : 8;
  constexpr int kPerRow = kQ8TN / kChunk;
  static_assert(kQ8TK * kPerRow % kQ8Threads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kQ8TK * kPerRow / kQ8Threads; ++it) {
    const int i = threadIdx.x + it * kQ8Threads;
    const int r = i / kPerRow, byte = (i % kPerRow) * kChunk;
    const bool in = k0 + r < K && n0 + byte < N;
    const int8_t* src = in ? w + static_cast<size_t>(k0 + r) * N + n0 + byte : w;
    const uint32_t d = dst + r * kQ8TN + (q8_swizzle(r, byte >> 4) << 4) + (byte & 15);
    if (kWide)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(in ? 16 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                   "r"(in ? 8 : 0));
  }
}

// The pass's activations for rows [k0, k0 + kQ8TK): x [bc, K], ldx apart
// (16-byte aligned rows, K a multiple of 8), as kBT rows of kQ8XStride.
__device__ __forceinline__ void q8_load_x(uint32_t dst, const __nv_bfloat16* __restrict__ x,
                                          int ldx, int bc, int K, int k0) {
  constexpr int kPerRow = kQ8TK / 8;
  for (int i = threadIdx.x; i < kBT * kPerRow; i += kQ8Threads) {
    const int n = i / kPerRow, k = k0 + (i % kPerRow) * 8;
    const bool in = n < bc && k < K;
    const __nv_bfloat16* src = in ? x + static_cast<size_t>(n) * ldx + k : x;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + (n * kQ8XStride + (i % kPerRow) * 8) * 2),
                 "l"(src), "r"(in ? 16 : 0));
  }
}

// Four codes (rows 2t, 2t+1 x an even and an odd column) -> the bf16 pairs
// of the even and the odd column, each code x its column's scale as `_deq`.
__device__ __forceinline__ void q8_deq(uint32_t r, float se, float so, uint32_t& e, uint32_t& o) {
  const uint32_t u = r ^ 0x80808080u;
  auto f = [&](uint32_t sel) {
    return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel)), 8388736.f);
  };
  const __nv_bfloat162 pe = __floats2bfloat162_rn(__fmul_rn(f(0x7440), se), __fmul_rn(f(0x7442), se));
  const __nv_bfloat162 po = __floats2bfloat162_rn(__fmul_rn(f(0x7441), so), __fmul_rn(f(0x7443), so));
  e = *reinterpret_cast<const uint32_t*>(&pe);
  o = *reinterpret_cast<const uint32_t*>(&po);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block's tile: columns [n0, n0 + kQ8TN) of NM weight matrices w[m] ([K, N]
// codes, scales s[m]) against one pass of activations x over contraction
// chunks [c0, c1).  Returns the fp32 sums, [NM][kBT][kQ8TN], in shared memory
// (in the ring, past the warps' partials); ends with a barrier.
template <int NM, bool kWide>
__device__ __forceinline__ float* q8_tile(const int8_t* const* w, const float* const* s,
                                          const __nv_bfloat16* __restrict__ x, int ldx, int bc,
                                          int K, int N, int n0, int c0, int c1,
                                          unsigned char* ring) {
  constexpr int kStage = q8_stage_bytes(NM);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % kQ8Strips;
  // the thread's four columns: even and odd of the strip's first and second half
  float sc[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + strip * 32 + (q >> 1) * 16 + 2 * g + (q & 1);
      sc[m][q] = col < N ? s[m][col] : 0.f;
    }
  const uint32_t base = smem_u32(ring);
  auto load = [&](int c, int slot) {
    const uint32_t st = base + slot * kStage;
#pragma unroll
    for (int m = 0; m < NM; ++m)
      q8_load_codes<kWide>(st + m * kQ8CodeBytes, w[m], K, N, c * kQ8TK, n0);
    q8_load_x(st + NM * kQ8CodeBytes, x, ldx, bc, K, c * kQ8TK);
  };
  const int n = c1 - c0;
#pragma unroll
  for (int p = 0; p < kQ8Stages - 1; ++p) {
    if (p < n) load(c0 + p, p);
    cp_async_commit();
  }
  float acc[NM][2][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][e][q] = 0.f;
  // ldmatrix: lane gives row (lane & 7) of matrix lane >> 3: rows +0 / +8 of
  // the k16 step (bit 1), the strip's first / second 16 bytes (bit 0)
  const int lrow = ((lane >> 4) & 1) * 8 + (lane & 7);
  const int lc16 = 2 * strip + ((lane >> 3) & 1);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kQ8Stages - 2>();
    __syncthreads();
    if (i + kQ8Stages - 1 < n) load(c0 + i + kQ8Stages - 1, (i + kQ8Stages - 1) % kQ8Stages);
    cp_async_commit();
    const uint32_t st = base + (i % kQ8Stages) * kStage;
#pragma unroll
    for (int jj = 0; jj < kQ8Steps; ++jj) {
      const int k16 = warp / kQ8Strips + kQ8WarpsAStrip * jj;
      uint32_t b0, b1;
      const uint32_t xa = st + NM * kQ8CodeBytes + (g * kQ8XStride + k16 * 16 + 2 * t) * 2;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b0) : "r"(xa));
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b1) : "r"(xa + 16));
      const int row = k16 * 16 + lrow;
      const uint32_t off = row * kQ8TN + (q8_swizzle(row, lc16) << 4);
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        uint32_t r[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(st + m * kQ8CodeBytes + off));
        // r[0], r[1]: rows 2t, 2t+1 of the strip's halves; r[2], r[3]: rows +8
        uint32_t ae[4], ao[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          q8_deq(r[q], sc[m][(q & 1) * 2], sc[m][(q & 1) * 2 + 1], ae[q], ao[q]);
        mma_16816(acc[m][0], ae, b0, b1);
        mma_16816(acc[m][1], ao, b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // C fragment q of the even (e = 0) or odd tile: row 2t + (q & 1), column
  // (q >> 1) * 16 + 2g + e of the strip
  float* red = reinterpret_cast<float*>(ring);  // [NM][warps][kBT][32]
  float* sums = red + NM * kQ8Warps * kBT * 32;
  static_assert(NM * (kQ8Warps * 32 + kQ8TN) * kBT <= kQ8Stages * q8_stage_bytes(NM) / 4,
                "the partials and the sums fit in the ring");
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nn = 2 * t + (q & 1), cc = (q >> 1) * 16 + 2 * g + e;
        red[((m * kQ8Warps + warp) * kBT + nn) * 32 + cc] = acc[m][e][q];
      }
  __syncthreads();
  // the warps of a strip summed in warp order
  for (int o = threadIdx.x; o < NM * kBT * kQ8TN; o += kQ8Threads) {
    const int m = o / (kBT * kQ8TN), nn = (o / kQ8TN) % kBT, c = o % kQ8TN;
    float v = 0.f;
#pragma unroll
    for (int w = c / 32; w < kQ8Warps; w += kQ8Strips)
      v += red[((m * kQ8Warps + w) * kBT + nn) * 32 + c % 32];
    sums[o] = v;
  }
  __syncthreads();
  return sums;
}

// The grid: block b takes column tile b % tiles over contraction chunks
// [b / tiles * cps, ...): the blocks that run together read the same rows
// (the lockstep the H100's memory streams best), and the contraction is
// split only as far as it takes to give every SM a block.
struct Q8Grid {
  int tiles, chunks, cps, splits;
};

// A split tile: write this block's sums as the fp32 partial of its split;
// the last block of the tile to take its ticket reads every split's partial
// back into `sums`, summed in split order, resets the ticket and returns
// true.  Other blocks return false.
template <int NM>
__device__ __forceinline__ bool q8_merge(const Q8Grid& gr, int tile, int split, float* sums,
                                         float* __restrict__ part,
                                         unsigned int* __restrict__ ticket) {
  constexpr int kTile = NM * kBT * kQ8TN;
  __shared__ bool last;
  float* tp = part + static_cast<size_t>(tile) * gr.splits * kTile;
  for (int o = threadIdx.x; o < kTile; o += kQ8Threads) tp[split * kTile + o] = sums[o];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket + tile, 1u) == static_cast<unsigned>(gr.splits - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int o = threadIdx.x; o < kTile; o += kQ8Threads) {
    float v = 0.f;
    for (int j = 0; j < gr.splits; ++j) v += __ldcg(tp + j * kTile + o);
    sums[o] = v;
  }
  if (threadIdx.x == 0) ticket[tile] = 0u;  // ready for the next launch on this stream
  __syncthreads();
  return true;
}

// This block's tile and split; the tile's sums if the block is to finish
// it, else null.
template <int NM, bool kWide>
__device__ __forceinline__ float* q8_block(const Q8Grid& gr, const int8_t* const* w,
                                           const float* const* s,
                                           const __nv_bfloat16* __restrict__ x, int ldx, int bc,
                                           int K, int N, float* __restrict__ part,
                                           unsigned int* __restrict__ ticket, unsigned char* ring) {
  const int tile = blockIdx.x % gr.tiles, split = blockIdx.x / gr.tiles;
  const int c0 = split * gr.cps, c1 = min(gr.chunks, c0 + gr.cps);
  float* sums = q8_tile<NM, kWide>(w, s, x, ldx, bc, K, N, tile * kQ8TN, c0, c1, ring);
  if (gr.splits > 1 && !q8_merge<NM>(gr, tile, split, sums, part, ticket)) return nullptr;
  return sums;
}

// launch (a): the [D, F] products; NM = 2 with a gate.
template <int NM, bool kWide>
__global__ void __launch_bounds__(kQ8Threads, 1)
mlp_act_int8_mma_kernel(Q8Grid gr, const __nv_bfloat16* __restrict__ h,
                        const int8_t* __restrict__ wu, const int8_t* __restrict__ wg,
                        const float* __restrict__ su, const float* __restrict__ sg,
                        const __nv_bfloat16* __restrict__ bu, const __nv_bfloat16* __restrict__ bg,
                        __nv_bfloat16* __restrict__ a, float* __restrict__ part,
                        unsigned int* __restrict__ ticket, int bc, int D, int F, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int8_t* const w[2] = {wu, wg};
  const float* const s[2] = {su, sg};
  const float* sums = q8_block<NM, kWide>(gr, w, s, h, D, bc, D, F, part, ticket, smem_raw);
  if (sums == nullptr) return;
  const int n0 = blockIdx.x % gr.tiles * kQ8TN;
  for (int o = threadIdx.x; o < kBT * kQ8TN; o += kQ8Threads) {
    const int nn = o / kQ8TN, col = n0 + o % kQ8TN;
    if (nn < bc && col < F) {
      float y = sums[o];
      if (bu) y += __bfloat162float(bu[col]);
      float v;
      if constexpr (NM == 2) {
        float gv = sums[kBT * kQ8TN + o];
        if (bg) gv += __bfloat162float(bg[col]);
        v = act_fn(act, gv) * y;
      } else {
        v = act_fn(act, y);
      }
      a[static_cast<size_t>(nn) * F + col] = __float2bfloat16(v);
    }
  }
}

// launch (b): the [F, D] product, plus the bias and the residual.
template <bool kWide>
__global__ void __launch_bounds__(kQ8Threads, 1)
mlp_down_int8_mma_kernel(Q8Grid gr, const __nv_bfloat16* __restrict__ a,
                         const int8_t* __restrict__ wd, const float* __restrict__ sd,
                         const __nv_bfloat16* __restrict__ bd, const __nv_bfloat16* __restrict__ r,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                         unsigned int* __restrict__ ticket, int bc, int F, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int8_t* const w[1] = {wd};
  const float* const s[1] = {sd};
  const float* sums = q8_block<1, kWide>(gr, w, s, a, F, bc, F, D, part, ticket, smem_raw);
  if (sums == nullptr) return;
  const int n0 = blockIdx.x % gr.tiles * kQ8TN;
  for (int o = threadIdx.x; o < kBT * kQ8TN; o += kQ8Threads) {
    const int nn = o / kQ8TN, col = n0 + o % kQ8TN;
    if (nn < bc && col < D) {
      float y = sums[o];
      if (bd) y += __bfloat162float(bd[col]);
      const size_t i = static_cast<size_t>(nn) * D + col;
      out[i] = __float2bfloat16(__bfloat162float(r[i]) + y);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core GEMV core (mma.sync m16n8k16, fp32 sums): fused_norm_qkv
// and fused_proj_norm in bf16, fp16 and over int8 codes, and fused_mlp in
// bf16 and fp16
// ---------------------------------------------------------------------------
//
// One body, g16_body, four kinds of launch, each a pass of kBT rows:
//   kQkv   norm_qkv_mma_kernel<T> (T = bf16, fp16) and, over int8 codes,
//          norm_qkv_int8_mma_kernel: (norm(x) rounded to T) @ W (+ bqkv);
//   kProj  proj_norm_mma_kernel<T> and, over int8 codes,
//          proj_norm_int8_mma_kernel: r = resid + ctx @ wo (+ bo) and h =
//          norm(r in fp32 | resid);
//   kAct   mlp_act_mma_kernel<T>: a = act(h @ Wg (+ bg)) * (h @ Wu (+ bu)), or
//          act(h @ Wu (+ bu)) without a gate, rounded to T as [kBT, F] rows;
//   kDown  mlp_down_mma_kernel<T>: out = r + (a @ Wd (+ bd)).
// Every kind is bound by its weight's bytes: 8 rows make about 8 flops a
// weight byte, against the ~295 at which the tensor cores would bind.
//
//   - The bytes: a block owns tiles of kNB 128-byte boxes of each weight row
//     (64 columns of a 16-bit weight, 128 of int8 codes, a box) and streams
//     them through a ring of stages of kTK rows.  The TMA copies each
//     [kTK rows, 128 bytes] box (cp.async.bulk.tensor, one thread asks, the
//     stage's mbarrier completes on its bytes) with the 128-byte swizzle:
//     chunk c of row r lands at c ^ (r & 7), q8_swizzle's layout, so
//     ldmatrix.trans reads without bank conflicts.  The MLP's act launch
//     stages its up and gate tiles of the same rows in one stage (kNM = 2).
//     Rows past K and columns past N land as zeros; rows past the block's
//     share meet zero activations.  The pass's activations for the same
//     rows (and norm_qkv's scale and bias) ride in the stage beside them
//     through 16-byte cp.async, zero filled past the share.  (int8 codes
//     whose row is not a multiple of 16 bytes, which the TMA cannot
//     address, come by 8-byte cp.async into the same layout instead.)
//   - The products: A = 16 output columns x 16 contraction rows of the
//     weight tile by one ldmatrix.x4.trans, B = the pass's 8 rows (n = 8
//     exactly), fp32 accumulators.  A 32-byte group of a row is 16 columns
//     of a 16-bit weight (one mma) or 32 int8 columns: read as 16-bit
//     column pairs, the even column feeds one m16 tile and the odd column
//     the next, each code dequantized as `_deq` does it, bit for bit (q8_deq,
//     the int8 MLP's: a byte permute into 2^23, __fmul_rn by the column's
//     scale, a round to bf16).  A warp owns kGpW groups and every kWpG-th k16 step
//     of a stage; the warps' sums meet in shared memory in warp order.  No
//     float atomics: two calls give the same bits.
//   - norm_qkv's norm, overlapped: the block asks for all but one stage of
//     its ring before anything else, then computes each row's statistics
//     from x (L2-resident, 16-byte loads, one warp a row, the centred
//     variance for LayerNorm as decode.py `_normalize`) while they fly;
//     each stage's rows of x are normalised in place once they land, from
//     the staged scale and bias, rounded to T as `_norm_qkv_ref` rounds them.
//   - The grid (g16_grid): the units are (column tile, k16 step),
//     tile-major.  Split mode: block b takes tile b % tiles over one split
//     of the contraction, split only as far as it takes to fill the
//     kernel's resident blocks, so the blocks that run together read the
//     same weight rows.  Even mode (each block an equal run of units, which
//     may end a tile and start the next) serves only a weight with more
//     column tiles than resident blocks.  A tile shared by blocks is summed
//     from its fp32 partials by the last of them to take the tile's ticket,
//     in the order of the blocks' shares (q8_merge's scheme).  The MLP's
//     down launch splits its contraction at both path shapes (25 and 64
//     column tiles against 396 resident blocks).
//   - The MLP's two launches meet through `a` in the workspace.  The down
//     launch is a programmatic dependent of the act launch (PDL, 1.3-1.7 us
//     a call less: PERF.md section 6): the act kernel lets it launch once
//     every block has issued its last stage, and the down kernel issues the
//     TMA of its first stages' weight tiles, which the act launch does not
//     touch, before it waits for the act grid (griddepcontrol.wait); `a`,
//     the partials and the tickets are touched only after that wait.
//     Launched without PDL both instructions do nothing.
//   - proj_norm's norm: r's rows span every tile, so the block that
//     finishes a tile writes its columns of r32 and publishes its rows'
//     statistics over the tile's columns (sum of r^2 for RMSNorm; the count,
//     the mean and the centred sum of squares for LayerNorm).  Then the
//     blocks meet at a grid barrier (a cooperative launch, so the grid is
//     resident), and every block merges the statistics in the same fixed
//     order (Chan's parallel variance for LayerNorm: the centred form stays
//     centred) and normalises its own slice of r32 into h.
//   - The configurations (the G16Cfg aliases below) and the measurements
//     behind them are in PERF.md (sections 6 and 7).  Every kernel reads one
//     128-byte box of a row at a time: the weights' bare stream ran no
//     faster with two or four side by side, and the full kernels ran
//     slower.  norm_qkv keeps 3 blocks an SM with 3-stage rings, proj_norm 1
//     with a 6-stage ring, 4 over int8 codes (its grid barrier needs the
//     grid resident; a 128-column int8 tile's statistics merge as a
//     64-column one's do, by their count); the
//     MLP's act launch stages 64 rows of up and gate, its down launch 128
//     rows, both 3 blocks an SM.

constexpr int kGThreads = 256;                           // 8 warps
constexpr int kGWarps = kGThreads / 32;
constexpr int kGBox = 128;                               // bytes of a weight row a box
constexpr int kGAlign = 1024;                            // the 128-byte swizzle's period
constexpr int kGMaxTiles = kQ8MaxTiles;                  // tile tickets; the barrier's after them
static_assert(kGWarps == kBT, "one warp a row for the row statistics");

enum G16Kind { kQkv = 0, kProj = 1, kAct = 2, kDown = 3 };

// A kernel's tile and ring: weight element W, kNM weights a stage, kNB
// adjacent 128-byte boxes of each, kTK contraction rows a stage, kStages
// stages, kBps blocks resident on an SM (its __launch_bounds__ and its
// grid's capacity).
template <typename W_, int kNM_, int kNB_, int kTK_, int kStages_, int kBps_>
struct G16Cfg {
  using W = W_;
  static constexpr int kNM = kNM_;
  static constexpr int kNB = kNB_;
  static constexpr int kTK = kTK_;
  static constexpr int kStages = kStages_;
  static constexpr int kBps = kBps_;
  static constexpr int kTN = kNB * kGBox / static_cast<int>(sizeof(W));  // columns a tile
  static constexpr int kGroups = 4 * kNB;                 // 32-byte groups of a tile row
  static constexpr int kColsG = 32 / static_cast<int>(sizeof(W));
  static constexpr int kE = sizeof(W) == 1 ? 2 : 1;       // m16 tiles a group
  static constexpr int kWpG = kGroups >= kGWarps ? 1 : kGWarps / kGroups;  // warps a group
  static constexpr int kGpW = kGroups >= kGWarps ? kGroups / kGWarps : 1;  // groups a warp
  static constexpr int kSteps = kTK / 16;                 // k16 steps a stage
  static constexpr int kStepsAWarp = kSteps / kWpG;
  static constexpr int kBoxBytes = kTK * kGBox;
  static constexpr int kWBytes = kNM * kNB * kBoxBytes;   // the weights of a stage
  static constexpr int kXStride = kTK + 8;                // elements a staged activation row
  static constexpr int kXRows = kBT + 2;                  // the pass's rows, scale, bias
  static constexpr int kStageBytes =
      (kWBytes + kXRows * kXStride * 2 + kGAlign - 1) / kGAlign * kGAlign;
  static constexpr int kTileFloats = kNM * kBT * kTN;     // a tile's sums
  static constexpr int kRedFloats = kNM * kGWarps * kGpW * kE * kBT * 16;  // the warps' sums
  static constexpr int kSmem = kStages * kStageBytes + (kRedFloats + kTileFloats) * 4 + kGAlign;
  static_assert(sizeof(W) == 1 || sizeof(W) == 2, "16-bit weights or int8 codes");
  static_assert(kGWarps % kGroups == 0 || kGroups % kGWarps == 0, "warps tile the groups");
  static_assert(kTK % 16 == 0 && kTK <= 256 && kSteps % kWpG == 0,
                "every (group, k16 step) of a stage has one warp; a TMA box of kTK rows");
  static_assert(kStages >= 2 && kSmem * kBps <= 227 * 1024,
                "the rings fit in an SM's shared memory");
};

using QkvCfg = G16Cfg<uint16_t, 1, 1, 128, 3, 3>;
using ProjCfg = G16Cfg<uint16_t, 1, 1, 128, 6, 1>;
using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 128, 3, 3>;
using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 4, 1>;
using MlpActCfg = G16Cfg<uint16_t, 2, 1, 64, 3, 3>;      // with a gate
using MlpAct1Cfg = G16Cfg<uint16_t, 1, 1, 128, 3, 3>;    // without
using MlpDownCfg = G16Cfg<uint16_t, 1, 1, 128, 3, 3>;
// The L2 promotion of the weights' TMA copies.
constexpr int kG16L2Promo = 128;

// The units of a [K, N] product are (column tile, k16 step), tile-major.
// Block b takes units [lo, hi) (g16_range); `slots` bounds the blocks that
// share a tile, which is how many partials the workspace keeps a tile.
struct G16Grid {
  int tiles, k16, blocks, sps, even, slots;   // sps: k16 steps a split (split mode)
};

__device__ __forceinline__ void g16_range(const G16Grid& g, int b, int& lo, int& hi) {
  if (g.even) {
    const long long u = static_cast<long long>(g.tiles) * g.k16;
    lo = static_cast<int>(u * b / g.blocks);
    hi = static_cast<int>(u * (b + 1) / g.blocks);
  } else {
    const int tile = b % g.tiles, split = b / g.tiles;
    lo = tile * g.k16 + split * g.sps;
    hi = tile * g.k16 + min(g.k16, (split + 1) * g.sps);
  }
}

// Even mode: the block whose run holds unit u.
__device__ __forceinline__ int g16_owner(const G16Grid& g, int u) {
  const long long n = static_cast<long long>(g.tiles) * g.k16;
  return static_cast<int>((static_cast<long long>(u + 1) * g.blocks + n - 1) / n) - 1;
}

struct G16Args {
  CUtensorMap wmap[2];  // the weights as [K rows, N columns] boxes of kTK rows x
                        // 128 bytes, 128-byte swizzle (the MLP's up, gate)
  G16Grid g;
  const void* x;        // the pass's rows [bc, K]: x, ctx, h or a
  const void* w[2];     // [K, N]; read by 8-byte cp.async where the TMA cannot
  const float* ws;      // int8 codes: the columns' fp32 scales [N], else null
  const void* wb[2];    // the output columns' biases [N], or null: bqkv, bo,
                        // (bu, bg), bd
  const void* scale;    // the norm's scale: [K] (norm_qkv) or [N] (proj_norm)
  const void* bias;     // the norm's bias, or null (RMSNorm)
  const void* resid;    // proj_norm: resid; the MLP's down launch: r [bc, N]
  void* out;            // [bc, N]: norm_qkv's out, proj_norm's r, `a`, the MLP's out
  void* h;              // proj_norm: [bc, N]
  float* part;          // [tiles][slots][kTileFloats]: partials of shared tiles
  float* r32;           // proj_norm: [kBT, N], r in fp32
  float2* stats;        // proj_norm: [tiles][kBT], each tile's row statistics
  unsigned int* ticket; // [kGMaxTiles + 1] zeroed: the tiles', then proj_norm's
                        // grid barrier (generation, count); counts left at 0
  int bc, K, N, kind, parallel, act;
  float eps;
};

template <typename T> struct Two;  // two T packed in 32 bits
template <> struct Two<__nv_bfloat16> {
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};
template <> struct Two<__half> {
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 p = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    mma_16816(c, a, b0, b1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}

// Programmatic dependent launch (both do nothing in a grid launched without it).
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The weight tiles of a stage, rows [k0, k0 + kTK) of columns [n0, n0 +
// kTN) of each of the kNM weights, swizzled.  kTma: one thread asks the TMA
// for each box (rows past K and columns past N land as zeros) and arms the
// stage's mbarrier `full` with their bytes; else every thread copies 8-byte
// chunks by cp.async (zero filled past K and N) into the same layout.
template <class C, bool kTma>
__device__ __forceinline__ void g16_load_w(uint32_t st, const G16Args& a, int n0, int k0,
                                           uint32_t full) {
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(full), "r"(C::kWBytes) : "memory");
#pragma unroll
      for (int m = 0; m < C::kNM; ++m)
#pragma unroll
        for (int bx = 0; bx < C::kNB; ++bx)
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
              " [%0], [%1, {%2, %3}], [%4];\n"
              ::"r"(st + (m * C::kNB + bx) * C::kBoxBytes),
                "l"(reinterpret_cast<uint64_t>(&a.wmap[m])),
                "r"(n0 + bx * (kGBox / static_cast<int>(sizeof(typename C::W)))), "r"(k0),
                "r"(full)
              : "memory");
    }
  } else {
    constexpr int kPerRow = kGBox / 8;
    constexpr int kPerBox = C::kTK * kPerRow;
    constexpr int kEl = sizeof(typename C::W);
    for (int i = threadIdx.x; i < C::kNM * C::kNB * kPerBox; i += kGThreads) {
      const int box = i / kPerBox, r = (i % kPerBox) / kPerRow, byte = (i % kPerRow) * 8;
      const int m = box / C::kNB;
      const int col = n0 + ((box % C::kNB) * kGBox + byte) / kEl;
      const bool in = k0 + r < a.K && col < a.N;
      const char* src = static_cast<const char*>(a.w[m]);
      if (in) src += (static_cast<size_t>(k0 + r) * a.N + col) * kEl;
      const uint32_t d = st + box * C::kBoxBytes + r * kGBox + (q8_swizzle(r, byte >> 4) << 4) +
                         (byte & 15);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                   "r"(in ? 8 : 0));
    }
  }
}

// Rows [k0, k1) of the pass's activations (with kNorm, of the norm's scale
// and bias too) into the stage at `st`, beside its weights; rows past k1
// zero filled.
template <typename T, class C, bool kNorm>
__device__ __forceinline__ void g16_load_x(uint32_t st, const G16Args& a, int k0, int k1) {
  constexpr int kXPerRow = C::kTK / 8;
  constexpr int kRows = kNorm ? C::kXRows : kBT;
  const T* x = static_cast<const T*>(a.x);
  for (int i = threadIdx.x; i < kRows * kXPerRow; i += kGThreads) {
    const int row = i / kXPerRow, k = k0 + (i % kXPerRow) * 8;
    const T* src = row < kBT ? (row < a.bc ? x + static_cast<size_t>(row) * a.K : nullptr)
                             : static_cast<const T*>(row == kBT ? a.scale : a.bias);
    const bool in = src != nullptr && k < k1;
    cp_async16(st + C::kWBytes + (row * C::kXStride + (i % kXPerRow) * 8) * 2,
               in ? src + k : x, in);
  }
}

// The warp's j-th group of the tile and the k16 steps it takes (every
// kWpG-th from ksub).
template <class C>
__device__ __forceinline__ int g16_group(int warp, int j) {
  return C::kGroups >= kGWarps ? warp + kGWarps * j : warp % C::kGroups;
}

// The warps' accumulators of a finished share summed in warp order into
// sums [kNM][kBT][kTN] (shared); ends with a barrier.  C fragment q of m16
// tile e: row g + 8 (q >> 1) of the tile, batch row 2t + (q & 1); a 16-bit
// group's tile row is its column, an int8 group's even (e = 0) and odd
// tiles' row m is its column 2 (m % 8) + 16 (m / 8) + e.
template <class C>
__device__ __forceinline__ void g16_reduce(const float (&acc)[C::kNM][C::kGpW][C::kE][4],
                                           float* red, float* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < C::kNM; ++m)
#pragma unroll
    for (int j = 0; j < C::kGpW; ++j)
#pragma unroll
      for (int e = 0; e < C::kE; ++e) {
        float* rw = red + (((m * kGWarps + warp) * C::kGpW + j) * C::kE + e) * kBT * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q) rw[(2 * t + (q & 1)) * 16 + g + 8 * (q >> 1)] = acc[m][j][e][q];
      }
  __syncthreads();
  for (int o = threadIdx.x; o < C::kTileFloats; o += kGThreads) {
    const int m = o / (kBT * C::kTN), b = (o / C::kTN) % kBT, c = o % C::kTN;
    const int gi = c / C::kColsG, cg = c % C::kColsG;
    const int e = C::kE == 2 ? (cg & 1) : 0;
    const int row = C::kE == 2 ? ((cg & 15) >> 1) + ((cg >> 4) << 3) : cg;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < C::kWpG; ++s) {
      const int w = C::kGroups >= kGWarps ? gi % kGWarps : gi + s * C::kGroups;
      const int j = C::kGroups >= kGWarps ? gi / kGWarps : 0;
      v += red[((((m * kGWarps + w) * C::kGpW + j) * C::kE + e) * kBT + b) * 16 + row];
    }
    sums[o] = v;
  }
  __syncthreads();
}

// A tile shared by blocks: write this block's sums as the partial of its
// slot; the last of the tile's n blocks to take its ticket reads every
// slot's partial back into `sums`, summed in slot order, resets the ticket
// and returns true.  Other blocks return false.
template <class C>
__device__ __forceinline__ bool g16_merge(const G16Args& a, int tile, int slot, int n,
                                          float* sums) {
  __shared__ bool last;
  constexpr int kTile = C::kTileFloats;
  float* tp = a.part + static_cast<size_t>(tile) * a.g.slots * kTile;
  for (int o = threadIdx.x; o < kTile; o += kGThreads) tp[slot * kTile + o] = sums[o];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket + tile, 1u) == static_cast<unsigned>(n - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int o = threadIdx.x; o < kTile; o += kGThreads) {
    // the partials' loads 8 at a time in flight, their sums in slot order
    float v = 0.f;
    int j = 0;
    for (; j + 8 <= n; j += 8) {
      float p[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) p[u] = __ldcg(tp + (j + u) * kTile + o);
#pragma unroll
      for (int u = 0; u < 8; ++u) v += p[u];
    }
    for (; j < n; ++j) v += __ldcg(tp + j * kTile + o);
    sums[o] = v;
  }
  if (threadIdx.x == 0) a.ticket[tile] = 0u;  // ready for the next launch on this stream
  __syncthreads();
  return true;
}

// Chan's merge of (count, mean, centred sum of squares) b into a.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa, float nb, float mb,
                                           float qb) {
  if (nb == 0.f) return;
  const float n = na + nb, d = mb - ma;
  ma += d * (nb / n);
  qa += qb + d * d * (na * nb / n);
  na = n;
}

// Every block of the grid meets here (a cooperative launch: all of them
// resident).  Each block's writes before it are visible to every block
// after it.  *bar packs the generation (high 16 bits) over the arrivals
// (low 16 bits, left at 0): the last to arrive zeroes the count and bumps
// the generation in one atomic, the others watch the generation.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned int old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(bar) : "memory");
    if ((old & 0xffffu) == gridDim.x - 1) {
      asm volatile("red.add.release.gpu.global.u32 [%0], %1;\n"
                   :: "l"(bar), "r"(0x10000u - gridDim.x) : "memory");
    } else {
      unsigned int now;
      do {
        __nanosleep(32);
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(bar) : "memory");
      } while ((now ^ old) >> 16 == 0);
    }
  }
  __syncthreads();
}

// proj_norm's norm, in every block once all tiles are finished: merge the
// tiles' row statistics in a fixed order (each lane its tiles in tile
// order, then the lanes pairwise), then normalise this block's slice of
// r32 (or resid, parallel) into h: r32 read once over the grid.  The
// slice's scale and bias are read before the barrier.
template <typename T, class C>
__device__ __forceinline__ void g16_norm(const G16Args& a) {
  __shared__ float2 row[kBT];   // (mean, rstd)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = a.N;
  const T* resid = static_cast<const T*>(a.resid);
  const T* scale = static_cast<const T*>(a.scale);
  const T* bias = static_cast<const T*>(a.bias);
  T* h = static_cast<T*>(a.h);
  const int q4 = N / 4, total = a.bc * q4;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int i0 = blockIdx.x * per + threadIdx.x;
  const int i1 = min(total, (static_cast<int>(blockIdx.x) + 1) * per);
  float sc[4], bi[4], rs[4];
  auto params = [&](int i) {
    const int b = i / q4, c = (i % q4) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sc[k] = to_f32(scale[c + k]);
      bi[k] = bias ? to_f32(bias[c + k]) : 0.f;
      rs[k] = a.parallel ? to_f32(resid[static_cast<size_t>(b) * N + c + k]) : 0.f;
    }
  };
  if (i0 < i1) params(i0);
  grid_barrier(a.ticket + kGMaxTiles);
  if (warp < a.bc) {
    float n = 0.f, m = 0.f, q = 0.f;
    for (int t0 = 0; t0 < a.g.tiles; t0 += 128) {
      float2 sv[4];   // the loads first, then the merges in tile order
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = t0 + lane + 32 * u;
        sv[u] = tt < a.g.tiles ? __ldcg(a.stats + tt * kBT + warp) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = t0 + lane + 32 * u;
        if (tt < a.g.tiles)
          chan_merge(n, m, q, static_cast<float>(min(C::kTN, N - tt * C::kTN)), sv[u].x, sv[u].y);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {   // lane l takes lane l + off
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, m, off);
      const float qb = __shfl_down_sync(0xffffffffu, q, off);
      if (lane + off < 32 && (lane & (2 * off - 1)) == 0) chan_merge(n, m, q, nb, mb, qb);
    }
    if (lane == 0)
      row[warp] = make_float2(a.kind == kLayer ? m : 0.f,
                              rsqrtf(q / static_cast<float>(N) + a.eps));
  }
  __syncthreads();
  for (int i = i0; i < i1; i += kGThreads) {
    if (i != i0) params(i);
    const int b = i / q4, c = (i % q4) * 4;
    const size_t o = static_cast<size_t>(b) * N + c;
    float v[4];
    if (a.parallel) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = rs[k];
    } else {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(a.r32 + o));
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
    float y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      y[k] = normalize(v[k], row[b].x, row[b].y, sc[k], bi[k], a.kind);
    *reinterpret_cast<uint2*>(h + o) = make_uint2(Two<T>::pack(y[0], y[1]), Two<T>::pack(y[2], y[3]));
  }
}

// The epilogue of a finished tile, its whole sums in `sums`.
template <typename T, int kKind, class C>
__device__ __forceinline__ void g16_epilogue(const G16Args& a, int tile, float* sums) {
  constexpr int kTN = C::kTN;
  const int n0 = tile * kTN;
  const T* wb = static_cast<const T*>(a.wb[0]);
  T* out = static_cast<T*>(a.out);
  if constexpr (kKind != kProj) {
    const T* wg = static_cast<const T*>(a.wb[1]);
    const T* resid = static_cast<const T*>(a.resid);
    for (int o = threadIdx.x; o < a.bc * kTN; o += kGThreads) {
      const int b = o / kTN, n = n0 + o % kTN;
      if (n < a.N) {
        const size_t i = static_cast<size_t>(b) * a.N + n;
        float y = sums[o];
        if (wb) y += to_f32(wb[n]);
        if constexpr (kKind == kAct) {
          if constexpr (C::kNM == 2) {
            float gv = sums[kBT * kTN + o];
            if (wg) gv += to_f32(wg[n]);
            y = act_fn(a.act, gv) * y;
          } else {
            y = act_fn(a.act, y);
          }
        } else if constexpr (kKind == kDown) {
          y = to_f32(resid[i]) + y;
        }
        out[i] = from_f32<T>(y);
      }
    }
  } else {
    const T* resid = static_cast<const T*>(a.resid);
    for (int o = threadIdx.x; o < kBT * kTN; o += kGThreads) {
      const int b = o / kTN, n = n0 + o % kTN;
      float src = 0.f;
      if (b < a.bc && n < a.N) {
        float y = sums[o];
        if (wb) y += to_f32(wb[n]);
        const size_t i = static_cast<size_t>(b) * a.N + n;
        const float rv = to_f32(resid[i]) + y;
        out[i] = from_f32<T>(rv);
        a.r32[i] = rv;
        src = a.parallel ? to_f32(resid[i]) : rv;
      }
      sums[o] = src;
    }
    __syncthreads();
    // this tile's statistics of each row, one warp a row
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp < a.bc) {
      const float nv = static_cast<float>(min(kTN, a.N - n0));
      const float* s = sums + warp * kTN;
      float m = 0.f;
      if (a.kind == kLayer) {
        float t = 0.f;
        for (int c = lane; c < kTN; c += 32) t += s[c];
        m = warp_sum(t) / nv;
      }
      float q = 0.f;
      for (int c = lane; c < kTN && n0 + c < a.N; c += 32) q += (s[c] - m) * (s[c] - m);
      q = warp_sum(q);
      if (lane == 0) a.stats[tile * kBT + warp] = make_float2(m, q);
    }
  }
  __syncthreads();  // sums is reused by the next share
}

// Each row's statistics of x (norm_qkv), one warp a row, into xstat.
template <typename T>
__device__ __forceinline__ void g16_row_stats(const G16Args& a, float2* xstat) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < a.bc) {
    using P = Pack<T>;
    const P* xr = reinterpret_cast<const P*>(static_cast<const T*>(a.x) +
                                             static_cast<size_t>(warp) * a.K);
    const int nv = a.K / P::N;
    float m = 0.f;
    if (a.kind == kLayer) {
      float s = 0.f;
#pragma unroll 8
      for (int i = lane; i < nv; i += 32) {
        const P p = xr[i];
#pragma unroll
        for (int j = 0; j < P::N; ++j) s += to_f32(p.v[j]);
      }
      m = warp_sum(s) / static_cast<float>(a.K);
    }
    float ss = 0.f;
#pragma unroll 8
    for (int i = lane; i < nv; i += 32) {
      const P p = xr[i];
#pragma unroll
      for (int j = 0; j < P::N; ++j) ss += (to_f32(p.v[j]) - m) * (to_f32(p.v[j]) - m);
    }
    ss = warp_sum(ss);   // every lane: the shuffles take the whole warp
    if (lane == 0) xstat[warp] = make_float2(m, rsqrtf(ss / static_cast<float>(a.K) + a.eps));
  } else if (lane == 0) {
    xstat[warp] = make_float2(0.f, 0.f);
  }
}

template <class C>
__device__ __forceinline__ void g16_zero(float (&acc)[C::kNM][C::kGpW][C::kE][4]) {
#pragma unroll
  for (int m = 0; m < C::kNM; ++m)
#pragma unroll
    for (int j = 0; j < C::kGpW; ++j)
#pragma unroll
      for (int e = 0; e < C::kE; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][e][q] = 0.f;
}

// int8: the fp32 scales of the thread's columns of `tile`: the even and odd
// column of each half of each of its groups (q8_tile's four).
template <class C>
__device__ __forceinline__ void g16_scales(float (&sc)[C::kGpW][4], const G16Args& a, int tile) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int j = 0; j < C::kGpW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = tile * C::kTN + g16_group<C>(warp, j) * 32 + (q >> 1) * 16 + 2 * g + (q & 1);
      sc[j][q] = col < a.N ? a.ws[col] : 0.f;
    }
}

// Waits for the phase `parity` of the mbarrier at shared address `bar`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

template <typename T, int kKind, class C, bool kTma = true>
__device__ __forceinline__ void g16_body(const G16Args& a) {
  using W = typename C::W;
  constexpr bool kNorm = kKind == kQkv;
  constexpr bool kInt8 = sizeof(W) == 1;
  constexpr int kStages = C::kStages;
  static_assert(!kInt8 || std::is_same<T, __nv_bfloat16>::value, "int8 codes take bf16 rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float2 xstat[kBT];  // norm_qkv: each row's (mean, rstd)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ksub = C::kGroups >= kGWarps ? 0 : warp / C::kGroups;
  const G16Grid& gr = a.g;
  unsigned char* smem = smem_raw + ((kGAlign - smem_u32(smem_raw) % kGAlign) % kGAlign);
  __shared__ alignas(8) uint64_t full_bar[kStages];
  if (kTma && threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full_bar + q))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t fb = smem_u32(full_bar);
  float* red = reinterpret_cast<float*>(smem + kStages * C::kStageBytes);
  float* sums = red + C::kRedFloats;
  const uint32_t ring = smem_u32(smem);
  int lo, hi;
  g16_range(gr, blockIdx.x, lo, hi);

  // the producers: the next unit whose weights (pw) and activations (px) to
  // load; a stage never crosses a tile
  int pw = lo, px = lo;
  auto stage_of = [&](int u, int& n0, int& k0, int& k1) {
    const int tile = u / gr.k16, base = tile * gr.k16;
    const int e = min(min(hi, base + gr.k16), u + C::kSteps);
    n0 = tile * C::kTN;
    k0 = (u - base) * 16;
    k1 = min(a.K, (e - base) * 16);
    return e;
  };
  auto issue_w = [&](int slot) {
    if (pw < hi) {
      int n0, k0, k1;
      const int e = stage_of(pw, n0, k0, k1);
      g16_load_w<C, kTma>(ring + slot * C::kStageBytes, a, n0, k0, fb + slot * 8);
      pw = e;
    }
  };
  auto issue_x = [&](int slot) {
    if (px < hi) {
      int n0, k0, k1;
      const int e = stage_of(px, n0, k0, k1);
      g16_load_x<T, C, kNorm>(ring + slot * C::kStageBytes, a, k0, k1);
      px = e;
    }
    cp_async_commit();
  };
  if constexpr (kKind == kDown) {
    // the weights, which the act launch does not touch, before its end
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) issue_w(p);
    pdl_wait();
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) issue_x(p);
  } else {
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      issue_w(p);
      issue_x(p);
    }
  }

  if constexpr (kNorm) {
    g16_row_stats<T>(a, xstat);   // while the first stages fly
    __syncthreads();
  }

  float acc[C::kNM][C::kGpW][C::kE][4];
  float sc[C::kGpW][4];          // int8: the thread's columns' scales
  g16_zero<C>(acc);
  bool triggered = false;
  int cu = lo, seg = lo;  // the consumer: the next unit, the start of its share
  if (kInt8 && cu < hi) g16_scales<C>(sc, a, cu / gr.k16);
  for (int i = 0; cu < hi; ++i) {
    cp_async_wait<kStages - 2>();
    if constexpr (kTma) mbar_wait(fb + (i % kStages) * 8, (i / kStages) & 1);
    __syncthreads();
    issue_w((i + kStages - 1) % kStages);
    issue_x((i + kStages - 1) % kStages);
    if constexpr (kKind == kAct) {
      if (!triggered && pw >= hi) {   // this block's last stage is asked for
        pdl_launch_dependents();
        triggered = true;
      }
    }
    const int slot = i % kStages;
    const uint32_t st = ring + slot * C::kStageBytes;
    unsigned char* xs = smem + slot * C::kStageBytes + C::kWBytes;
    if constexpr (kNorm) {
      // normalise the stage's rows of x in place, once, rounded to T (rows
      // past the share come zero filled with their scale and bias: 0)
      for (int e = threadIdx.x; e < kBT * C::kTK / 2; e += kGThreads) {
        const int b = e / (C::kTK / 2), o = (e % (C::kTK / 2)) * 4;
        uint32_t* p = reinterpret_cast<uint32_t*>(xs + b * C::kXStride * 2 + o);
        const float2 xf = Two<T>::unpack(*p);
        const float2 sf = Two<T>::unpack(
            *reinterpret_cast<const uint32_t*>(xs + kBT * C::kXStride * 2 + o));
        const float2 bf = Two<T>::unpack(
            *reinterpret_cast<const uint32_t*>(xs + (kBT + 1) * C::kXStride * 2 + o));
        const float2 st2 = xstat[b];
        *p = Two<T>::pack(normalize(xf.x, st2.x, st2.y, sf.x, bf.x, a.kind),
                          normalize(xf.y, st2.x, st2.y, sf.y, bf.y, a.kind));
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < C::kStepsAWarp; ++s) {
      const int ks = ksub + C::kWpG * s;
      // B: rows g of the pass at k = 2t, 2t + 1 and 2t + 8, 2t + 9 of the step
      const int xo = (ks * 16 + 2 * t) * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs + g * C::kXStride * 2 + xo);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + g * C::kXStride * 2 + xo + 16);
      // A: the group's 32 bytes of the step's 16 rows
      const int krow = ks * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int j = 0; j < C::kGpW; ++j) {
        const int grp = g16_group<C>(warp, j);
        const int chunk = (grp & 3) * 2 + ((lane >> 3) & 1);
        const uint32_t off = (grp >> 2) * C::kBoxBytes + krow * kGBox +
                             (q8_swizzle(krow, chunk) << 4);
#pragma unroll
        for (int m = 0; m < C::kNM; ++m) {
          uint32_t r[4];
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                       : "r"(st + m * C::kNB * C::kBoxBytes + off));
          if constexpr (kInt8) {
            // r[0], r[1]: rows 2t, 2t+1 of the group's halves; r[2], r[3]: rows +8
            uint32_t ae[4], ao[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              q8_deq(r[q], sc[j][(q & 1) * 2], sc[j][(q & 1) * 2 + 1], ae[q], ao[q]);
            mma_16816(acc[m][j][0], ae, b0, b1);
            mma_16816(acc[m][j][C::kE - 1], ao, b0, b1);
          } else {
            mma16<T>(acc[m][j][0], r, b0, b1);
          }
        }
      }
    }
    const int tile = cu / gr.k16, base = tile * gr.k16;
    const int end = min(hi, base + gr.k16);
    cu = min(end, cu + C::kSteps);
    if (cu < end) continue;
    // this block's share of the tile is done
    g16_reduce<C>(acc, red, sums);
    g16_zero<C>(acc);
    bool finish = true;
    if (seg != base || end != base + gr.k16) {
      int slotn, n;
      if (gr.even) {
        const int first = g16_owner(gr, base);
        slotn = blockIdx.x - first;
        n = g16_owner(gr, base + gr.k16 - 1) - first + 1;
      } else {
        slotn = (seg - base) / gr.sps;
        n = (gr.k16 + gr.sps - 1) / gr.sps;
      }
      finish = g16_merge<C>(a, tile, slotn, n, sums);
    }
    if (finish) g16_epilogue<T, kKind, C>(a, tile, sums);
    seg = cu;
    if (kInt8 && cu < hi) g16_scales<C>(sc, a, cu / gr.k16);
  }
  cp_async_wait<0>();
  if constexpr (kKind == kAct) {
    if (!triggered) pdl_launch_dependents();   // a block with no unit
  }
  if constexpr (kKind == kProj) g16_norm<T, C>(a);
}

template <typename T>
__global__ void __launch_bounds__(kGThreads, QkvCfg::kBps)
    norm_qkv_mma_kernel(const __grid_constant__ G16Args a) {
  g16_body<T, kQkv, QkvCfg>(a);
}

template <typename T>
__global__ void __launch_bounds__(kGThreads, ProjCfg::kBps)
    proj_norm_mma_kernel(const __grid_constant__ G16Args a) {
  g16_body<T, kProj, ProjCfg>(a);
}

// int8 codes (bf16 rows): kTma false where a code row is not a multiple of
// 16 bytes (the TMA's stride).
template <bool kTma>
__global__ void __launch_bounds__(kGThreads, Qkv8Cfg::kBps)
    norm_qkv_int8_mma_kernel(const __grid_constant__ G16Args a) {
  g16_body<__nv_bfloat16, kQkv, Qkv8Cfg, kTma>(a);
}

template <bool kTma>
__global__ void __launch_bounds__(kGThreads, Proj8Cfg::kBps)
    proj_norm_int8_mma_kernel(const __grid_constant__ G16Args a) {
  g16_body<__nv_bfloat16, kProj, Proj8Cfg, kTma>(a);
}

template <typename T, class C>
__global__ void __launch_bounds__(kGThreads, C::kBps)
    mlp_act_mma_kernel(const __grid_constant__ G16Args a) {
  g16_body<T, kAct, C>(a);
}

template <typename T>
__global__ void __launch_bounds__(kGThreads, MlpDownCfg::kBps)
    mlp_down_mma_kernel(const __grid_constant__ G16Args a) {
  g16_body<T, kDown, MlpDownCfg>(a);
}

// ---------------------------------------------------------------------------
// flash decode: out[B, H, Dh] = softmax(q . K^T * scale (+ alibi)) V over
// keys 0..pos[b] of each row, K/V in the paged pool or a contiguous cache
// ---------------------------------------------------------------------------

constexpr int kFdMaxRows = kQ8MaxTiles;  // (slot, KV head) rows a launch: a ticket each

struct FdArgs {
  const void* q;            // [B, H, Dh]
  const void* kpool;        // [P, Hkv, page, Dh]: the layer's slice of the pool
  const void* vpool;        //   (contiguous: the [B, Hkv, Smax, Dh] slice, page Smax)
  const long long* pos;     // row b's depth at pos[b * pos_stride], or null: pos0
  const long long* table;   // [B, maxp], or null: page b of a contiguous cache
  const float* slopes;      // [H] ALiBi slopes, or null
  void* out;                // [B, H, Dh]
  float* part;              // [B * Hkv, splits, rep, Dh + 2]: each split's (acc, m, l)
  unsigned int* ticket;     // [B * Hkv], zeroed; left at 0
  int H, Hkv, Dh, page, maxp, chunk, splits;
  float scale;
  long long pos0;
  int pos_stride;
};

// Bytes of shared memory a block takes: the K and V chunks, q, the scores
// and probabilities, the P.V key groups' partials, the running (m, l,
// alpha) and two slots of page-table entries.
__host__ __device__ inline size_t fd_smem_bytes(int Dh, int R, int chunk, int elem) {
  const size_t rowb = static_cast<size_t>(Dh) * elem;
  const int groups = kFdThreads / (Dh / 2);
  return 2 * chunk * rowb +
         sizeof(float) * (static_cast<size_t>(R) * Dh + 2 * R * chunk +
                          static_cast<size_t>(groups) * R * Dh + 4 * R) +
         2 * chunk * sizeof(long long);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 16 bytes of T at `src` (shared memory) as 16 / sizeof(T) floats (the
// 16-bit halves widened by bit moves and __half2float: exact, in registers).
template <typename T>
__device__ __forceinline__ void fd_unpack16(const unsigned char* src, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __half>::value) {
      f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Two neighbouring elements of T at `src` (shared memory) as floats.
template <typename T>
__device__ __forceinline__ float2 fd_pair(const unsigned char* src) {
  if constexpr (std::is_same<T, float>::value)
    return *reinterpret_cast<const float2*>(src);
  else if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(src));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
}

// Keys [t0, t1) of one (slot, KV head) row into `buf` ([t1 - t0, Dh] of T)
// by bulk copies (the TMA), one a run of keys within a page, completing on
// the mbarrier at `mb`; called by one warp, whose lane 0 first sets the
// bytes to expect.  The paged pool's pages come from `slot` (the table
// entries from key t0's page on, `trow` non-null); a contiguous cache is
// one run at `row_base` (page >= t1).
template <typename T>
__device__ __forceinline__ void fd_load_rows(const T* pool, unsigned char* buf, int t0, int t1,
                                             int page, int Dh, size_t head_stride,
                                             size_t row_base, int Hkv, int g,
                                             const long long* trow, const long long* slot,
                                             uint32_t mb, int lane) {
  const int rowb = Dh * static_cast<int>(sizeof(T));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(mb), "r"((t1 - t0) * rowb) : "memory");
  __syncwarp();
  const int p0 = t0 / page, p1 = (t1 - 1) / page + 1;
  for (int pi = p0 + lane; pi < p1; pi += 32) {
    const int ta = max(t0, pi * page), tb = min(t1, (pi + 1) * page);
    const T* src = trow != nullptr
                       ? pool + (static_cast<size_t>(slot[pi - p0]) * Hkv + g) * head_stride +
                             static_cast<size_t>(ta - pi * page) * Dh
                       : pool + row_base + static_cast<size_t>(ta) * Dh;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(buf + (ta - t0) * rowb)), "l"(src), "r"((tb - ta) * rowb), "r"(mb)
        : "memory");
  }
}

// One block: a (slot, KV head) row (blockIdx.x) and one split of its keys
// (blockIdx.y); R >= rep query heads a KV head, compile-time so that the
// per-thread state lives in registers.  A chunk's V is in flight during its
// scores, the next chunk's K during its P.V.
template <typename T, int R>
__global__ void __launch_bounds__(kFdThreads) flash_decode_kernel(FdArgs a) {
  constexpr int kVE = 16 / sizeof(T);       // elements a 16-byte vector
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kpool = static_cast<const T*>(a.kpool);
  const T* __restrict__ vpool = static_cast<const T*>(a.vpool);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int Hkv = a.Hkv, Dh = a.Dh, C = a.chunk, page = a.page;
  const int row = blockIdx.x, split = blockIdx.y;
  const int b = row / Hkv, g = row % Hkv;
  const int rep = a.H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the row's keys, its chunks and this split's share of them: whole chunks,
  // `per` a split, so the live splits are the first ceil(chunks / per)
  const long long p = a.pos != nullptr ? a.pos[static_cast<size_t>(b) * a.pos_stride] : a.pos0;
  const int n_tok = static_cast<int>(
      max(0LL, min(p + 1, static_cast<long long>(a.maxp) * page)));
  const int n_chunks = (n_tok + C - 1) / C;
  const int per = (n_chunks + a.splits - 1) / a.splits;
  const int live = per > 0 ? (n_chunks + per - 1) / per : 0;
  T* og = out + (static_cast<size_t>(b) * a.H + static_cast<size_t>(g) * rep) * Dh;
  if (live == 0) {                          // no key (pos < 0): zeros, as l == 0 gives
    if (split == 0)
      for (int o = tid; o < rep * Dh; o += kFdThreads) og[o] = from_f32<T>(0.f);
    return;
  }
  if (split >= live) return;
  const int c0 = split * per, c1 = min(n_chunks, c0 + per);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rowb = Dh * static_cast<int>(sizeof(T));
  const int nvec = Dh / kVE;
  const int pairs = Dh / 2, groups = kFdThreads / pairs;
  unsigned char* k_s = smem_raw;                                      // [C, rowb]
  unsigned char* v_s = k_s + C * rowb;                                // [C, rowb]
  float* q_s = reinterpret_cast<float*>(v_s + C * rowb);              // [R, Dh]
  float* s_s = q_s + R * Dh;                                          // [R, C] scores
  float* p_s = s_s + R * C;                                           // [C, R] probabilities
  float* red_s = p_s + C * R;                                         // [groups, R, Dh]
  float* ml_s = red_s + groups * R * Dh;                              // m, l, alpha [R] each
  long long* pt_s = reinterpret_cast<long long*>(ml_s + 4 * R);       // [2, C] pages
  __shared__ alignas(8) uint64_t bars[2];                             // K, V

  if (tid < R) {
    ml_s[tid] = kNegInf;
    ml_s[R + tid] = 0.f;
    ml_s[2 * R + tid] = 1.f;
  }
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float slope[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    slope[r] = (a.slopes != nullptr && r < rep) ? a.slopes[g * rep + r] : 0.f;

  // chunk c's page-table entries into slot c & 1 (8-byte cp.async; a chunk
  // spans at most C pages), and its K or V rows up to the row's depth into
  // `buf` (warp 0 asks the TMA; rows past the depth keep what they held:
  // their scores are masked and P.V stops at the depth)
  const long long* trow = a.table != nullptr ? a.table + static_cast<size_t>(b) * a.maxp : nullptr;
  auto stage_table = [=](int c) {
    if (trow == nullptr) return;
    const int p0 = c * C / page, p1 = min(a.maxp, (c * C + C - 1) / page + 1);
    long long* dst = pt_s + (c & 1) * C;
    for (int i = tid; i < p1 - p0; i += kFdThreads) cp_async8(smem_u32(dst + i), trow + p0 + i);
  };
  const size_t head_stride = static_cast<size_t>(page) * Dh;
  const size_t row_base = (static_cast<size_t>(b) * Hkv + g) * head_stride;
  const uint32_t bar_k = smem_u32(bars), bar_v = smem_u32(bars + 1);
#define FD_LOAD(pool, buf, c, mb)                                                              \
  do {                                                                                       \
    if (warp == 0)                                                                           \
      fd_load_rows<T>(pool, buf, (c) * C, min((c) * C + C, n_tok), page, Dh, head_stride,    \
                      row_base, Hkv, g, trow, pt_s + ((c) & 1) * C, mb, lane);               \
  } while (0)

  // K(c + 1) is asked once chunk c's scores are in, V(c + 1) once its P.V
  // is; the page-table slots fill by cp.async groups, each waited before the
  // copies that read it.
  stage_table(c0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                          // the table slot and the mbarriers
  FD_LOAD(kpool, k_s, c0, bar_k);
  FD_LOAD(vpool, v_s, c0, bar_v);
  if (c0 + 1 < c1) stage_table(c0 + 1);
  cp_async_commit();
  // q (fp32) while the first chunk is in flight
  const T* qg = q + (static_cast<size_t>(b) * a.H + static_cast<size_t>(g) * rep) * Dh;
  for (int i = tid; i < R * Dh; i += kFdThreads) q_s[i] = i < rep * Dh ? to_f32(qg[i]) : 0.f;

  const int tpk = kFdThreads / C;           // threads a key for the scores
  const int key = tid / tpk, sub = tid - key * tpk;
  const int cp = tid % pairs, kg = tid / pairs;
  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int c = c0; c < c1; ++c) {
    const uint32_t parity = (c - c0) & 1;   // the mbarriers' phase
    cp_async_wait<0>();                     // the table of c + 1
    mbar_wait(bar_k, parity);               // K(c)
    __syncthreads();
    // scores: each key's dot with every query head, fp32, Dh split over tpk lanes
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const unsigned char* krow = k_s + key * rowb;
    for (int v = sub; v < nvec; v += tpk) {
      float kf[kVE];
      fd_unpack16<T>(krow + v * 16, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rep) {
          const float* qr = q_s + r * Dh + v * kVE;
#pragma unroll
          for (int e = 0; e < kVE; ++e) s[r] = fmaf(qr[e], kf[e], s[r]);
        }
      }
    }
    for (int off = tpk / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    }
    if (sub == 0) {
      const int t = c * C + key;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = s[r] * a.scale;
        if (a.slopes != nullptr) v += slope[r] * static_cast<float>(t - p);
        s_s[r * C + key] = t < n_tok ? v : kNegInf;   // past the depth: weight 0
      }
    }
    __syncthreads();                        // the K buffer is free, the scores are in
    if (c + 1 < c1) {
      FD_LOAD(kpool, k_s, c + 1, bar_k);
      if (c + 2 < c1) stage_table(c + 2);
      cp_async_commit();
    }
    // the online softmax: a warp a query head, lanes over the chunk's keys
    for (int r = warp; r < rep; r += kFdThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < C; j += 32) mx = fmaxf(mx, s_s[r * C + j]);
      mx = warp_max(mx);
      const float m_old = ml_s[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float e = expf(s_s[r * C + j] - m_new);
        p_s[j * R + r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ml_s[2 * R + r] = alpha;
        ml_s[R + r] = alpha * ml_s[R + r] + sum;
        ml_s[r] = m_new;
      }
    }
    mbar_wait(bar_v, parity);               // V(c)
    __syncthreads();
    // P.V: a thread two head-dim columns of every query head, over every
    // groups-th key of the chunk
    if (kg < groups) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float alpha = ml_s[2 * R + r];
        acc[r][0] *= alpha;
        acc[r][1] *= alpha;
      }
      const int jn = min(C, n_tok - c * C);
      for (int j = kg; j < jn; j += groups) {
        const float2 v2 = fd_pair<T>(v_s + j * rowb + cp * 2 * static_cast<int>(sizeof(T)));
        const float* pj = p_s + j * R;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rep) {
            acc[r][0] = fmaf(pj[r], v2.x, acc[r][0]);
            acc[r][1] = fmaf(pj[r], v2.y, acc[r][1]);
          }
        }
      }
    }
    __syncthreads();                        // the V buffer and p are free
    if (c + 1 < c1) FD_LOAD(vpool, v_s, c + 1, bar_v);
  }
#undef FD_LOAD

  // the key groups' sums in group order: this split's acc [rep, Dh]
  if (kg < groups) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rep) {
        red_s[(kg * R + r) * Dh + 2 * cp] = acc[r][0];
        red_s[(kg * R + r) * Dh + 2 * cp + 1] = acc[r][1];
      }
    }
  }
  __syncthreads();
  auto block_acc = [=](int o) {
    const int r = o / Dh, d = o - r * Dh;
    float v = 0.f;
    for (int k = 0; k < groups; ++k) v += red_s[(k * R + r) * Dh + d];
    return v;
  };
  if (live == 1) {                          // the whole row in this block
    for (int o = tid; o < rep * Dh; o += kFdThreads) {
      const float l = ml_s[R + o / Dh];
      og[o] = from_f32<T>(block_acc(o) / (l == 0.f ? 1.f : l));
    }
    return;
  }
  // write this split's (acc, m, l) to the scratch; the last of the row's
  // live splits to take its ticket merges them and resets the ticket
  const int stride = rep * (Dh + 2);
  float* rowp = a.part + static_cast<size_t>(row) * a.splits * stride;
  float* mine = rowp + static_cast<size_t>(split) * stride;
  for (int o = tid; o < rep * Dh; o += kFdThreads) mine[o] = block_acc(o);
  if (tid < rep) {
    mine[rep * Dh + tid] = ml_s[tid];
    mine[rep * Dh + rep + tid] = ml_s[R + tid];
  }
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.ticket + row, 1u) == static_cast<unsigned>(live - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each output's partials in split order, one pass (the running max
  // rescales the sums), every split's loads in flight together
  for (int o = tid; o < rep * Dh; o += kFdThreads) {
    const int r = o / Dh;
    float mx = kNegInf, l = 0.f, v = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) {
      const float* ps = rowp + sp * stride;
      const float ms = __ldcg(ps + rep * Dh + r), ls = __ldcg(ps + rep * Dh + rep + r);
      const float as = __ldcg(ps + o);
      const float m_new = fmaxf(mx, ms);
      const float a_old = expf(mx - m_new), a_new = expf(ms - m_new);
      l = fmaf(l, a_old, ls * a_new);
      v = fmaf(v, a_old, as * a_new);
      mx = m_new;
    }
    og[o] = from_f32<T>(v / (l == 0.f ? 1.f : l));
  }
  if (tid == 0) a.ticket[row] = 0u;         // ready for the next launch on this stream
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmemDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int grid_for(int n, int vec) { return (n + kCV * vec - 1) / (kCV * vec); }

// Two 256-thread blocks per SM where the grid has more blocks than the card
// has SMs (all of them resident in one wave), one 512-thread block per SM
// otherwise: 16 warps per SM either way.
bool narrow_blocks(int grid) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return grid > sms;
}

template <typename T>
cudaError_t launch_norm_qkv(const void* x, const void* scale, const void* bias, const void* w,
                            const void* bqkv, void* out, int B, int D, int N, int kind,
                            float eps, cudaStream_t s) {
  const int grid = grid_for(N, Pack<T>::N);
  const bool narrow = narrow_blocks(grid);
  auto kernel = narrow ? norm_qkv_kernel<T, kThreadsNarrow> : norm_qkv_kernel<T, kThreadsWide>;
  const size_t smem = static_cast<size_t>(min(B, kBT)) * D * sizeof(T);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, narrow ? kThreadsNarrow : kThreadsWide, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<const T*>(w), static_cast<const T*>(bqkv), static_cast<T*>(out), B, D, N,
      kind, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_proj_norm(const void* ctx, const void* resid, const void* wo, const void* bo,
                             const void* scale, const void* bias, void* r, void* h, void* r32,
                             void* ticket, int B, int M, int D, int kind, float eps, int parallel,
                             cudaStream_t s) {
  const int grid = grid_for(D, Pack<T>::N);
  const bool narrow = narrow_blocks(grid);
  auto kernel = narrow ? proj_norm_kernel<T, kThreadsNarrow> : proj_norm_kernel<T, kThreadsWide>;
  const size_t smem = static_cast<size_t>(min(B, kBT)) * M * sizeof(T);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, narrow ? kThreadsNarrow : kThreadsWide, smem, s>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(resid), static_cast<const T*>(wo),
      static_cast<const T*>(bo), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(r), static_cast<T*>(h), static_cast<float*>(r32),
      static_cast<unsigned int*>(ticket), B, M, D, kind, eps, parallel);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mlp(const void* h, const void* r, const void* wu, const void* wg,
                       const void* wd, const void* bu, const void* bg, const void* bd, void* a_t,
                       void* out, int B, int D, int F, int act, cudaStream_t s) {
  int grid = grid_for(F, Pack<T>::N);
  bool narrow = narrow_blocks(grid);
  auto act_kernel = narrow ? mlp_act_kernel<T, kThreadsNarrow>
                           : mlp_act_kernel<T, kThreadsWide>;
  const size_t smem = static_cast<size_t>(min(B, kBT)) * D * sizeof(T);
  cudaError_t e = allow_smem(act_kernel, smem);
  if (e != cudaSuccess) return e;
  act_kernel<<<grid, narrow ? kThreadsNarrow : kThreadsWide, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(wu), static_cast<const T*>(wg),
      static_cast<const T*>(bu), static_cast<const T*>(bg), static_cast<T*>(a_t), B, D, F,
      act);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  grid = grid_for(D, Pack<T>::N);
  narrow = narrow_blocks(grid);
  auto down_kernel = narrow ? mlp_down_kernel<T, kThreadsNarrow>
                            : mlp_down_kernel<T, kThreadsWide>;
  down_kernel<<<grid, narrow ? kThreadsNarrow : kThreadsWide, 0, s>>>(
      static_cast<const T*>(a_t), static_cast<const T*>(wd), static_cast<const T*>(bd),
      static_cast<const T*>(r), static_cast<T*>(out), B, F, D);
  return cudaGetLastError();
}

// Multiprocessors of CUDA device `dev`, read once a device.
int sm_count(int dev) {
  static int cache[64];
  int n = dev >= 0 && dev < 64 ? cache[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev >= 0 && dev < 64) cache[dev] = n;
  }
  return n;
}

// Make `dev` the current device for the scope, only if it is not already.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != dev) {
      err = cudaSetDevice(dev);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// The grid of a [K, N] product: one block an SM where the column tiles are
// fewer than the SMs (the contraction split into that many runs of chunks),
// else one block a tile.
Q8Grid q8_grid(int K, int N, int sms) {
  Q8Grid g;
  g.tiles = (N + kQ8TN - 1) / kQ8TN;
  g.chunks = (K + kQ8TK - 1) / kQ8TK;
  const int want = max(1, min(g.chunks, sms / g.tiles));
  g.cps = (g.chunks + want - 1) / want;
  g.splits = (g.chunks + g.cps - 1) / g.cps;
  return g;
}

// The workspace: a [kBT, F] bf16, then the fp32 partials of whichever
// launch has more (the two run one after the other).
size_t q8_a_bytes(int F) { return (static_cast<size_t>(kBT) * F * 2 + 255) / 256 * 256; }

size_t q8_workspace_bytes(int D, int F, int nm, int sms) {
  const Q8Grid ga = q8_grid(D, F, sms), gd = q8_grid(F, D, sms);
  const size_t part_a =
      ga.splits > 1 ? static_cast<size_t>(ga.tiles) * ga.splits * nm * kBT * kQ8TN : 0;
  const size_t part_d =
      gd.splits > 1 ? static_cast<size_t>(gd.tiles) * gd.splits * kBT * kQ8TN : 0;
  return q8_a_bytes(F) + 4 * max(part_a, part_d);
}

// The ring exceeds the default 48 KB: opt in once a kernel and device.
template <typename K>
cudaError_t q8_allow_smem(K kernel, int bytes, int dev, unsigned long long& done) {
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

template <int NM, bool kWide>
cudaError_t launch_q8_act(const Q8Grid& g, const void* h, const void* wu, const void* wg,
                          const void* su, const void* sg, const void* bu, const void* bg, void* a,
                          void* part, void* ticket, int bc, int D, int F, int act, int dev,
                          cudaStream_t s) {
  static unsigned long long ready = 0;
  constexpr int smem = kQ8Stages * q8_stage_bytes(NM);
  const cudaError_t e = q8_allow_smem(mlp_act_int8_mma_kernel<NM, kWide>, smem, dev, ready);
  if (e != cudaSuccess) return e;
  mlp_act_int8_mma_kernel<NM, kWide><<<g.tiles * g.splits, kQ8Threads, smem, s>>>(
      g, static_cast<const __nv_bfloat16*>(h), static_cast<const int8_t*>(wu),
      static_cast<const int8_t*>(wg), static_cast<const float*>(su),
      static_cast<const float*>(sg), static_cast<const __nv_bfloat16*>(bu),
      static_cast<const __nv_bfloat16*>(bg), static_cast<__nv_bfloat16*>(a),
      static_cast<float*>(part), static_cast<unsigned int*>(ticket), bc, D, F, act);
  return cudaGetLastError();
}

template <bool kWide>
cudaError_t launch_q8_down(const Q8Grid& g, const void* a, const void* wd, const void* sd,
                           const void* bd, const void* r, void* out, void* part, void* ticket,
                           int bc, int F, int D, int dev, cudaStream_t s) {
  static unsigned long long ready = 0;
  constexpr int smem = kQ8Stages * q8_stage_bytes(1);
  const cudaError_t e = q8_allow_smem(mlp_down_int8_mma_kernel<kWide>, smem, dev, ready);
  if (e != cudaSuccess) return e;
  mlp_down_int8_mma_kernel<kWide><<<g.tiles * g.splits, kQ8Threads, smem, s>>>(
      g, static_cast<const __nv_bfloat16*>(a), static_cast<const int8_t*>(wd),
      static_cast<const float*>(sd), static_cast<const __nv_bfloat16*>(bd),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<unsigned int*>(ticket), bc, F, D);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch_mlp_int8(const void* h, const void* r, const void* wu, const void* wg,
                            const void* wd, const void* su, const void* sg, const void* sd,
                            const void* bu, const void* bg, const void* bd, void* work,
                            void* ticket, void* out, int B, int D, int F, int act, int dev,
                            cudaStream_t s) {
  if (F <= 0) return cudaErrorInvalidValue;
  const int sms = sm_count(dev);
  const Q8Grid pa = q8_grid(D, F, sms), pd = q8_grid(F, D, sms);
  if (pa.tiles > kQ8MaxTiles || pd.tiles > kQ8MaxTiles) return cudaErrorInvalidValue;
  void* a = work;
  void* part = static_cast<char*>(work) + q8_a_bytes(F);
  const bool wide_a = F % 16 == 0 && aligned16(wu) && (wg == nullptr || aligned16(wg));
  const bool wide_d = D % 16 == 0 && aligned16(wd);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int bc = min(kBT, B - b0);
    const __nv_bfloat16* hp = hb + static_cast<size_t>(b0) * D;
    cudaError_t e;
    if (wg != nullptr)
      e = wide_a ? launch_q8_act<2, true>(pa, hp, wu, wg, su, sg, bu, bg, a, part, ticket, bc, D, F, act, dev, s)
                 : launch_q8_act<2, false>(pa, hp, wu, wg, su, sg, bu, bg, a, part, ticket, bc, D, F, act, dev, s);
    else
      e = wide_a ? launch_q8_act<1, true>(pa, hp, wu, wg, su, sg, bu, bg, a, part, ticket, bc, D, F, act, dev, s)
                 : launch_q8_act<1, false>(pa, hp, wu, wg, su, sg, bu, bg, a, part, ticket, bc, D, F, act, dev, s);
    if (e != cudaSuccess) return e;
    const size_t off = static_cast<size_t>(b0) * D;
    e = wide_d ? launch_q8_down<true>(pd, a, wd, sd, bd, rb + off, ob + off, part, ticket, bc, F, D, dev, s)
               : launch_q8_down<false>(pd, a, wd, sd, bd, rb + off, ob + off, part, ticket, bc, F, D, dev, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The tensor-core GEMVs' grid (the kernels' note above g16_range) over
// `cap` resident blocks (SMs x the kernel's blocks an SM) and tiles of `tn`
// columns: split mode as q8_grid; even mode (more column tiles than resident
// blocks, so that proj_norm's cooperative grid stays resident) one block a
// slot, each an equal run of units.
G16Grid g16_grid(int K, int N, int tn, int cap) {
  G16Grid g;
  g.tiles = (N + tn - 1) / tn;
  g.k16 = (K + 15) / 16;
  g.even = g.tiles > cap;
  if (g.even) {
    const long long units = static_cast<long long>(g.tiles) * g.k16;
    g.sps = 0;
    g.blocks = static_cast<int>(min(static_cast<long long>(cap), units));
    const int fewest = static_cast<int>(units / g.blocks);  // units of the shortest run
    g.slots = (g.k16 + fewest - 1) / fewest + 1;
  } else {
    const int want = max(1, min(g.k16, cap / g.tiles));
    g.sps = (g.k16 + want - 1) / want;
    g.slots = (g.k16 + g.sps - 1) / g.sps;
    g.blocks = g.tiles * g.slots;
  }
  return g;
}

template <class C>
G16Grid g16_grid_of(int K, int N, int dev) {
  return g16_grid(K, N, C::kTN, sm_count(dev) * C::kBps);
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The fp32 partials of a grid's shared tiles.
template <class C>
size_t g16_part_bytes(const G16Grid& g) {
  return g.slots > 1 ? static_cast<size_t>(g.tiles) * g.slots * C::kTileFloats * 4 : 0;
}

// The workspace of a norm_qkv or proj_norm pass: r32 [kBT, N], the tiles'
// row statistics, then the partials of shared tiles.
template <class C>
size_t g16_workspace_bytes(int K, int N, int dev) {
  const G16Grid g = g16_grid_of<C>(K, N, dev);
  return align256(static_cast<size_t>(kBT) * N * 4) +
         align256(static_cast<size_t>(g.tiles) * kBT * sizeof(float2)) + g16_part_bytes<C>(g);
}

// The 16-bit MLP's workspace: `a` [kBT, F], then the partials of whichever
// launch has more (the down launch writes its own only once the act launch
// has ended).
size_t mlp16_workspace_bytes(int D, int F, bool glu, int dev) {
  const size_t pa = glu ? g16_part_bytes<MlpActCfg>(g16_grid_of<MlpActCfg>(D, F, dev))
                        : g16_part_bytes<MlpAct1Cfg>(g16_grid_of<MlpAct1Cfg>(D, F, dev));
  const size_t pd = g16_part_bytes<MlpDownCfg>(g16_grid_of<MlpDownCfg>(F, D, dev));
  return align256(static_cast<size_t>(kBT) * F * 2) + max(pa, pd);
}

// A ring beyond the default 48 KB: opt each kernel in once a device.
cudaError_t g16_allow_smem(const void* kernel, int bytes, int dev) {
  static const void* keys[32];
  static unsigned long long done[32];
  static int n = 0;
  int i = 0;
  while (i < n && keys[i] != kernel) ++i;
  const unsigned long long bit = 1ull << (dev & 63);
  if (i < n && (done[i] & bit)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && (i < n || n < 32)) {
    if (i == n) {
      keys[n++] = kernel;
      done[i] = 0;
    }
    done[i] |= bit;
  }
  return e;
}

// How a g16 grid launches: plainly; cooperatively (proj_norm's blocks meet
// at a grid barrier: the launch fails, and never hangs, unless the whole
// grid is resident); or as a programmatic dependent of the launch before
// it on the stream (the MLP's down launch).
enum G16Launch { kLaunchPlain = 0, kLaunchCooperative = 1, kLaunchPdl = 2 };

cudaError_t g16_launch(void (*kernel)(G16Args), int smem, const G16Args& a, int dev,
                       cudaStream_t s, int mode) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  const cudaError_t e = g16_allow_smem(fn, smem, dev);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<G16Args*>(&a)};
  if (mode == kLaunchCooperative)
    return cudaLaunchCooperativeKernel(fn, dim3(a.g.blocks), dim3(kGThreads), args, smem, s);
  if (mode == kLaunchPdl) {
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    at[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.g.blocks);
    cfg.blockDim = dim3(kGThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    return cudaLaunchKernelExC(&cfg, fn, args);
  }
  kernel<<<a.g.blocks, kGThreads, smem, s>>>(a);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Weight element types of the TMA maps.
enum G16Type { kTypeBf16 = 0, kTypeF16 = 1, kTypeU8 = 2 };

template <typename T, class C>
constexpr int g16_type() {
  return sizeof(typename C::W) == 1 ? kTypeU8 : std::is_same<T, __half>::value ? kTypeF16 : kTypeBf16;
}

// w [K, N] as TMA boxes of `rows` rows x 128 bytes, 128-byte swizzle, the
// copies' L2 promotion 128 or 256 bytes.  A map depends on nothing but
// these arguments, so the last one made for each (address, shape, type,
// box, promotion) is kept and reused: a decode step asks for the same
// weights' maps every layer and token.
cudaError_t g16_wmap(CUtensorMap* map, const void* w, int K, int N, int type, int rows,
                     int promo) {
  struct Entry {
    const void* w;
    int K, N, type, rows, promo;
    CUtensorMap map;
  };
  static Entry cache[512];
  static std::mutex lock;
  Entry& slot = cache[((reinterpret_cast<uintptr_t>(w) >> 8) ^ static_cast<uintptr_t>(N) * 7 ^
                       static_cast<uintptr_t>(rows)) % 512];
  {
    const std::lock_guard<std::mutex> hold(lock);
    if (slot.w == w && slot.K == K && slot.N == N && slot.type == type && slot.rows == rows &&
        slot.promo == promo) {
      *map = slot.map;
      return cudaSuccess;
    }
  }
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return cudaErrorNotSupported;
  }
  const int esz = type == kTypeU8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kGBox / esz), static_cast<cuuint32_t>(rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType dt = type == kTypeU8   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : type == kTypeF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, dt, 2, const_cast<void*>(w), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            promo == 256 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                                         : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const std::lock_guard<std::mutex> hold(lock);
  slot = Entry{w, K, N, type, rows, promo, *map};
  return cudaSuccess;
}

// norm_qkv and proj_norm: one launch a pass of kBT rows: the pass's rows of
// x / ctx, resid, out / r and h; the workspace split as
// g16_workspace_bytes lays it out.  `tma`: the weight's rows are whole
// 16-byte multiples (else int8 codes come by cp.async).
template <typename T, int kKind, class C>
cudaError_t g16_passes(G16Args a, int B, void* work, void (*kernel)(G16Args), bool tma,
                       int dev, cudaStream_t s) {
  a.g = g16_grid_of<C>(a.K, a.N, dev);
  if (a.g.tiles > kGMaxTiles) return cudaErrorInvalidValue;
  if (tma) {
    const cudaError_t me =
        g16_wmap(&a.wmap[0], a.w[0], a.K, a.N, g16_type<T, C>(), C::kTK, kG16L2Promo);
    if (me != cudaSuccess) return me;
  }
  char* wp = static_cast<char*>(work);
  const size_t r32 = align256(static_cast<size_t>(kBT) * a.N * 4);
  a.r32 = reinterpret_cast<float*>(wp);
  a.stats = reinterpret_cast<float2*>(wp + r32);
  a.part = reinterpret_cast<float*>(
      wp + r32 + align256(static_cast<size_t>(a.g.tiles) * kBT * sizeof(float2)));
  const T* x = static_cast<const T*>(a.x);
  const T* resid = static_cast<const T*>(a.resid);
  T* out = static_cast<T*>(a.out);
  T* h = static_cast<T*>(a.h);
  for (int b0 = 0; b0 < B; b0 += kBT) {
    a.bc = min(kBT, B - b0);
    a.x = x + static_cast<size_t>(b0) * a.K;
    a.out = out + static_cast<size_t>(b0) * a.N;
    if (kKind == kProj) {
      a.resid = resid + static_cast<size_t>(b0) * a.N;
      a.h = h + static_cast<size_t>(b0) * a.N;
    }
    const cudaError_t e = g16_launch(kernel, C::kSmem, a, dev, s,
                                     kKind == kProj ? kLaunchCooperative : kLaunchPlain);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t g16_norm_qkv(const void* x, const void* scale, const void* bias, const void* w,
                         const void* bqkv, void* out, void* work, void* ticket, int B, int D,
                         int N, int kind, float eps, int dev, cudaStream_t s) {
  G16Args a{};
  a.x = x; a.w[0] = w; a.wb[0] = bqkv; a.scale = scale; a.bias = bias; a.out = out;
  a.ticket = static_cast<unsigned int*>(ticket);
  a.K = D; a.N = N; a.kind = kind; a.eps = eps;
  return g16_passes<T, kQkv, QkvCfg>(a, B, work, norm_qkv_mma_kernel<T>, true, dev, s);
}

template <typename T>
cudaError_t g16_proj_norm(const void* ctx, const void* resid, const void* wo, const void* bo,
                          const void* scale, const void* bias, void* r, void* h, void* work,
                          void* ticket, int B, int M, int D, int kind, float eps, int parallel,
                          int dev, cudaStream_t s) {
  G16Args a{};
  a.x = ctx; a.w[0] = wo; a.wb[0] = bo; a.scale = scale; a.bias = bias; a.resid = resid;
  a.out = r; a.h = h;
  a.ticket = static_cast<unsigned int*>(ticket);
  a.K = M; a.N = D; a.kind = kind; a.eps = eps; a.parallel = parallel;
  return g16_passes<T, kProj, ProjCfg>(a, B, work, proj_norm_mma_kernel<T>, true, dev, s);
}

cudaError_t q8_norm_qkv(const void* x, const void* scale, const void* bias, const void* w,
                        const void* wscale, const void* bqkv, void* out, void* work,
                        void* ticket, int B, int D, int N, int kind, float eps, int dev,
                        cudaStream_t s) {
  if (N % 8 || D % 8) return cudaErrorInvalidValue;
  G16Args a{};
  a.x = x; a.w[0] = w; a.ws = static_cast<const float*>(wscale); a.wb[0] = bqkv;
  a.scale = scale; a.bias = bias; a.out = out;
  a.ticket = static_cast<unsigned int*>(ticket);
  a.K = D; a.N = N; a.kind = kind; a.eps = eps;
  const bool tma = N % 16 == 0 && aligned16(w);
  return g16_passes<__nv_bfloat16, kQkv, Qkv8Cfg>(
      a, B, work, tma ? norm_qkv_int8_mma_kernel<true> : norm_qkv_int8_mma_kernel<false>, tma,
      dev, s);
}

cudaError_t q8_proj_norm(const void* ctx, const void* resid, const void* wo, const void* wscale,
                         const void* bo, const void* scale, const void* bias, void* r, void* h,
                         void* work, void* ticket, int B, int M, int D, int kind, float eps,
                         int parallel, int dev, cudaStream_t s) {
  if (M % 8 || D % 8) return cudaErrorInvalidValue;
  G16Args a{};
  a.x = ctx; a.w[0] = wo; a.ws = static_cast<const float*>(wscale); a.wb[0] = bo;
  a.scale = scale; a.bias = bias; a.resid = resid; a.out = r; a.h = h;
  a.ticket = static_cast<unsigned int*>(ticket);
  a.K = M; a.N = D; a.kind = kind; a.eps = eps; a.parallel = parallel;
  const bool tma = D % 16 == 0 && aligned16(wo);
  return g16_passes<__nv_bfloat16, kProj, Proj8Cfg>(
      a, B, work, tma ? proj_norm_int8_mma_kernel<true> : proj_norm_int8_mma_kernel<false>, tma,
      dev, s);
}

// The 16-bit MLP: two launches a pass of kBT rows, the act launch's `a` and
// both launches' partials in the workspace (mlp16_workspace_bytes), the
// down kernel a programmatic dependent of the act kernel.
template <typename T>
cudaError_t launch_mlp16(const void* h, const void* r, const void* wu, const void* wg,
                         const void* wd, const void* bu, const void* bg, const void* bd,
                         void* work, void* ticket, void* out, int B, int D, int F, int act,
                         int dev, cudaStream_t s) {
  if (D % 8 || F % 8) return cudaErrorInvalidValue;
  constexpr int type = std::is_same<T, __half>::value ? kTypeF16 : kTypeBf16;
  const bool glu = wg != nullptr;
  G16Args pa{}, pd{};
  pa.g = glu ? g16_grid_of<MlpActCfg>(D, F, dev) : g16_grid_of<MlpAct1Cfg>(D, F, dev);
  pd.g = g16_grid_of<MlpDownCfg>(F, D, dev);
  if (pa.g.tiles > kGMaxTiles || pd.g.tiles > kGMaxTiles) return cudaErrorInvalidValue;
  const int rows = glu ? MlpActCfg::kTK : MlpAct1Cfg::kTK;
  cudaError_t e = g16_wmap(&pa.wmap[0], wu, D, F, type, rows, kG16L2Promo);
  if (e == cudaSuccess && glu) e = g16_wmap(&pa.wmap[1], wg, D, F, type, rows, kG16L2Promo);
  if (e == cudaSuccess) e = g16_wmap(&pd.wmap[0], wd, F, D, type, MlpDownCfg::kTK, kG16L2Promo);
  if (e != cudaSuccess) return e;
  T* a_buf = static_cast<T*>(work);
  float* part = reinterpret_cast<float*>(static_cast<char*>(work) +
                                         align256(static_cast<size_t>(kBT) * F * 2));
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  pa.w[0] = wu; pa.w[1] = wg; pa.wb[0] = bu; pa.wb[1] = bg; pa.out = a_buf;
  pa.part = part; pa.ticket = tk; pa.K = D; pa.N = F; pa.act = act;
  pd.x = a_buf; pd.w[0] = wd; pd.wb[0] = bd; pd.part = part; pd.ticket = tk;
  pd.K = F; pd.N = D;
  void (*act_kernel)(G16Args) =
      glu ? mlp_act_mma_kernel<T, MlpActCfg> : mlp_act_mma_kernel<T, MlpAct1Cfg>;
  const int act_smem = glu ? MlpActCfg::kSmem : MlpAct1Cfg::kSmem;
  for (int b0 = 0; b0 < B; b0 += kBT) {
    pa.bc = pd.bc = min(kBT, B - b0);
    pa.x = static_cast<const T*>(h) + static_cast<size_t>(b0) * D;
    pd.resid = static_cast<const T*>(r) + static_cast<size_t>(b0) * D;
    pd.out = static_cast<T*>(out) + static_cast<size_t>(b0) * D;
    e = g16_launch(act_kernel, act_smem, pa, dev, s, kLaunchPlain);
    if (e == cudaSuccess)
      e = g16_launch(mlp_down_mma_kernel<T>, MlpDownCfg::kSmem, pd, dev, s, kLaunchPdl);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename T, int R>
cudaError_t launch_fd(FdArgs a, int B, cudaStream_t s) {
  if (static_cast<size_t>(a.chunk) * a.Dh * sizeof(T) > kFdChunkBytes) return cudaErrorInvalidValue;
  const size_t smem = fd_smem_bytes(a.Dh, R, a.chunk, sizeof(T));
  const cudaError_t e = allow_smem(flash_decode_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  // passes of at most kFdMaxRows (slot, KV head) rows: one ticket a row
  const int bp = kFdMaxRows / a.Hkv;
  const size_t qrow = static_cast<size_t>(a.H) * a.Dh;
  const size_t crow = static_cast<size_t>(a.Hkv) * a.page * a.Dh;  // contiguous: a row's cache
  FdArgs p = a;
  for (int b0 = 0; b0 < B; b0 += bp) {
    const int nb = min(bp, B - b0);
    p.q = static_cast<const T*>(a.q) + b0 * qrow;
    p.out = static_cast<T*>(a.out) + b0 * qrow;
    if (a.pos != nullptr) p.pos = a.pos + static_cast<size_t>(b0) * a.pos_stride;
    if (a.table != nullptr) {
      p.table = a.table + static_cast<size_t>(b0) * a.maxp;
    } else {
      p.kpool = static_cast<const T*>(a.kpool) + b0 * crow;
      p.vpool = static_cast<const T*>(a.vpool) + b0 * crow;
    }
    flash_decode_kernel<T, R><<<dim3(nb * a.Hkv, a.splits), kFdThreads, smem, s>>>(p);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return le;
  }
  return cudaSuccess;
}

// Blocks of flash_decode_kernel<T, R> an SM holds at once (-1 on an error).
template <typename T, int R>
int fd_resident(int Dh, int chunk) {
  const size_t smem = fd_smem_bytes(Dh, R, chunk, sizeof(T));
  int n = -1;
  if (allow_smem(flash_decode_kernel<T, R>, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_decode_kernel<T, R>, kFdThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// R: the power of two at or above rep.
template <typename T>
int fd_resident_r(int Dh, int rep, int chunk) {
  if (rep == 1) return fd_resident<T, 1>(Dh, chunk);
  if (rep == 2) return fd_resident<T, 2>(Dh, chunk);
  if (rep <= 4) return fd_resident<T, 4>(Dh, chunk);
  return fd_resident<T, 8>(Dh, chunk);
}

template <typename T>
cudaError_t launch_fd_r(const FdArgs& a, int B, int rep, cudaStream_t s) {
  if (rep == 1) return launch_fd<T, 1>(a, B, s);
  if (rep == 2) return launch_fd<T, 2>(a, B, s);
  if (rep <= 4) return launch_fd<T, 4>(a, B, s);
  return launch_fd<T, 8>(a, B, s);
}

// The checks the wrappers make, again: a chunk of 16 to 128 keys (a power
// of two: threads a key for the scores), up to kFdMaxSplits splits.
int launch_flash_decode(const FdArgs& a, int B, int dtype, int device, cudaStream_t s) {
  const int rep = a.Hkv > 0 ? a.H / a.Hkv : 0;
  const int C = a.chunk;
  if (rep < 1 || rep > 8 || a.H % a.Hkv || a.Dh <= 0 || a.Dh % 8 || a.Dh > 256 ||
      a.page <= 0 || a.maxp <= 0 || a.Hkv > kFdMaxRows || C < 16 || C > 128 || (C & (C - 1)) ||
      a.splits < 1 || a.splits > kFdMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  switch (dtype) {
    case 0: return launch_fd_r<float>(a, B, rep, s);
    case 1: return launch_fd_r<__nv_bfloat16>(a, B, rep, s);
    case 2: return launch_fd_r<__half>(a, B, rep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x [B, D], scale/bias [D] (bias may be null), w [D, N], bqkv [N] or null,
// out [B, N]; one dtype (0 = float32, 1 = bfloat16, 2 = float16); kind
// 0 = rmsnorm, 1 = layernorm.  N must be a multiple of 16 / itemsize and w,
// out 16-byte aligned; bf16 and fp16 (the tensor cores) also need D a
// multiple of 8 and x, scale, bias 16-byte aligned (the wrapper checks).
// `work` ds_gemv16_workspace(D, N, 0, device) bytes (256-byte aligned) and
// `ticket` ds_ticket_count() zeroed uint32 whose counts the kernels leave at 0,
// both used by bf16 and fp16 only; on `stream` of CUDA device `device` (made
// current for the call if it is not).
int ds_fused_norm_qkv(const void* x, const void* scale, const void* bias, const void* w,
                      const void* bqkv, void* out, void* work, void* ticket, int B, int D,
                      int N, int kind, float eps, int dtype, void* stream, int device) {
  if (B <= 0 || N <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_norm_qkv<float>(x, scale, bias, w, bqkv, out, B, D, N, kind, eps, s);
    case 1: return g16_norm_qkv<__nv_bfloat16>(x, scale, bias, w, bqkv, out, work, ticket, B, D, N, kind, eps, device, s);
    case 2: return g16_norm_qkv<__half>(x, scale, bias, w, bqkv, out, work, ticket, B, D, N, kind, eps, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8-weight body on the tensor cores: bf16 x, scale, bias, bqkv and
// out (x, scale, bias 16-byte aligned, D a multiple of 8); w [D, N] int8
// codes (8-byte aligned, N a multiple of 8; rows of whole 16 bytes go by
// the TMA), wscale [N] fp32; `work` ds_gemv16_workspace(D, N, 2, device)
// bytes and `ticket` as ds_fused_norm_qkv's.
int ds_fused_norm_qkv_int8(const void* x, const void* scale, const void* bias, const void* w,
                           const void* wscale, const void* bqkv, void* out, void* work,
                           void* ticket, int B, int D, int N, int kind, float eps, void* stream,
                           int device) {
  if (B <= 0 || N <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  return static_cast<int>(q8_norm_qkv(x, scale, bias, w, wscale, bqkv, out, work, ticket, B, D,
                                      N, kind, eps, device, static_cast<cudaStream_t>(stream)));
}

// Bytes of the workspace the tensor-core norm_qkv (kind 0), proj_norm
// (kind 1), int8 norm_qkv (kind 2) or int8 proj_norm (kind 3) take for a
// [K, N] weight on CUDA device `device`.
long long ds_gemv16_workspace(int K, int N, int kind, int device) {
  const size_t n = kind == 1   ? g16_workspace_bytes<ProjCfg>(K, N, device)
                   : kind == 2 ? g16_workspace_bytes<Qkv8Cfg>(K, N, device)
                   : kind == 3 ? g16_workspace_bytes<Proj8Cfg>(K, N, device)
                               : g16_workspace_bytes<QkvCfg>(K, N, device);
  return static_cast<long long>(n);
}

// The uint32 tickets a (device, stream) gives the kernels that merge across
// blocks: one a column tile (kQ8MaxTiles), then proj_norm's grid barrier.
int ds_ticket_count() { return kQ8MaxTiles + 1; }

// q [B, H, Dh]; kpool/vpool the layer's [P, Hkv, page, Dh] slice; pos [B]
// and table [B, maxp] int64; slopes [H] fp32 or null; out [B, H, Dh].
// Dh a multiple of 8 up to 256 and H / Hkv <= 8 (the wrapper checks).  The
// grid: (B * Hkv, splits) blocks over chunks of `chunk` keys; `work` fp32
// scratch of min(B, kFdMaxRows / Hkv) * Hkv * splits * rep * (Dh + 2) floats
// (used where splits > 1), `ticket` ds_ticket_count() zeroed uint32 whose
// counts the kernel leaves at 0.  On `stream` of CUDA device `device` (made
// current for the call if it is not).
int ds_flash_decode_paged(const void* q, const void* kpool, const void* vpool, const void* pos,
                          const void* table, const void* slopes, void* out, void* work,
                          void* ticket, int B, int H, int Hkv, int Dh, int page, int maxp,
                          int chunk, int splits, float scale, int dtype, void* stream,
                          int device) {
  if (B <= 0) return 0;
  FdArgs a{q, kpool, vpool, static_cast<const long long*>(pos),
           static_cast<const long long*>(table), static_cast<const float*>(slopes), out,
           static_cast<float*>(work), static_cast<unsigned int*>(ticket),
           H, Hkv, Dh, page, maxp, chunk, splits, scale, 0, 1};
  return launch_flash_decode(a, B, dtype, device, static_cast<cudaStream_t>(stream));
}

// The contiguous cache: kcache/vcache the layer's [B, Hkv, Smax, Dh] slice;
// row b's depth is pos[b * pos_stride] (pos int64; stride 0 broadcasts one
// depth) or, with pos null, pos0.  Other arguments as ds_flash_decode_paged.
int ds_flash_decode_contig(const void* q, const void* kcache, const void* vcache,
                           const void* pos, long long pos0, int pos_stride, const void* slopes,
                           void* out, void* work, void* ticket, int B, int H, int Hkv, int Dh,
                           int Smax, int chunk, int splits, float scale, int dtype,
                           void* stream, int device) {
  if (B <= 0) return 0;
  FdArgs a{q, kcache, vcache, static_cast<const long long*>(pos), nullptr,
           static_cast<const float*>(slopes), out, static_cast<float*>(work),
           static_cast<unsigned int*>(ticket), H, Hkv, Dh, Smax, 1, chunk, splits, scale,
           pos0, pos_stride};
  return launch_flash_decode(a, B, dtype, device, static_cast<cudaStream_t>(stream));
}

// Blocks of flash_decode_kernel an SM of CUDA device `device` holds at once
// at head dim Dh, `rep` query heads a KV head, `chunk` keys and dtype (0
// float32, 1 bfloat16, 2 float16); -1 on an error.
int ds_flash_decode_resident(int Dh, int rep, int chunk, int dtype, int device) {
  if (rep < 1 || rep > 8 || Dh <= 0 || Dh % 8 || Dh > 256) return -1;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -1;
  switch (dtype) {
    case 0: return fd_resident_r<float>(Dh, rep, chunk);
    case 1: return fd_resident_r<__nv_bfloat16>(Dh, rep, chunk);
    case 2: return fd_resident_r<__half>(Dh, rep, chunk);
    default: return -1;
  }
}

// Bytes of shared memory a flash_decode block takes at head dim Dh, `rep`
// query heads a KV head, `chunk` keys and `elem`-byte elements.
long long ds_flash_decode_smem(int Dh, int rep, int chunk, int elem) {
  const int R = rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : 8;
  return static_cast<long long>(fd_smem_bytes(Dh, R, chunk, elem));
}

// ctx [B, M], resid [B, D], wo [M, D], bo [D] or null, scale [D], bias [D]
// or null; outputs r, h [B, D]; `work` fp32 scratch: for float32 r32
// [B, D], for bf16 and fp16 ds_gemv16_workspace(M, D, 1, device) bytes (256-byte
// aligned; also M a multiple of 8, ctx 16-byte aligned); `ticket`
// ds_ticket_count() zeroed uint32 whose counts the kernels leave at 0.  On `stream` of
// CUDA device `device` (made current for the call if it is not).
int ds_fused_proj_norm(const void* ctx, const void* resid, const void* wo, const void* bo,
                       const void* scale, const void* bias, void* r, void* h, void* work,
                       void* ticket, int B, int M, int D, int kind, float eps, int parallel,
                       int dtype, void* stream, int device) {
  if (B <= 0 || D <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_proj_norm<float>(ctx, resid, wo, bo, scale, bias, r, h, work, ticket, B, M, D, kind, eps, parallel, s);
    case 1: return g16_proj_norm<__nv_bfloat16>(ctx, resid, wo, bo, scale, bias, r, h, work, ticket, B, M, D, kind, eps, parallel, device, s);
    case 2: return g16_proj_norm<__half>(ctx, resid, wo, bo, scale, bias, r, h, work, ticket, B, M, D, kind, eps, parallel, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8-weight body on the tensor cores: bf16 ctx, resid, bo, scale,
// bias, r and h (ctx 16-byte aligned, M a multiple of 8); wo [M, D] int8
// codes (8-byte aligned, D a multiple of 8; rows of whole 16 bytes go by the
// TMA), wscale [D] fp32; `work` ds_gemv16_workspace(M, D, 3, device) bytes
// and `ticket` as ds_fused_proj_norm's.  A cooperative launch a pass of 8
// rows.
int ds_fused_proj_norm_int8(const void* ctx, const void* resid, const void* wo,
                            const void* wscale, const void* bo, const void* scale,
                            const void* bias, void* r, void* h, void* work, void* ticket, int B,
                            int M, int D, int kind, float eps, int parallel, void* stream,
                            int device) {
  if (B <= 0 || D <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  return static_cast<int>(q8_proj_norm(ctx, resid, wo, wscale, bo, scale, bias, r, h, work,
                                       ticket, B, M, D, kind, eps, parallel, device,
                                       static_cast<cudaStream_t>(stream)));
}

// h, r [B, D]; wu, wg [D, F] (wg null: no gate); wd [F, D]; biases or null;
// out [B, D]; act 0 silu, 1 gelu (tanh), 2 gelu_exact, 3 relu; D and F
// multiples of 16 / itemsize, every tensor 16-byte aligned (the wrapper
// checks).  bf16 and fp16 run on the tensor cores (mlp_act_mma_kernel, then
// mlp_down_mma_kernel as its programmatic dependent, a pass of 8 rows),
// fp32 on the FFMA kernels;
// `work` ds_fused_mlp_workspace bytes (256-byte aligned) and `ticket`
// ds_ticket_count() zeroed uint32 that the kernels leave at 0.  Two
// launches a pass on `stream` of CUDA device `device` (made current for the
// call if it is not).
int ds_fused_mlp(const void* h, const void* r, const void* wu, const void* wg, const void* wd,
                 const void* bu, const void* bg, const void* bd, void* work, void* ticket,
                 void* out, int B, int D, int F, int act, int dtype, void* stream,
                 int device) {
  if (B <= 0 || D <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_mlp<float>(h, r, wu, wg, wd, bu, bg, bd, work, out, B, D, F, act, s);
    case 1: return launch_mlp16<__nv_bfloat16>(h, r, wu, wg, wd, bu, bg, bd, work, ticket, out, B, D, F, act, device, s);
    case 2: return launch_mlp16<__half>(h, r, wu, wg, wd, bu, bg, bd, work, ticket, out, B, D, F, act, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of the workspace ds_fused_mlp needs for B rows of D and an F-wide
// MLP (a gate when glu) in `dtype` on CUDA device `device`: fp32's [F, B]
// activations, or the tensor-core launches' `a` and partials.
long long ds_fused_mlp_workspace(int B, int D, int F, int glu, int dtype, int device) {
  if (dtype == 0) return static_cast<long long>(align256(static_cast<size_t>(F) * B * 4));
  return static_cast<long long>(mlp16_workspace_bytes(D, F, glu != 0, device));
}

// The int8-weight MLP on the tensor cores: bf16 h, r, biases and out
// [B, D]; wu, wg [D, F] and wd [F, D] int8 codes (8-byte aligned; D, F
// multiples of 8; h 16-byte aligned) with their fp32 scales su, sg [F] (wg
// and sg null without a gate), sd [D]; `work` ds_fused_mlp_int8_workspace
// bytes (256-byte aligned); `ticket` ds_ticket_count() zeroed uint32 that the
// kernels leave at 0.  Two launches a pass of 8 rows, on `stream` of CUDA
// device `device` (made current for the call if it is not).
int ds_fused_mlp_int8(const void* h, const void* r, const void* wu, const void* wg,
                      const void* wd, const void* su, const void* sg, const void* sd,
                      const void* bu, const void* bg, const void* bd, void* work, void* ticket,
                      void* out, int B, int D, int F, int act, void* stream, int device) {
  if (B <= 0 || D <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  return static_cast<int>(launch_mlp_int8(h, r, wu, wg, wd, su, sg, sd, bu, bg, bd, work, ticket,
                                          out, B, D, F, act, device,
                                          static_cast<cudaStream_t>(stream)));
}

// Bytes of the workspace ds_fused_mlp_int8 needs for [B, D] rows and an
// F-wide MLP (a gate when glu) on CUDA device `device`.
long long ds_fused_mlp_int8_workspace(int D, int F, int glu, int device) {
  return static_cast<long long>(q8_workspace_bytes(D, F, glu ? 2 : 1, sm_count(device)));
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
