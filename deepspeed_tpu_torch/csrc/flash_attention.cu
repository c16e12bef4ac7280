// Causal flash attention, forward and backward, for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py `_flash_fwd` (kernel
// `_fwd_kernel`) and `_flash_bwd` (kernels `_bwd_dq_kernel` and
// `_bwd_dkv_kernel`).
//
//   forward:  o = softmax(q k^T * scale, causal) v, lse = m + log(l)   [B*H, S]
//   backward: delta = rowsum(do * o) (in the dQ launch, written for dK/dV)
//             p = exp(s - lse); ds = p * (do v^T - delta) * scale
//             dq = ds k;  dk = ds^T q;  dv = p^T do
//
// Numerics follow the Pallas kernels: scores in fp32 times `scale`, masked
// entries set to NEG_INF = -1e30 (not -inf), an online softmax with
// alpha = exp(m_prev - m_new), p rounded to the input dtype before the P.V
// product, `safe_l` (l == 0 -> 1) for empty rows, ds rounded to the input
// dtype before the dQ / dK products and p before dV.  KV tiles entirely
// above the diagonal are skipped.
//
// What bounds it on the H100: tensor-core operations.  At the llama-1b4
// training shape (B 4, H 16, S 2048, Dh 128, bf16) the forward does
// 4 B H S^2 Dh / 2 = 68.7 GFLOP (0.069 ms at 989 TFLOP/s) on 67 MB of
// q, k, v and o; the backward about 2.5x the forward's products.
//
// Design.  The TPU kernels carry m, l and the accumulator in VMEM scratch
// across the sequential KV grid axis.  Here a block owns one (b*h, q-tile)
// and loops over the KV tiles itself, with m, l and the accumulator in
// registers.  Four warps each take 16 query rows; products are
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) on tiles staged in shared
// memory with a 16-byte row pad (conflict-free ldmatrix fragment loads);
// the streamed tiles are double buffered with cp.async, so the next tile's
// copy runs under the current tile's products.  The
// backward is two launches, as in the reference: dQ (one block per q-tile,
// looping over KV tiles) and dK/dV (one block per KV tile, looping over
// q-tiles).  No atomics anywhere: two calls give the same bits.  fp32 inputs
// take a scalar path (one warp per row, lanes over the head dim, one key at a
// time) with the same semantics; it serves the fp32 reference runs, not the
// bf16 training path.  No TMA and no wgmma yet.
//
// Head dims 32, 64 and 128 (the presets' 32 of llama-tiny and mixtral-tiny,
// 64 of the GPT-2 family, 128 of the Llama family).  Nothing in the tile
// code assumes D >= 64: at D = 32 a warp holds D / 16 = 2 A fragments, the
// P.V product walks D / 8 = 4 n-tiles two at a time (D / 8 must be even),
// the fp32 path gives each lane D / 32 = 1 element, rows of D + 8 = 40
// bf16 (80 bytes) keep the ldmatrix rows on distinct banks and 16-byte
// aligned for cp.async, and the tiles need 25.6 KB (forward) of shared
// memory against 69.6 KB at D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kFwdBQ = 64;   // forward: query rows per block (16 per warp)
constexpr int kFwdBK = 64;   // forward: keys per tile
constexpr int kDqBQ = 64;    // dQ: query rows per block
constexpr int kDqBK = 32;    // dQ: keys per tile
constexpr int kKvBK = 64;    // dK/dV: keys per block (16 per warp)
constexpr int kKvBQ = 32;    // dK/dV: query rows per tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Round two floats to bf16 (nearest even, as astype) and pack them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool visible(int row, int col, int S, int causal) {
  return row < S && col < S && (!causal || row >= col);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3).  `.trans` hands each thread a column pair
// instead of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + R) of a [S, D] bf16 matrix into shared
// memory with row stride D + 8 (16-byte cp.async; rows past S are zero
// filled: the copy reads 0 source bytes).
template <int D, int R>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0, int S) {
  constexpr int kPerRow = D / 8;
  for (int c = threadIdx.x; c < R * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int k = (c % kPerRow) * 8;
    const bool in = row0 + r < S;
    const bf16* g = src + static_cast<size_t>(in ? row0 + r : 0) * D + k;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst + r * (D + 8) + k)),
                 "l"(g), "r"(in ? 16 : 0));
  }
}

// A-operand fragments of a warp's 16 rows (starting at `rows`) across the
// whole head dim, from a shared tile with row stride D + 8.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* rows, int lane) {
  const bf16* p = rows + (lane & 15) * (D + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(f[kk], p + kk * 16);
}

// acc[16 x 8*NT] += A[16 x D] . B^T where B is NT*8 rows of a shared tile
// (row stride D + 8): the "rows of B are the columns of the product" case
// (q k^T, do v^T, k q^T, v do^T).  One ldmatrix.x4 feeds two n-tiles.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* b_rows, int lane) {
  static_assert(NT % 2 == 0 && D % 16 == 0, "two n-tiles per ldmatrix.x4, k-steps of 16");
  const bf16* p = b_rows + ((lane & 7) + ((lane >> 4) << 3)) * (D + 8) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldsm_x4(b, p + nt * 8 * (D + 8) + kk * 16);
      mma_bf16(acc[nt], a[kk], b[0], b[1]);
      mma_bf16(acc[nt + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[16 x D] += P[16 x 16*KT] . B where P is held as a C-fragment array
// (rounded to bf16 here) and B is 16*KT rows of a shared tile (row stride
// D + 8): p v, ds k, p^T do, ds^T q.  ldmatrix.trans feeds two n-tiles.
template <int D, int KT>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[2 * KT][4],
                                       const bf16* b_rows, int lane) {
  static_assert((D / 8) % 2 == 0, "one ldmatrix.x4.trans feeds two n-tiles of the head dim");
  const bf16* base = b_rows + (lane & 15) * (D + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* q = base + kk * 16 * (D + 8);
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, q + nt * 8);
      mma_bf16(acc[nt], a, b[0], b[1]);
      mma_bf16(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

// Store a warp's [16 x D] fp32 accumulator rows (row0, row0 + 8 per thread
// group) as bf16, divided by div0 / div1; rows past S are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], int row0,
                                           int S, int lane, float div0, float div1) {
  const int ra = row0 + (lane >> 2);
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (ra < S)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(ra) * D + nt * 8 + c) =
          pack_bf16(acc[nt][0] / div0, acc[nt][1] / div0);
    if (ra + 8 < S)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(ra + 8) * D + nt * 8 + c) =
          pack_bf16(acc[nt][2] / div1, acc[nt][3] / div1);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: grid (q-tiles, B*H); heavy (late) q-tiles launch first.
// K/V tiles are double buffered: tile j + 1 is in flight while j is used.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int S, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = kFwdBK / 8;
  constexpr int kTile = kFwdBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kFwdBQ * LD;        // [2][kFwdBK][LD]
  bf16* sV = sK + 2 * kTile;          // [2][kFwdBK][LD]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;

  int n_tiles = (S + kFwdBK - 1) / kFwdBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kFwdBQ - 1) / kFwdBK + 1);
  load_tile_async<D, kFwdBQ>(sQ, q + base, q0, S);
  load_tile_async<D, kFwdBK>(sK, k + base, 0, S);
  load_tile_async<D, kFwdBK>(sV, v + base, 0, S);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kFwdBK;
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile_async<D, kFwdBK>(sK + nb * kTile, k + base, k0 + kFwdBK, S);
      load_tile_async<D, kFwdBK>(sV + nb * kTile, v + base, k0 + kFwdBK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) load_a_frags<D>(qf, sQ + warp * 16 * LD, lane);
    const bf16* tK = sK + (j & 1) * kTile;
    const bf16* tV = sV + (j & 1) * kTile;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_abt<D, NT>(s, qf, tK, lane);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + (lane & 3) * 2 + (e & 1);
        const int row = e < 2 ? ra : rb;
        // masking is decided on the key alone for rows past S (never stored)
        const bool ok = col < S && (!causal || row >= col);
        const float val = ok ? s[nt][e] * scale : kNegInf;
        s[nt][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = al0 * l0 + quad_sum(sum0);
    l1 = al1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= al0; acc[nt][1] *= al0;
      acc[nt][2] *= al1; acc[nt][3] *= al1;
    }
    mma_pb<D, kFwdBK / 16>(acc, s, tV, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  const float sl0 = l0 == 0.f ? 1.f : l0, sl1 = l1 == 0.f ? 1.f : l1;
  store_rows<D>(o + base, acc, q0 + warp * 16, S, lane, sl0, sl1);
  if ((lane & 3) == 0) {
    float* lrow = lse + static_cast<size_t>(blockIdx.y) * S;
    if (ra < S) lrow[ra] = m0 + logf(sl0);
    if (rb < S) lrow[rb] = m1 + logf(sl1);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, launch 1: delta and dQ; grid (q-tiles, B*H).  K/V tiles
// double buffered.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int S, float scale,
                    int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = kDqBK / 8;
  constexpr int kTile = kDqBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kDqBQ * LD;
  bf16* sK = sDO + kDqBQ * LD;        // [2][kDqBK][LD]
  bf16* sV = sK + 2 * kTile;          // [2][kDqBK][LD]
  float* sDelta = reinterpret_cast<float*>(sV + 2 * kTile);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t srow = static_cast<size_t>(blockIdx.y) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;

  int n_tiles = (S + kDqBK - 1) / kDqBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kDqBQ - 1) / kDqBK + 1);
  load_tile_async<D, kDqBQ>(sQ, q + base, q0, S);
  load_tile_async<D, kDqBQ>(sDO, dout + base, q0, S);
  load_tile_async<D, kDqBK>(sK, k + base, 0, S);
  load_tile_async<D, kDqBK>(sV, v + base, 0, S);
  cp_async_commit();
  // delta = rowsum(do * o) in fp32: each warp its 16 rows, lanes over D
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const bf16* orow = o + base + static_cast<size_t>(row) * D;
      const bf16* drow = dout + base + static_cast<size_t>(row) * D;
      for (int c = lane; c < D; c += 32) acc += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      sDelta[r] = acc;
      if (row < S) delta[srow + row] = acc;
    }
  }
  const float lse0 = ra < S ? lse[srow + ra] : 0.f, lse1 = rb < S ? lse[srow + rb] : 0.f;
  uint32_t qf[D / 16][4], df[D / 16][4];
  float dl0 = 0.f, dl1 = 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kDqBK;
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile_async<D, kDqBK>(sK + nb * kTile, k + base, k0 + kDqBK, S);
      load_tile_async<D, kDqBK>(sV + nb * kTile, v + base, k0 + kDqBK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      load_a_frags<D>(qf, sQ + warp * 16 * LD, lane);
      load_a_frags<D>(df, sDO + warp * 16 * LD, lane);
      dl0 = sDelta[warp * 16 + (lane >> 2)];
      dl1 = sDelta[warp * 16 + (lane >> 2) + 8];
    }
    const bf16* tK = sK + (j & 1) * kTile;
    const bf16* tV = sV + (j & 1) * kTile;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_abt<D, NT>(s, qf, tK, lane);
    mma_abt<D, NT>(dp, df, tV, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + (lane & 3) * 2 + (e & 1);
        const int row = e < 2 ? ra : rb;
        const float p = visible(row, col, S, causal) ? expf(s[nt][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1)) * scale;   // ds
      }
    }
    mma_pb<D, kDqBK / 16>(acc, s, tK, lane);
    __syncthreads();
  }
  store_rows<D>(dq + base, acc, q0 + warp * 16, S, lane, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// bf16 backward, launch 2: dK and dV; grid (kv-tiles, B*H).  Warps own 16
// keys each; products are taken transposed (keys are the rows).  Q / dO
// tiles (with their lse and delta) double buffered.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
                     int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = kKvBQ / 8;
  constexpr int kTile = kKvBQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kKvBK * LD;
  bf16* sQ = sV + kKvBK * LD;         // [2][kKvBQ][LD]
  bf16* sDO = sQ + 2 * kTile;         // [2][kKvBQ][LD]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kTile);   // [2][kKvBQ]
  float* sDelta = sLse + 2 * kKvBQ;                          // [2][kKvBQ]
  const int k0 = blockIdx.x * kKvBK;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t srow = static_cast<size_t>(blockIdx.y) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ka = k0 + warp * 16 + (lane >> 2), kb = ka + 8;

  const int n_q = (S + kKvBQ - 1) / kKvBQ;
  const int first = causal ? k0 / kKvBQ : 0;
  auto stage_rows = [&](int t, int buf) {
    const int q0 = t * kKvBQ;
    load_tile_async<D, kKvBQ>(sQ + buf * kTile, q + base, q0, S);
    load_tile_async<D, kKvBQ>(sDO + buf * kTile, dout + base, q0, S);
    for (int r = threadIdx.x; r < kKvBQ; r += kThreads) {
      const bool in = q0 + r < S;
      sLse[buf * kKvBQ + r] = in ? lse[srow + q0 + r] : 0.f;
      sDelta[buf * kKvBQ + r] = in ? delta[srow + q0 + r] : 0.f;
    }
  };
  load_tile_async<D, kKvBK>(sK, k + base, k0, S);
  load_tile_async<D, kKvBK>(sV, v + base, k0, S);
  if (first < n_q) stage_rows(first, 0);
  cp_async_commit();

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    dkacc[nt][0] = dkacc[nt][1] = dkacc[nt][2] = dkacc[nt][3] = 0.f;
    dvacc[nt][0] = dvacc[nt][1] = dvacc[nt][2] = dvacc[nt][3] = 0.f;
  }
  for (int t = first; t < n_q; ++t) {
    const int q0 = t * kKvBQ;
    const int buf = (t - first) & 1;
    if (t + 1 < n_q) stage_rows(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tQ = sQ + buf * kTile;
    const bf16* tDO = sDO + buf * kTile;
    const float* tLse = sLse + buf * kKvBQ;
    const float* tDelta = sDelta + buf * kKvBQ;
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
    {
      uint32_t kf[D / 16][4];
      load_a_frags<D>(kf, sK + warp * 16 * LD, lane);
      mma_abt<D, NT>(st, kf, tQ, lane);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        const int key = e < 2 ? ka : kb;
        st[nt][e] = visible(q0 + c, key, S, causal) ? expf(st[nt][e] * scale - tLse[c]) : 0.f;
      }
    }
    mma_pb<D, kKvBQ / 16>(dvacc, st, tDO, lane);   // dv += p^T do
    {
      uint32_t vf[D / 16][4];
      load_a_frags<D>(vf, sV + warp * 16 * LD, lane);
      mma_abt<D, NT>(dpt, vf, tDO, lane);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        st[nt][e] = st[nt][e] * (dpt[nt][e] - tDelta[c]) * scale;   // ds^T
      }
    }
    mma_pb<D, kKvBQ / 16>(dkacc, st, tQ, lane);    // dk += ds^T q
    __syncthreads();
  }
  store_rows<D>(dk + base, dkacc, k0 + warp * 16, S, lane, 1.f, 1.f);
  store_rows<D>(dv + base, dvacc, k0 + warp * 16, S, lane, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// fp32 scalar path: one warp per row, lane c owns head dims c, c + 32, ...
// ---------------------------------------------------------------------------
constexpr int kRowsPerBlock = 8;   // warps per block

template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= S) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  float qr[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = q[base + static_cast<size_t>(row) * D + lane + 32 * e];
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int kend = causal ? row + 1 : S;
  for (int key = 0; key < kend; ++key) {
    const float* kr = k + base + static_cast<size_t>(key) * D;
    const float* vr = v + base + static_cast<size_t>(key) * D;
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dot += qr[e] * kr[lane + 32 * e];
    const float s = warp_sum(dot) * scale;
    const float mn = fmaxf(m, s);
    const float p = expf(s - mn), alpha = expf(m - mn);
    l = alpha * l + p;
    m = mn;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = acc[e] * alpha + p * vr[lane + 32 * e];
  }
  const float sl = l == 0.f ? 1.f : l;
#pragma unroll
  for (int e = 0; e < E; ++e) o[base + static_cast<size_t>(row) * D + lane + 32 * e] = acc[e] / sl;
  if (lane == 0) lse[static_cast<size_t>(blockIdx.y) * S + row] = m + logf(sl);
}

template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int S,
                        float scale, int causal) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= S) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t off = base + static_cast<size_t>(row) * D;
  float qr[E], dr[E], acc[E], dsum = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = q[off + lane + 32 * e];
    dr[e] = dout[off + lane + 32 * e];
    dsum += dr[e] * o[off + lane + 32 * e];
    acc[e] = 0.f;
  }
  const float dl = warp_sum(dsum);
  const size_t srow = static_cast<size_t>(blockIdx.y) * S + row;
  if (lane == 0) delta[srow] = dl;
  const float lr = lse[srow];
  const int kend = causal ? row + 1 : S;
  for (int key = 0; key < kend; ++key) {
    const float* kr = k + base + static_cast<size_t>(key) * D;
    const float* vr = v + base + static_cast<size_t>(key) * D;
    float dot = 0.f, dpp = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dot += qr[e] * kr[lane + 32 * e];
      dpp += dr[e] * vr[lane + 32 * e];
    }
    const float p = expf(warp_sum(dot) * scale - lr);
    const float ds = p * (warp_sum(dpp) - dl) * scale;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += ds * kr[lane + 32 * e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dq[off + lane + 32 * e] = acc[e];
}

template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, float scale,
                         int causal) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const int key = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (key >= S) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t off = base + static_cast<size_t>(key) * D;
  const float* lrow = lse + static_cast<size_t>(blockIdx.y) * S;
  const float* drow = delta + static_cast<size_t>(blockIdx.y) * S;
  float kr[E], vr[E], dka[E], dva[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kr[e] = k[off + lane + 32 * e];
    vr[e] = v[off + lane + 32 * e];
    dka[e] = dva[e] = 0.f;
  }
  for (int row = causal ? key : 0; row < S; ++row) {
    const float* qr = q + base + static_cast<size_t>(row) * D;
    const float* dr = dout + base + static_cast<size_t>(row) * D;
    float dot = 0.f, dpp = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dot += kr[e] * qr[lane + 32 * e];
      dpp += vr[e] * dr[lane + 32 * e];
    }
    const float p = expf(warp_sum(dot) * scale - lrow[row]);
    const float ds = p * (warp_sum(dpp) - drow[row]) * scale;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dva[e] += p * dr[lane + 32 * e];
      dka[e] += ds * qr[lane + 32 * e];
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dk[off + lane + 32 * e] = dka[e];
    dv[off + lane + 32 * e] = dva[e];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <int D> constexpr int fwd_smem() { return (kFwdBQ + 4 * kFwdBK) * (D + 8) * 2; }
template <int D> constexpr int dq_smem() { return (2 * kDqBQ + 4 * kDqBK) * (D + 8) * 2 + kDqBQ * 4; }
template <int D> constexpr int dkv_smem() {
  return (2 * kKvBK + 4 * kKvBQ) * (D + 8) * 2 + 4 * kKvBQ * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                       int S, float scale, int causal, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    cudaError_t e = allow_smem(flash_fwd_kernel<D>, fwd_smem<D>());
    if (e != cudaSuccess) return e;
    const dim3 grid((S + kFwdBQ - 1) / kFwdBQ, BH);
    flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, S, scale, causal);
  } else {
    const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, BH);
    flash_fwd_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, S, scale, causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int BH, int S, float scale, int causal, int dtype,
                       cudaStream_t st) {
  if (dtype == 1) {
    cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
    if (e != cudaSuccess) return e;
    e = allow_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>());
    if (e != cudaSuccess) return e;
    const dim3 gq((S + kDqBQ - 1) / kDqBQ, BH);
    flash_bwd_dq_kernel<D><<<gq, kThreads, dq_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
        static_cast<bf16*>(dq), S, scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const dim3 gk((S + kKvBK - 1) / kKvBK, BH);
    flash_bwd_dkv_kernel<D><<<gk, kThreads, dkv_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, scale, causal);
  } else {
    const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, BH);
    flash_bwd_dq_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), S, scale,
        causal);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_dkv_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), S, scale, causal);
  }
  return cudaGetLastError();
}

bool bad_args(int BH, int S, int D, int dtype) {
  return BH <= 0 || BH > 65535 || S <= 0 || (D != 32 && D != 64 && D != 128) ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// q, k, v, o: [BH, S, D] contiguous, one dtype (0 = float32, 1 = bfloat16);
// lse: [BH, S] float32; D in {32, 64, 128}.  Returns the cudaError_t (0 = ok).
int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
                 int D, float scale, int causal, int dtype, void* stream) {
  if (bad_args(BH, S, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32: return static_cast<int>(launch_fwd<32>(q, k, v, o, l, BH, S, scale, causal, dtype, st));
    case 64: return static_cast<int>(launch_fwd<64>(q, k, v, o, l, BH, S, scale, causal, dtype, st));
    default: return static_cast<int>(launch_fwd<128>(q, k, v, o, l, BH, S, scale, causal, dtype, st));
  }
}

// The backward's two launches: delta [BH, S] (float32, written) and dq, then
// dk and dv.  Shapes and dtypes as ds_flash_fwd; do is the output gradient.
int ds_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int S,
                 int D, float scale, int causal, int dtype, void* stream) {
  if (bad_args(BH, S, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 32:
      return static_cast<int>(
          launch_bwd<32>(q, k, v, o, dout, l, dl, dq, dk, dv, BH, S, scale, causal, dtype, st));
    case 64:
      return static_cast<int>(
          launch_bwd<64>(q, k, v, o, dout, l, dl, dq, dk, dv, BH, S, scale, causal, dtype, st));
    default:
      return static_cast<int>(
          launch_bwd<128>(q, k, v, o, dout, l, dl, dq, dk, dv, BH, S, scale, causal, dtype, st));
  }
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
