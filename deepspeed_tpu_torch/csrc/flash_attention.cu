// Causal flash attention, forward and backward, for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py `_flash_fwd` (kernel
// `_fwd_kernel`) and `_flash_bwd` (delta outside the kernels, then the
// kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`).
//
//   forward:  o = softmax(q k^T * scale [+ bias], causal) v,
//             lse = m + log(l)   [B*H, S]
//   backward: delta = rowsum(do * o) (a pre-pass, read by both launches)
//             p = exp(s - lse); ds = p * (do v^T - delta) * scale
//             dq = ds k;  dk = ds^T q;  dv = p^T do
//
// ALiBi (the Pallas kernels' `alibi` branch, and BLOOM's positions): the
// bias slope_h * (col - row) is added to the scaled logits before the causal
// mask, causal or not, in all three kernels (s above is then the biased
// logit).  The slopes are an fp32 [H] table; grid row b * H + h reads slope
// h (JAX tiles them over B).  Each kernel takes it as a template flag, so
// the instances without it compile to the same code as before, and the
// 16-bit instances with it have names of their own (`*_alibi_kernel`) for
// the profiler.  The bias varies along a row, so the forward forms the biased
// logit in log2 units first, t = s scale log2(e) + slope log2(e) (col - row),
// and takes the running max over t; the backward forms s scale + slope
// (col - row) and recomputes p against the natural-log lse.  Either needs
// col - row on every tile, not only on the tiles that are masked.
//
// bf16 and fp16 (the Pallas kernels' float16 branch, which `fp16.enabled`
// training runs) share one design: every wgmma body is templated on its
// 16-bit element type, and only the products' type (`.bf16` or `.f16`), the
// packing of p, ds and the outputs (cvt.rn to the type: an fp32 value past
// fp16's range becomes inf, which the loss scaler must see, never the
// largest finite value) and the delta pre-pass's loads differ.  The fp16
// instances are separate `__global__` wrappers (`*_f16_kernel`,
// `*_f16_alibi_kernel`), so every profile tag names a real kernel.  In fp16
// p and ds below 2^-24 flush to zero, as the Pallas kernels' astype does.
//
// Numerics follow the Pallas kernels: scores in fp32 times `scale`, masked
// entries set to NEG_INF = -1e30 (not -inf), an online softmax with
// alpha = exp(m_prev - m_new), p rounded to the input dtype before the P.V
// product, `safe_l` (l == 0 -> 1) for empty rows, ds rounded to the input
// dtype before the dQ / dK products and p before dV.  KV tiles entirely
// above the diagonal are skipped.  No atomics anywhere: two calls give the
// same bits.
//
// What bounds it on the H100: tensor-core operations.  At the llama-1b4
// training shape (B 4, H 16, S 2048, Dh 128, bf16) the forward does
// 4 B H S^2 Dh / 2 = 68.7 GFLOP (0.069 ms at 989 TFLOP/s) on 67 MB of
// q, k, v and o; the backward's least work is five products (s, dp, dv, dk,
// dq: 0.174 ms), and the two-launch split executes seven (s and dp in both
// launches: 0.243 ms at the peak).
//
// The TPU kernel carries m, l and the accumulator in VMEM scratch across
// the sequential KV grid axis.  Here a block owns 128 rows of one b*h and
// loops over the tiles of the other side itself, with m, l and the
// accumulators in registers.  A block is two warpgroups (256 threads);
// each owns 64 of the block's 128 rows, which stay in shared memory for
// the block's life, and streams 64-row tiles of the other side through a
// ring.  Every product is wgmma.mma_async m64nNk16, B always a tile in
// shared memory, A in shared memory (the backward's s, dp, s^T and dp^T)
// or in registers as 16-bit fragments: the forward's q, and p or ds rounded
// where the reference rounds them (o += p v; dq, dk, dv).  Tiles are
// stored in the 128B swizzle (64B at D = 32) that wgmma reads, and one
// physical tile serves as a K-major operand (q k^T) and an MN-major one
// (p v, ds^T q) through its descriptor alone.
//
// Forward (bf16, fp16).  Q is loaded once and each warpgroup holds its 64
// rows in registers as A fragments (at n64 an SS product reads 4 KB of shared
// memory every 32 tensor-core clocks, the SM's whole 128 bytes a clock; in
// registers, q halves that); K and V stream.  In its turn a warpgroup
// issues s = q k^T of tile j, then o += p v of tile j - 1 (its accumulator
// rescaled first), and runs tile j's online softmax under that p v: the
// accumulator's own register layout, row max and sum across the four lanes
// that share a row, scores in log2 units (s scale log2(e) in one FMA
// before the MUFU ex2; lse written in natural log).  Backward (bf16,
// fp16).  Three launches: the delta pre-pass (the reference's own split,
// 16-byte loads), then dQ (Q and dO resident) and dK/dV (K and V resident)
// as the reference splits them, so no block sums into another's rows.
//
// The ring has four stages, fed by cp.async (zero fill past S) and
// tracked by mbarriers: full[s] completes when every thread's copies of
// the tile in stage s have landed (cp.async.mbarrier.arrive), empty[s]
// when both warpgroups have waited for their products on it.  The
// forward's p v and dQ's ds k product run under the next tile's products,
// so the stage refilled with tile j + 2 is tile j - 2's (dK/dV waits for
// its dv and dk products at the tile's end: carrying their fragments into
// the next tile takes all 255 registers at D = 128 and was slower).  There
// is no barrier across the block inside the loop: two named barriers make
// the warpgroups take turns to issue their products (s and p v; s and
// dp), so one warpgroup's exponentials run under the other's products (in
// lock step, with a __syncthreads a tile, the same products were slower).
// cp.async, not TMA: it needs no tensor maps or driver entry point, and
// the ragged edge and the 4-byte lse and delta rows go through the same
// copies.  The mask is evaluated only on tiles that hold an invisible pair
// (the diagonal and the ragged last tiles); tiles wholly above the
// diagonal are skipped (a warpgroup's one fully masked tile in a causal
// block is computed with p = 0, so that no wgmma sits on a divergent path)
// and the heavy blocks launch first.
//
// fp32 inputs take a scalar path (one warp per row, lanes over the head
// dim, one key at a time) with the same semantics; it serves the fp32
// reference runs, not the 16-bit training paths.
//
// Head dims 32, 64 and 128 (the presets' 32 of llama-tiny and mixtral-tiny,
// 64 of the GPT-2 family, 128 of the Llama family): 64-byte swizzled rows
// at D = 32 (m64n32 for the register-A products), 128-byte rows at 64, and
// two 64-wide atoms at 128; the fp32 path gives each lane D / 32 elements.
// Dynamic shared memory a block (with the 1 KB alignment pad): the forward
// 42,048 B at D = 32, 83,008 at 64, 164,928 at 128; the backward 50 KB to
// 195 KB (ds_flash_fwd_smem_bytes, ds_flash_bwd_smem_bytes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Round two floats to the 16-bit type T (nearest even, as astype: cvt.rn,
// so a value past fp16's range becomes inf, never the largest finite value)
// and pack them.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, f16>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Two packed 16-bit values of type T as floats.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (std::is_same_v<T, f16>)
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x, the MUFU instruction alone (results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// bf16 and fp16 on wgmma.  The forward (a block owns 128 query rows and streams
// 64-key tiles of K and V) and the backward's three launches: the delta
// pre-pass, dQ (as the forward, with dO) and dK/dV (a block owns 128 keys
// and streams 64-row tiles of Q, dO, lse and delta).  A block is two
// warpgroups (256 threads); each owns 64 of the block's rows and runs its
// products as wgmma.mma_async m64nNk16 (bf16 or fp16 in, fp32 out).
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kRows = 128;      // rows a block owns (64 a warpgroup)
constexpr int kTile = 64;       // rows of a streamed tile
constexpr int kStages = 4;      // depth of the streamed tiles' ring

// The swizzled tile layout that wgmma reads.  A tile of R rows x D 16-bit is
// D / AW column atoms of R rows x AW elements, kBytes = 2 AW bytes a row:
// 128 (AW 64) for D = 64 and 128, 64 (AW 32) for D = 32.  The 16-byte chunk
// c of row r lies at chunk c ^ ((r * kBytes >> 7) & (kBytes / 16 - 1)), the
// 128B (64B) swizzle, applied by the hardware to the address bits, so every
// tile starts on a 1024-byte boundary.  The same tile is a K-major operand
// (rows are M or N, the head dim is K: q k^T, do v^T) and an MN-major one
// (rows are K: p^T do, ds^T q, ds k); only the descriptor differs.
template <int D>
struct Sw {
  static constexpr int kBytes = D >= 64 ? 128 : 64;
  static constexpr int kAW = kBytes / 2;
  static constexpr int kAtoms = D / kAW;
  static constexpr int kChunks = kBytes / 16;
  static constexpr uint64_t kMode = kBytes == 128 ? 1 : 2;   // descriptor layout type
  // byte offset of 16-byte chunk `chunk` (0 .. D / 8) of row r in an R-row tile
  static __device__ __forceinline__ uint32_t offset(int R, int r, int chunk) {
    const int atom = chunk / kChunks, c = chunk % kChunks;
    return atom * R * kBytes + r * kBytes + ((c ^ ((r * kBytes >> 7) & (kChunks - 1))) << 4);
  }
};

// wgmma shared-memory descriptors (start address, leading and stride byte
// offsets in 16-byte units, layout type in bits 62-63).  K-major: the
// stride between 8-row groups is SBO; LBO is unused under a swizzle.
// MN-major: 8-row groups along K stride SBO and atoms along N stride LBO;
// each instruction here reads one atom along N (N = AW), so LBO is unused
// too, and both are set to the 8-row stride.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  constexpr uint64_t kSbo = (8 * Sw<D>::kBytes) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (kSbo << 32) |
         (Sw<D>::kMode << 62);
}

template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  constexpr uint64_t kSbo = (8 * Sw<D>::kBytes) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kSbo << 16) | (kSbo << 32) |
         (Sw<D>::kMode << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an in-flight wgmma writes: reads after a wait stay
// after it, writes before an issue stay before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int A, int N>
__device__ __forceinline__ void fence_regs(float (&r)[A][N]) {
#pragma unroll
  for (int a = 0; a < A; ++a) fence_regs(r[a]);
}
// The value of x, which the compiler may no longer assume it knows: keeps
// addresses derived from it (wgmma descriptors, global rows) from being
// hoisted out of a loop into registers that stay live across it.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ring's mbarriers: full[s] completes when every thread's copies of the
// tile in stage s have landed, empty[s] when both warpgroups are done with it.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive on `bar` once this thread's cp.async copies issued so far have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// Named barriers 1 and 2 order the two warpgroups' products: a warpgroup
// issues its s and dp products only after the other issued its own, so one
// warpgroup's exponentials run under the other's products.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// The products' asm, one statement for each input type TY ("bf16" or
// "f16"; Hopper runs both at the same dense tensor-core rate): m64n64k16
// with A and B in shared memory, m64n64k16 and m64n32k16 with A in registers.
#define DS_WGMMA_SS(TY)                                                                          \
  asm volatile(                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                         \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                 \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                                   \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])              \
      : "l"(da), "l"(db), "r"(accumulate))

#define DS_WGMMA_RS64(TY)                                                                        \
  asm volatile(                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                         \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                 \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                                   \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTransB))

#define DS_WGMMA_RS32(TY)                                                                        \
  asm volatile(                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                         \
      "%8, %9, %10, %11, %12, %13, %14, %15"                                                     \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
        "+f"(d[14]), "+f"(d[15])                                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTransB))

// d (+)= A . B, A and B in shared memory (K-major); accumulate = 0
// overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, f16>)
    DS_WGMMA_SS("f16");
  else
    DS_WGMMA_SS("bf16");
}

// d (+)= A . B with A in registers as one k16 fragment and B in shared
// memory, MN-major (kTransB = 1: p v, ds k, p^T do, ds^T q) or K-major
// (0: q k^T); accumulate = 0 overwrites d.
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same_v<T, f16>)
    DS_WGMMA_RS64("f16");
  else
    DS_WGMMA_RS64("bf16");
}

template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same_v<T, f16>)
    DS_WGMMA_RS32("f16");
  else
    DS_WGMMA_RS32("bf16");
}

#undef DS_WGMMA_SS
#undef DS_WGMMA_RS64
#undef DS_WGMMA_RS32

// Start copying rows [row0, row0 + R) of a [S, D] 16-bit matrix into a
// swizzled tile at shared address `dst` (16-byte cp.async, rows past S
// zero filled); every thread of the block takes part.
template <int D, int R, typename T>
__device__ __forceinline__ void load_tile_sw(uint32_t dst, const T* src, int row0, int S) {
  constexpr int kPerRow = D / 8;
  static_assert(R * kPerRow % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * kPerRow / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kPerRow, k = c % kPerRow;
    const bool in = row0 + r < S;
    const T* g = src + static_cast<size_t>(in ? row0 + r : 0) * D + k * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + Sw<D>::offset(R, r, k)),
                 "l"(g), "r"(in ? 16 : 0));
  }
}

// Start copying 64 floats of a [S] row (from row0; past S zero filled) into
// shared memory, 4 bytes a thread (rows of lse and delta need not be
// 16-byte aligned); threads [t0, t0 + 64) take part.
__device__ __forceinline__ void load_stats(uint32_t dst, const float* src, int row0, int S, int t0) {
  const int r = static_cast<int>(threadIdx.x) - t0;
  if (r < 0 || r >= kTile) return;
  const bool in = row0 + r < S;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + r * 4),
               "l"(src + (in ? row0 + r : 0)), "r"(in ? 4 : 0));
}

// acc[64 x 64] = A[64 x D] . B[64 x D]^T, both K-major in swizzled tiles:
// A the 64 rows at shared address a of an RA-row tile, B the 64 rows at b
// of an RB-row tile (q k^T, do v^T, k q^T, v do^T).
template <typename T, int D, int RA, int RB>
__device__ __forceinline__ void ss_product(float (&acc)[32], uint32_t a, uint32_t b) {
  using L = Sw<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t atom = kk * 16 / L::kAW, off = (kk * 16 % L::kAW) * 2;
    wgmma_ss<T>(acc, desc_k_major<D>(a + atom * RA * L::kBytes + off),
             desc_k_major<D>(b + atom * RB * L::kBytes + off), kk > 0);
  }
}

// The A fragments of a warpgroup's 64 rows (from row r0 of an R-row
// swizzled tile at shared address t) across the head dim: thread (warp w,
// lane l) takes rows 16 w + l / 4 and + 8, columns 16 kk + 2 (l % 4) and + 8.
template <int D>
__device__ __forceinline__ void load_frags_sw(uint32_t (&f)[D / 16][4], uint32_t t, int R, int r0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r = r0 + warp * 16 + (lane >> 2), b = (lane & 3) * 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=r"(f[kk][e])
                   : "r"(t + Sw<D>::offset(R, r + (e & 1) * 8, 2 * kk + (e >> 1)) + b));
}

// acc[64 x 64] = A[64 x D] . B[64 x D]^T: A in registers (load_frags_sw),
// B a 64-row swizzled tile at shared address b, K-major (q k^T).  Half the
// shared-memory reads of ss_product: at n64 an SS product reads A and B,
// 4 KB every 32 tensor-core clocks, the whole of the SM's 128 bytes a clock.
template <typename T, int D>
__device__ __forceinline__ void rs_product_k(float (&acc)[32], const uint32_t (&a)[D / 16][4], uint32_t b) {
  using L = Sw<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t atom = kk * 16 / L::kAW, off = (kk * 16 % L::kAW) * 2;
    wgmma_rs<T, 0>(acc, a[kk], desc_k_major<D>(b + atom * kTile * L::kBytes + off), kk > 0);
  }
}

// acc[64 x D] += A[64 x 64] . B[64 x D]: A in registers as four k16
// fragments, B a 64-row swizzled tile at shared address b read MN-major
// (p^T do, ds^T q, ds k); one instruction for each k16 step and atom.
template <typename T, int D>
__device__ __forceinline__ void rs_product(float (&acc)[Sw<D>::kAtoms][Sw<D>::kAW / 2],
                                           const uint32_t (&a)[4][4], uint32_t b) {
  using L = Sw<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int na = 0; na < L::kAtoms; ++na)
      wgmma_rs<T, 1>(acc[na], a[kk], desc_mn_major<D>(b + na * kTile * L::kBytes + kk * 16 * L::kBytes),
                  1);
  }
}

// A 64 x 64 fp32 accumulator, rounded to T, as the A fragments of a
// product over its 64 columns (the layouts agree: n8 blocks 2kk and 2kk + 1
// of the accumulator are k16 step kk of the operand).
template <typename T>
__device__ __forceinline__ void acc_to_frags(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack2<T>(x[8 * kk + 0], x[8 * kk + 1]);
    f[kk][1] = pack2<T>(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = pack2<T>(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = pack2<T>(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[Sw<D>::kAtoms][Sw<D>::kAW / 2]) {
#pragma unroll
  for (int na = 0; na < Sw<D>::kAtoms; ++na)
#pragma unroll
    for (int i = 0; i < Sw<D>::kAW / 2; ++i) acc[na][i] = 0.f;
}

// Store a warpgroup's [64 x D] fp32 accumulator as T rows row0 + ...;
// rows past S are dropped.  Thread (warp w, lane l) holds rows 16 w + l / 4
// and + 8, columns 8 j + 2 (l % 4) + {0, 1} of each n8 block j.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[Sw<D>::kAtoms][Sw<D>::kAW / 2],
                                          int row0, int S) {
  using L = Sw<D>;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ra = row0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int na = 0; na < L::kAtoms; ++na) {
#pragma unroll
    for (int j = 0; j < L::kAW / 8; ++j) {
      const int c = na * L::kAW + j * 8 + (lane & 3) * 2;
      if (ra < S)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(ra) * D + c) =
            pack2<T>(acc[na][4 * j], acc[na][4 * j + 1]);
      if (ra + 8 < S)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(ra + 8) * D + c) =
            pack2<T>(acc[na][4 * j + 2], acc[na][4 * j + 3]);
    }
  }
}

// delta = rowsum(do * o) in fp32, [BH * S] rows: D / 8 threads a row, one
// 16-byte load of each operand a thread, a shuffle sum across them.
template <int D, typename T>
__device__ __forceinline__ void flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                                                float* __restrict__ delta, int rows) {
  constexpr int kT = D / 8;
  const int row = blockIdx.x * (256 / kT) + threadIdx.x / kT;
  const int c = threadIdx.x % kT;
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + static_cast<size_t>(row) * D + c * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + static_cast<size_t>(row) * D + c * 8);
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = unpack2<T>(wa[i]), fb = unpack2<T>(wb[i]);
      acc += fa.x * fb.x + fa.y * fb.y;
    }
  }
#pragma unroll
  for (int off = kT / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  flash_bwd_delta<D>(o, dout, delta, rows);
}

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_f16_kernel(const f16* __restrict__ o, const f16* __restrict__ dout,
                           float* __restrict__ delta, int rows) {
  flash_bwd_delta<D>(o, dout, delta, rows);
}

// The block's shared memory, rounded up to a 1024-byte boundary (the
// swizzle's period) from the dynamic base.
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* raw) {
  const uint32_t base = smem_u32(raw);
  return (base + 1023u) & ~1023u;
}

// ---------------------------------------------------------------------------
// Forward: grid (q-blocks of 128 rows, B*H), heavy (late) blocks first.
// Q of the block is loaded once, each warpgroup's 64 rows into registers as
// A fragments; K and V stream through the ring.  In its turn a warpgroup
// issues s = q k^T of tile j (RS, k K-major) and then o += p v of tile
// j - 1 (RS, v read MN-major), so tile j's softmax runs under tile j - 1's
// p v and under the other warpgroup's products.  Scores are carried in
// log2 units (s scale log2(e), one FMA before exp2); lse is written in
// natural log.  Under ALiBi (kAlibi) the scores are biased and scaled
// before the max: t = s scale log2(e) + slope log2(e) (col - row).
// ---------------------------------------------------------------------------
template <int D, bool kAlibi, typename T>
__device__ __forceinline__ void flash_fwd_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, T* __restrict__ o,
                                                float* __restrict__ lse, int S, float scale, int causal,
                                                const float* __restrict__ slopes, int H) {
  using L = Sw<D>;
  constexpr uint32_t kRes = kRows * D * 2, kStr = kTile * D * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = aligned_smem(smem_raw), sK = sQ + kRes, sV = sK + kStages * kStr;
  const uint32_t full = sV + kStages * kStr, empty = full + kStages * 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, kThreads);
      mbar_init(empty + 8 * i, kThreads);
    }
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int qb = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int qw = qb + wg * 64;                    // this warpgroup's first row
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;

  int n_k = (S + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, (qb + kRows - 1) / kTile + 1);
  load_tile_sw<D, kRows>(sQ, q + base, qb, S);
  auto stage = [&](int j) {   // this thread's copies of tile j
    const uint32_t st = (j % kStages) * kStr;
    load_tile_sw<D, kTile>(sK + st, k + base, j * kTile, S);
    load_tile_sw<D, kTile>(sV + st, v + base, j * kTile, S);
    mbar_arrive_on_copies(full + 8 * (j % kStages));
  };
  stage(0);
  if (n_k > 1) stage(1);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();   // Q is in
  uint32_t qf[D / 16][4];
  load_frags_sw<D>(qf, sQ, kRows, wg * 64);

  const int ra = qw + warp * 16 + (lane >> 2), rb = ra + 8;
  const float sl2 = scale * kLog2e;
  // what the max and the exponent take s times: sl2 on raw scores, 1 on
  // ALiBi's t, which is scaled already
  const float mul = kAlibi ? 1.f : sl2;
  float al2 = 0.f;   // ALiBi's slope in log2 units
  if constexpr (kAlibi) al2 = slopes[blockIdx.y % H] * kLog2e;
  float acc[L::kAtoms][L::kAW / 2];
  zero_acc<D>(acc);
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // m in log2 units
  float al0 = 1.f, al1 = 1.f;   // what acc takes before the next p v product

  // refill the stage of tile j - 2 with tile j + 2 once both warpgroups are done with it
  auto refill = [&](int j) {
    if (j + 2 >= n_k) return;
    if (j >= 2) mbar_wait(empty + 8 * ((j + 2) % kStages), ((j - 2) / kStages) & 1);
    stage(j + 2);
  };
  // in this warpgroup's turn: s = q k^T of tile j
  auto issue_s = [&](float (&s)[32], int j) {
    mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
    fence_proxy_async();
    named_sync(1 + wg);
    wg_fence();
    rs_product_k<T, D>(s, qf, sK + (j % kStages) * kStr);
    wg_commit();
  };
  // the online softmax of tile j: s becomes p; m, l and alpha move
  auto softmax = [&](float (&s)[32], int j) {
    const int k0 = j * kTile;
    if constexpr (kAlibi) {   // t on every tile
      const float d0 = static_cast<float>(k0 + (lane & 3) * 2 - ra);
      const float d1 = static_cast<float>(k0 + (lane & 3) * 2 - rb);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = fmaf(s[i], sl2, al2 * ((i & 2 ? d1 : d0) + static_cast<float>((i >> 2) * 8 + (i & 1))));
    }
    // the mask only where a tile holds an invisible pair: the diagonal tile
    // and the ragged last tile (a warpgroup's one fully masked tile in a
    // causal block comes out as p = 0); rows past S are never stored, so
    // the key alone decides for them
    if ((causal && k0 + 63 > qw) || k0 + kTile > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = i & 2 ? rb : ra;
        const int col = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        if (col >= S || (causal && row < col)) s[i] = kNegInf;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * mul), mn1 = fmaxf(m1, quad_max(mx1) * mul);
    al0 = ex2(m0 - mn0);
    al1 = ex2(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(fmaf(s[i], mul, -(i & 2 ? mn1 : mn0)));   // p
      if (i & 2) sum1 += s[i];
      else sum0 += s[i];
    }
    l0 = al0 * l0 + quad_sum(sum0);
    l1 = al1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
  };
  // acc *= alpha, then o += p v of tile j (p as 16-bit fragments f)
  auto issue_pv = [&](const uint32_t (&f)[4][4], int j) {
#pragma unroll
    for (int na = 0; na < L::kAtoms; ++na)
#pragma unroll
      for (int i = 0; i < L::kAW / 2; ++i) acc[na][i] *= i & 2 ? al1 : al0;
    fence_regs(acc);
    wg_fence();
    rs_product<T, D>(acc, f, sV + (j % kStages) * kStr);
    wg_commit();
  };

  uint32_t f[4][4];   // p of the last tile, rounded to T as the reference
  float s[32];
  if (wg == 1) named_arrive(1);   // warpgroup 0 issues first
  issue_s(s, 0);
  named_arrive(2 - wg);
  wg_wait<0>();
  fence_regs(s);
  softmax(s, 0);
  acc_to_frags<T>(f, s);
  refill(0);
  for (int j = 1; j < n_k; ++j) {
    issue_s(s, j);
    issue_pv(f, j - 1);
    named_arrive(2 - wg);
    wg_wait<1>();   // s is done; tile j - 1's p v runs under the softmax
    fence_regs(s);
    softmax(s, j);
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * ((j - 1) % kStages));
    acc_to_frags<T>(f, s);
    refill(j);
  }
  issue_pv(f, n_k - 1);
  if (wg == 0) named_sync(1);   // the other warpgroup's last arrive
  wg_wait<0>();
  fence_regs(acc);
  const float sl0 = l0 == 0.f ? 1.f : l0, sl1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int na = 0; na < L::kAtoms; ++na)
#pragma unroll
    for (int i = 0; i < L::kAW / 2; ++i) acc[na][i] /= i & 2 ? sl1 : sl0;
  store_acc<T, D>(o + base, acc, qw, S);
  if ((lane & 3) == 0) {
    float* lrow = lse + static_cast<size_t>(blockIdx.y) * S;
    if (ra < S) lrow[ra] = m0 * kLn2 + logf(sl0);
    if (rb < S) lrow[rb] = m1 * kLn2 + logf(sl1);
  }
}



// The forward's __global__ instances: bf16 and fp16, each with and without
// ALiBi, each a name of its own for the profiler.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int S, float scale, int causal,
                       const float* __restrict__ slopes, int H) {
  flash_fwd_wgmma<D, false, bf16>(q, k, v, o, lse, S, scale, causal, slopes, H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_alibi_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int S, float scale, int causal,
                             const float* __restrict__ slopes, int H) {
  flash_fwd_wgmma<D, true, bf16>(q, k, v, o, lse, S, scale, causal, slopes, H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_f16_kernel(const f16* __restrict__ q, const f16* __restrict__ k,
                           const f16* __restrict__ v, f16* __restrict__ o,
                           float* __restrict__ lse, int S, float scale, int causal,
                           const float* __restrict__ slopes, int H) {
  flash_fwd_wgmma<D, false, f16>(q, k, v, o, lse, S, scale, causal, slopes, H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_f16_alibi_kernel(const f16* __restrict__ q, const f16* __restrict__ k,
                                 const f16* __restrict__ v, f16* __restrict__ o,
                                 float* __restrict__ lse, int S, float scale, int causal,
                                 const float* __restrict__ slopes, int H) {
  flash_fwd_wgmma<D, true, f16>(q, k, v, o, lse, S, scale, causal, slopes, H);
}

// ---------------------------------------------------------------------------
// dQ: grid (q-blocks of 128 rows, B*H), heavy (late) blocks first.  Q and
// dO of the block stay resident; K and V stream through the ring.  Per
// 64-key tile, each warpgroup: s = q k^T and dp = do v^T (SS), p and ds in
// registers, dq += ds k (RS, k read MN-major).
// ---------------------------------------------------------------------------
template <int D, bool kAlibi, typename T>
__device__ __forceinline__ void flash_bwd_dq_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                                                   const T* __restrict__ v, const T* __restrict__ dout,
                                                   const float* __restrict__ lse,
                                                   const float* __restrict__ delta, T* __restrict__ dq,
                                                   int S, float scale, int causal,
                                                   const float* __restrict__ slopes, int H) {
  using L = Sw<D>;
  constexpr uint32_t kRes = kRows * D * 2, kStr = kTile * D * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = aligned_smem(smem_raw), sDO = sQ + kRes;
  const uint32_t sK = sDO + kRes, sV = sK + kStages * kStr;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int qb = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int qw = qb + wg * 64;                    // this warpgroup's first row
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t srow = static_cast<size_t>(blockIdx.y) * S;

  const uint32_t full = sV + kStages * kStr, empty = full + kStages * 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, kThreads);
      mbar_init(empty + 8 * i, kThreads);
    }
  }
  __syncthreads();

  int n_k = (S + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, (qb + kRows - 1) / kTile + 1);
  load_tile_sw<D, kRows>(sQ, q + base, qb, S);
  load_tile_sw<D, kRows>(sDO, dout + base, qb, S);
  auto stage = [&](int j) {   // this thread's copies of tile j
    const uint32_t st = (j % kStages) * kStr;
    load_tile_sw<D, kTile>(sK + st, k + base, j * kTile, S);
    load_tile_sw<D, kTile>(sV + st, v + base, j * kTile, S);
    mbar_arrive_on_copies(full + 8 * (j % kStages));
  };
  stage(0);
  if (n_k > 1) stage(1);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();   // Q and dO are in

  const int ra = qw + warp * 16 + (lane >> 2), rb = ra + 8;
  const float lse0 = ra < S ? lse[srow + ra] : 0.f, lse1 = rb < S ? lse[srow + rb] : 0.f;
  const float dl0 = ra < S ? delta[srow + ra] : 0.f, dl1 = rb < S ? delta[srow + rb] : 0.f;
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[blockIdx.y % H];
  float acc[L::kAtoms][L::kAW / 2];
  zero_acc<D>(acc);

  // refill the stage of tile j - 2 with tile j + 2 once both warpgroups are done with it
  auto refill = [&](int j) {
    if (j + 2 >= n_k) return;
    if (j >= 2) mbar_wait(empty + 8 * ((j + 2) % kStages), ((j - 2) / kStages) & 1);
    stage(j + 2);
  };
  if (wg == 1) named_arrive(1);   // warpgroup 0 issues first
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kTile;
    mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
    fence_proxy_async();
    const uint32_t tK = sK + (j % kStages) * kStr, tV = sV + (j % kStages) * kStr;
    float s[32], dp[32];
    named_sync(1 + wg);
    wg_fence();
    ss_product<T, D, kRows, kTile>(s, opaque(sQ + wg * 64 * L::kBytes), tK);
    wg_commit();
    ss_product<T, D, kRows, kTile>(dp, opaque(sDO + wg * 64 * L::kBytes), tV);
    wg_commit();
    named_arrive(2 - wg);
    wg_wait<1>();    // s, and tile j - 1's dq product, are done
    if (j >= 1) mbar_arrive(empty + 8 * ((j - 1) % kStages));
    fence_regs(s);
    // element i's logit: s scale, plus slope (col - row) under ALiBi
    const float d0 = static_cast<float>(k0 + (lane & 3) * 2 - ra);
    const float d1 = static_cast<float>(k0 + (lane & 3) * 2 - rb);
    auto logit = [&](int i) {
      if constexpr (kAlibi)
        return fmaf(s[i], scale, slope * ((i & 2 ? d1 : d0) + static_cast<float>((i >> 2) * 8 + (i & 1))));
      else
        return s[i] * scale;
    };
    // the mask only where a tile holds an invisible pair: the diagonal tile
    // and the ragged last tiles
    if ((causal && k0 + 63 > qw) || k0 + kTile > S || qw + 64 > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = i & 2 ? rb : ra;
        const int col = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const bool ok = row < S && col < S && (!causal || row >= col);
        s[i] = ok ? expf(logit(i) - (i & 2 ? lse1 : lse0)) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = expf(logit(i) - (i & 2 ? lse1 : lse0));
    }
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - (i & 2 ? dl1 : dl0)) * scale;   // ds
    uint32_t f[4][4];
    acc_to_frags<T>(f, s);
    fence_regs(acc);
    wg_fence();
    rs_product<T, D>(acc, f, tK);   // dq += ds k, waited for under the next tile's s
    wg_commit();
    refill(j);
  }
  if (wg == 0) named_sync(1);   // the other warpgroup's last arrive
  wg_wait<0>();
  fence_regs(acc);
  store_acc<T, D>(dq + base, acc, qw, S);
}



// dQ's __global__ instances, named as the forward's.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int S, float scale, int causal,
                          const float* __restrict__ slopes, int H) {
  flash_bwd_dq_wgmma<D, false, bf16>(q, k, v, dout, lse, delta, dq, S, scale, causal, slopes, H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_alibi_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dq, int S, float scale, int causal,
                                const float* __restrict__ slopes, int H) {
  flash_bwd_dq_wgmma<D, true, bf16>(q, k, v, dout, lse, delta, dq, S, scale, causal, slopes, H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_f16_kernel(const f16* __restrict__ q, const f16* __restrict__ k,
                              const f16* __restrict__ v, const f16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              f16* __restrict__ dq, int S, float scale, int causal,
                              const float* __restrict__ slopes, int H) {
  flash_bwd_dq_wgmma<D, false, f16>(q, k, v, dout, lse, delta, dq, S, scale, causal, slopes, H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_f16_alibi_kernel(const f16* __restrict__ q, const f16* __restrict__ k,
                                    const f16* __restrict__ v, const f16* __restrict__ dout,
                                    const float* __restrict__ lse, const float* __restrict__ delta,
                                    f16* __restrict__ dq, int S, float scale, int causal,
                                    const float* __restrict__ slopes, int H) {
  flash_bwd_dq_wgmma<D, true, f16>(q, k, v, dout, lse, delta, dq, S, scale, causal, slopes, H);
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key blocks of 128, B*H), heavy (early) blocks first.  K and
// V of the block stay resident; Q, dO, lse and delta stream through the
// ring.  Per 64-row query tile, each warpgroup (64 keys): s^T = k q^T and
// dp^T = v do^T (SS), p^T and ds^T in registers, dv += p^T do and
// dk += ds^T q (RS, q and do read MN-major).
// ---------------------------------------------------------------------------
template <int D, bool kAlibi, typename T>
__device__ __forceinline__ void flash_bwd_dkv_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                                                    const T* __restrict__ v, const T* __restrict__ dout,
                                                    const float* __restrict__ lse,
                                                    const float* __restrict__ delta, T* __restrict__ dk,
                                                    T* __restrict__ dv, int S, float scale, int causal,
                                                    const float* __restrict__ slopes, int H) {
  using L = Sw<D>;
  constexpr uint32_t kRes = kRows * D * 2, kStr = kTile * D * 2;
  constexpr uint32_t kStats = kTile * 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sK = aligned_smem(smem_raw), sV = sK + kRes;
  const uint32_t sQ = sV + kRes, sDO = sQ + kStages * kStr;
  const uint32_t sLse = sDO + kStages * kStr, sDelta = sLse + kStages * kStats;
  const uint32_t full = sDelta + kStages * kStats, empty = full + kStages * 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, kThreads);
      mbar_init(empty + 8 * i, kThreads);
    }
  }
  __syncthreads();
  const float* lse_tiles = reinterpret_cast<const float*>(
      smem_raw + (sLse - smem_u32(smem_raw)));
  const float* delta_tiles = reinterpret_cast<const float*>(
      smem_raw + (sDelta - smem_u32(smem_raw)));
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int kb = blockIdx.x * kRows;
  const int kw = kb + wg * 64;                    // this warpgroup's first key
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;

  const int n_q = (S + kTile - 1) / kTile;
  const int first = causal ? kb / kTile : 0;
  const int n_t = n_q - first;
  load_tile_sw<D, kRows>(sK, k + base, kb, S);
  load_tile_sw<D, kRows>(sV, v + base, kb, S);
  auto stage = [&](int i) {   // this thread's copies of tile i
    const int st = i % kStages, q0 = (first + i) * kTile;
    const size_t bs = static_cast<size_t>(opaque(blockIdx.y)) * S;
    load_tile_sw<D, kTile>(sQ + st * kStr, q + bs * D, q0, S);
    load_tile_sw<D, kTile>(sDO + st * kStr, dout + bs * D, q0, S);
    load_stats(sLse + st * kStats, lse + bs, q0, S, 0);
    load_stats(sDelta + st * kStats, delta + bs, q0, S, kTile);
    mbar_arrive_on_copies(full + 8 * st);
  };
  stage(0);
  if (n_t > 1) stage(1);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();   // K and V are in

  const int ka = kw + warp * 16 + (lane >> 2), kc = ka + 8;   // this thread's keys
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[blockIdx.y % H];
  float dkacc[L::kAtoms][L::kAW / 2], dvacc[L::kAtoms][L::kAW / 2];
  zero_acc<D>(dkacc);
  zero_acc<D>(dvacc);

  // refill the stage of tile i - 2 with tile i + 2 once both warpgroups are done with it
  auto refill = [&](int i) {
    if (i + 2 >= n_t) return;
    if (i >= 2) mbar_wait(empty + 8 * ((i + 2) % kStages), ((i - 2) / kStages) & 1);
    stage(i + 2);
  };
  if (wg == 1) named_arrive(1);   // warpgroup 0 issues first
  for (int i = 0; i < n_t; ++i) {
    const int q0 = (first + i) * kTile;
    const int st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    fence_proxy_async();
    const uint32_t tQ = sQ + st * kStr, tDO = sDO + st * kStr;
    const float* tl = lse_tiles + st * kTile;
    const float* td = delta_tiles + st * kTile;
    float s[32], dp[32];
    named_sync(1 + wg);
    wg_fence();
    ss_product<T, D, kRows, kTile>(s, opaque(sK + wg * 64 * L::kBytes), tQ);    // s^T = k q^T
    wg_commit();
    ss_product<T, D, kRows, kTile>(dp, opaque(sV + wg * 64 * L::kBytes), tDO);  // dp^T = v do^T
    wg_commit();
    named_arrive(2 - wg);
    wg_wait<1>();    // s^T is done
    if (i >= 1) mbar_arrive(empty + 8 * ((i - 1) % kStages));
    fence_regs(s);
    // element x's logit: s^T scale, plus slope (key - row) under ALiBi
    const float e0 = static_cast<float>(ka - q0 - (lane & 3) * 2);
    const float e1 = static_cast<float>(kc - q0 - (lane & 3) * 2);
    auto logit = [&](int x) {
      if constexpr (kAlibi)
        return fmaf(s[x], scale, slope * ((x & 2 ? e1 : e0) - static_cast<float>((x >> 2) * 8 + (x & 1))));
      else
        return s[x] * scale;
    };
    // p^T = exp(logit - lse[col]); the mask only on the diagonal tile and
    // the ragged last tiles
    if ((causal && q0 < kw + 63) || q0 + kTile > S || kw + 64 > S) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = (x >> 2) * 8 + (lane & 3) * 2 + (x & 1);
        const int row = q0 + c, key = x & 2 ? kc : ka;
        const bool ok = row < S && key < S && (!causal || row >= key);
        s[x] = ok ? expf(logit(x) - tl[c]) : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(tl + j * 8 + (lane & 3) * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * j + e] = expf(logit(4 * j + e) - (e & 1 ? l.y : l.x));
      }
    }
    uint32_t f[4][4];
    acc_to_frags<T>(f, s);
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(td + j * 8 + (lane & 3) * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? d.y : d.x)) * scale;   // ds^T
    }
    uint32_t g[4][4];
    acc_to_frags<T>(g, s);
    fence_regs(dvacc);
    fence_regs(dkacc);
    wg_fence();
    rs_product<T, D>(dvacc, f, tDO);   // dv += p^T do
    rs_product<T, D>(dkacc, g, tQ);    // dk += ds^T q
    wg_commit();
    wg_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    refill(i);
  }
  if (wg == 0) named_sync(1);   // the other warpgroup's last arrive
  store_acc<T, D>(dk + base, dkacc, kw, S);
  store_acc<T, D>(dv + base, dvacc, kw, S);
}



// dK/dV's __global__ instances, named as the forward's.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
                           int causal, const float* __restrict__ slopes, int H) {
  flash_bwd_dkv_wgmma<D, false, bf16>(q, k, v, dout, lse, delta, dk, dv, S, scale, causal, slopes,
                                   H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_alibi_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
                                 int causal, const float* __restrict__ slopes, int H) {
  flash_bwd_dkv_wgmma<D, true, bf16>(q, k, v, dout, lse, delta, dk, dv, S, scale, causal, slopes,
                                   H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_f16_kernel(const f16* __restrict__ q, const f16* __restrict__ k,
                               const f16* __restrict__ v, const f16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               f16* __restrict__ dk, f16* __restrict__ dv, int S, float scale,
                               int causal, const float* __restrict__ slopes, int H) {
  flash_bwd_dkv_wgmma<D, false, f16>(q, k, v, dout, lse, delta, dk, dv, S, scale, causal, slopes,
                                   H);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_f16_alibi_kernel(const f16* __restrict__ q, const f16* __restrict__ k,
                                     const f16* __restrict__ v, const f16* __restrict__ dout,
                                     const float* __restrict__ lse, const float* __restrict__ delta,
                                     f16* __restrict__ dk, f16* __restrict__ dv, int S, float scale,
                                     int causal, const float* __restrict__ slopes, int H) {
  flash_bwd_dkv_wgmma<D, true, f16>(q, k, v, dout, lse, delta, dk, dv, S, scale, causal, slopes,
                                   H);
}

// ---------------------------------------------------------------------------
// fp32 scalar path: one warp per row, lane c owns head dims c, c + 32, ...
// ---------------------------------------------------------------------------
constexpr int kRowsPerBlock = 8;   // warps per block

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, float scale, int causal,
                     const float* __restrict__ slopes, int H) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= S) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[blockIdx.y % H];
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
    float s = warp_sum(dot) * scale;
    if constexpr (kAlibi) s += slope * static_cast<float>(key - row);
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

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int S,
                        float scale, int causal, const float* __restrict__ slopes, int H) {
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
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[blockIdx.y % H];
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
    float logit = warp_sum(dot) * scale;
    if constexpr (kAlibi) logit += slope * static_cast<float>(key - row);
    const float p = expf(logit - lr);
    const float ds = p * (warp_sum(dpp) - dl) * scale;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += ds * kr[lane + 32 * e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dq[off + lane + 32 * e] = acc[e];
}

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, float scale,
                         int causal, const float* __restrict__ slopes, int H) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const int key = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (key >= S) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t off = base + static_cast<size_t>(key) * D;
  const float* lrow = lse + static_cast<size_t>(blockIdx.y) * S;
  const float* drow = delta + static_cast<size_t>(blockIdx.y) * S;
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[blockIdx.y % H];
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
    float logit = warp_sum(dot) * scale;
    if constexpr (kAlibi) logit += slope * static_cast<float>(key - row);
    const float p = expf(logit - lrow[row]);
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
// the wgmma kernels: the resident 128-row tiles (Q for the forward, Q and dO
// or K and V for the backward), four stages of the streamed 64-row pair
// (and, for dK/dV, of 64 lse and delta values), the ring's eight
// mbarriers, and 1 KB to align the base to the swizzle's period
template <int D> constexpr int fwd_smem() {
  return 1024 + kRows * D * 2 + 2 * kStages * kTile * D * 2 + 2 * kStages * 8;
}
template <int D> constexpr int dq_smem() { return fwd_smem<D>() + kRows * D * 2; }
template <int D> constexpr int dkv_smem() { return dq_smem<D>() + 2 * kStages * kTile * 4; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The wgmma kernels of one 16-bit element type T and ALiBi flag.
template <int D, bool kAlibi, typename T>
struct Wgmma;

template <int D, bool kAlibi>
struct Wgmma<D, kAlibi, bf16> {
  static auto fwd() { return kAlibi ? flash_fwd_wgmma_alibi_kernel<D> : flash_fwd_wgmma_kernel<D>; }
  static auto delta() { return flash_bwd_delta_kernel<D>; }
  static auto dq() { return kAlibi ? flash_bwd_dq_wgmma_alibi_kernel<D> : flash_bwd_dq_wgmma_kernel<D>; }
  static auto dkv() {
    return kAlibi ? flash_bwd_dkv_wgmma_alibi_kernel<D> : flash_bwd_dkv_wgmma_kernel<D>;
  }
};

template <int D, bool kAlibi>
struct Wgmma<D, kAlibi, f16> {
  static auto fwd() {
    return kAlibi ? flash_fwd_wgmma_f16_alibi_kernel<D> : flash_fwd_wgmma_f16_kernel<D>;
  }
  static auto delta() { return flash_bwd_delta_f16_kernel<D>; }
  static auto dq() {
    return kAlibi ? flash_bwd_dq_wgmma_f16_alibi_kernel<D> : flash_bwd_dq_wgmma_f16_kernel<D>;
  }
  static auto dkv() {
    return kAlibi ? flash_bwd_dkv_wgmma_f16_alibi_kernel<D> : flash_bwd_dkv_wgmma_f16_kernel<D>;
  }
};

template <int D, bool kAlibi, typename T>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                             int BH, int S, float scale, int causal, const float* slopes, int H,
                             cudaStream_t st) {
  const auto kernel = Wgmma<D, kAlibi, T>::fwd();
  cudaError_t e = allow_smem(kernel, fwd_smem<D>());
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, BH);
  kernel<<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, scale, causal, slopes, H);
  return cudaGetLastError();
}

template <int D, bool kAlibi>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                       int S, float scale, int causal, const float* slopes, int H, int dtype,
                       cudaStream_t st) {
  if (dtype == 1)
    return launch_fwd_wgmma<D, kAlibi, bf16>(q, k, v, o, lse, BH, S, scale, causal, slopes, H, st);
  if (dtype == 2)
    return launch_fwd_wgmma<D, kAlibi, f16>(q, k, v, o, lse, BH, S, scale, causal, slopes, H, st);
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, BH);
  flash_fwd_f32_kernel<D, kAlibi><<<grid, kRowsPerBlock * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, scale, causal, slopes, H);
  return cudaGetLastError();
}

template <int D, bool kAlibi, typename T>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, void* dk,
                             void* dv, int BH, int S, float scale, int causal,
                             const float* slopes, int H, cudaStream_t st) {
  using K = Wgmma<D, kAlibi, T>;
  const auto dq_kernel = K::dq();
  const auto dkv_kernel = K::dkv();
  cudaError_t e = allow_smem(dq_kernel, dq_smem<D>());
  if (e != cudaSuccess) return e;
  e = allow_smem(dkv_kernel, dkv_smem<D>());
  if (e != cudaSuccess) return e;
  const int rows = BH * S, per_block = 256 / (D / 8);
  K::delta()<<<(rows + per_block - 1) / per_block, 256, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, BH);
  dq_kernel<<<grid, kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, scale, causal, slopes, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<<<grid, kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S,
      scale, causal, slopes, H);
  return cudaGetLastError();
}

template <int D, bool kAlibi>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int BH, int S, float scale, int causal, const float* slopes,
                       int H, int dtype, cudaStream_t st) {
  if (dtype == 1)
    return launch_bwd_wgmma<D, kAlibi, bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, S,
                                             scale, causal, slopes, H, st);
  if (dtype == 2)
    return launch_bwd_wgmma<D, kAlibi, f16>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, S,
                                            scale, causal, slopes, H, st);
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, BH);
  flash_bwd_dq_f32_kernel<D, kAlibi><<<grid, kRowsPerBlock * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), S, scale,
      causal, slopes, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_f32_kernel<D, kAlibi><<<grid, kRowsPerBlock * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), S, scale, causal, slopes, H);
  return cudaGetLastError();
}

// the head dim as a template argument
template <bool kAlibi>
cudaError_t fwd_for(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                    int BH, int S, float scale, int causal, const float* slopes, int H, int dtype,
                    cudaStream_t st) {
  switch (D) {
    case 32: return launch_fwd<32, kAlibi>(q, k, v, o, lse, BH, S, scale, causal, slopes, H, dtype, st);
    case 64: return launch_fwd<64, kAlibi>(q, k, v, o, lse, BH, S, scale, causal, slopes, H, dtype, st);
    default: return launch_fwd<128, kAlibi>(q, k, v, o, lse, BH, S, scale, causal, slopes, H, dtype, st);
  }
}

template <bool kAlibi>
cudaError_t bwd_for(int D, const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                    int BH, int S, float scale, int causal, const float* slopes, int H, int dtype,
                    cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_bwd<32, kAlibi>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, S, scale, causal,
                                    slopes, H, dtype, st);
    case 64:
      return launch_bwd<64, kAlibi>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, S, scale, causal,
                                    slopes, H, dtype, st);
    default:
      return launch_bwd<128, kAlibi>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, S, scale, causal,
                                     slopes, H, dtype, st);
  }
}

// slopes (ALiBi's [H] table) may be null; given, H must divide BH
bool bad_args(int BH, int S, int D, int dtype, const void* slopes, int H) {
  return BH <= 0 || BH > 65535 || S <= 0 || (D != 32 && D != 64 && D != 128) ||
         dtype < 0 || dtype > 2 || (slopes && (H <= 0 || BH % H != 0));
}

}  // namespace

extern "C" {

// q, k, v, o: [BH, S, D] contiguous, one dtype (0 = float32, 1 = bfloat16,
// 2 = float16);
// lse: [BH, S] float32; D in {32, 64, 128}; slopes: ALiBi's float32 [H]
// (null: no bias).  Returns the cudaError_t (0 = ok).
int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
                 int D, float scale, int causal, const void* slopes, int H, int dtype,
                 void* stream) {
  if (bad_args(BH, S, D, dtype, slopes, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float* sl = static_cast<const float*>(slopes);
  return static_cast<int>(sl ? fwd_for<true>(D, q, k, v, o, l, BH, S, scale, causal, sl, H, dtype, st)
                             : fwd_for<false>(D, q, k, v, o, l, BH, S, scale, causal, sl, H, dtype, st));
}

// The backward's launches: delta [BH, S] (float32, written) and dq, then
// dk and dv.  Shapes, dtypes and slopes as ds_flash_fwd; do is the output
// gradient.
int ds_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int S,
                 int D, float scale, int causal, const void* slopes, int H, int dtype,
                 void* stream) {
  if (bad_args(BH, S, D, dtype, slopes, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float* sl = static_cast<const float*>(slopes);
  return static_cast<int>(
      sl ? bwd_for<true>(D, q, k, v, o, dout, l, dl, dq, dk, dv, BH, S, scale, causal, sl, H, dtype, st)
         : bwd_for<false>(D, q, k, v, o, dout, l, dl, dq, dk, dv, BH, S, scale, causal, sl, H, dtype,
                          st));
}

// Dynamic shared memory a block of the wgmma forward takes at head dim D,
// the bf16 and the fp16 instances alike (0 for a head dim without a
// kernel).
int ds_flash_fwd_smem_bytes(int D) {
  switch (D) {
    case 32: return fwd_smem<32>();
    case 64: return fwd_smem<64>();
    case 128: return fwd_smem<128>();
    default: return 0;
  }
}

// Dynamic shared memory a block of the wgmma backward takes at head dim D,
// the bf16 and the fp16 instances alike: kernel 0 = dQ, 1 = dK/dV (0 for a
// head dim without a kernel).
int ds_flash_bwd_smem_bytes(int D, int kernel) {
  switch (D) {
    case 32: return kernel ? dkv_smem<32>() : dq_smem<32>();
    case 64: return kernel ? dkv_smem<64>() : dq_smem<64>();
    case 128: return kernel ? dkv_smem<128>() : dq_smem<128>();
    default: return 0;
  }
}

const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
