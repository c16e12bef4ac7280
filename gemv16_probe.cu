// Probe kernels for gemv16_probe.py: the weight stream of the tensor-core
// GEMV core alone, under several tile widths, rings and grids, and a plain
// vectorised read of the same bytes as a yardstick.  Built with the package's
// csrc/decode.cu included (its core, grid and TMA maps), into a library of
// its own; the package never loads it.
//
//   nvcc <the package's flags> -I. -o libgemv16_probe.so gemv16_probe.cu

#include "deepspeed_tpu_torch/csrc/decode.cu"

namespace {

// The stream of g16_body with the products taken out: the same grid
// (g16_grid over C's resident blocks), the same TMA boxes into the same
// ring of mbarrier stages, each stage waited for, one word of it read a
// thread; no activations, no products, no merge.
template <class C>
__global__ void __launch_bounds__(kGThreads, C::kBps)
    g16_stream_kernel(const __grid_constant__ G16Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t full_bar[C::kStages];
  unsigned char* smem = smem_raw + ((kGAlign - smem_u32(smem_raw) % kGAlign) % kGAlign);
  if (threadIdx.x == 0) {
    for (int q = 0; q < C::kStages; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full_bar + q))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t fb = smem_u32(full_bar), ring = smem_u32(smem);
  const G16Grid& gr = a.g;
  int lo, hi;
  g16_range(gr, blockIdx.x, lo, hi);
  auto next = [&](int u, int& n0, int& k0) {
    const int tile = u / gr.k16, base = tile * gr.k16;
    n0 = tile * C::kTN;
    k0 = (u - base) * 16;
    return min(min(hi, base + gr.k16), u + C::kSteps);
  };
  int pw = lo;
  auto issue = [&](int slot) {
    if (pw < hi) {
      int n0, k0;
      const int e = next(pw, n0, k0);
      g16_load_w<C, true>(ring + slot * C::kStageBytes, a, n0, k0, fb + slot * 8);
      pw = e;
    }
  };
  for (int p = 0; p < C::kStages - 1; ++p) issue(p);
  uint32_t sum = 0;
  int cu = lo;
  for (int i = 0; cu < hi; ++i) {
    mbar_wait(fb + (i % C::kStages) * 8, (i / C::kStages) & 1);
    __syncthreads();
    issue((i + C::kStages - 1) % C::kStages);
    sum += *reinterpret_cast<const uint32_t*>(smem + (i % C::kStages) * C::kStageBytes +
                                              (threadIdx.x * 4) % C::kWBytes);
    int n0, k0;
    cu = next(cu, n0, k0);
  }
  if (sum == 0x9e3779b9u) a.part[threadIdx.x] = 1.f;   // keeps the reads
}

// A plain read: 16 bytes a thread, four in flight, the grid striding.
__global__ void __launch_bounds__(256) read_kernel(const uint4* __restrict__ w, long long n,
                                                   float* sink) {
  const long long stride = static_cast<long long>(gridDim.x) * 256;
  uint32_t sum = 0;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = i + u * stride < n ? __ldcs(w + i + u * stride) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u) sum += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  if (sum == 0x9e3779b9u) sink[threadIdx.x] = 1.f;
}

// The stream configurations: weights a stage, 128-byte boxes a weight,
// rows a stage, stages, blocks an SM.
using S0 = G16Cfg<uint16_t, 1, 1, 128, 3, 3>;   // norm_qkv's
using S1 = G16Cfg<uint16_t, 1, 1, 128, 6, 1>;   // proj_norm's
using S2 = G16Cfg<uint16_t, 1, 1, 128, 4, 2>;
using S3 = G16Cfg<uint16_t, 1, 1, 64, 6, 3>;    // 8 KB stages
using S4 = G16Cfg<uint16_t, 1, 2, 64, 3, 3>;    // 256 bytes a row, 16 KB stages
using S5 = G16Cfg<uint16_t, 1, 2, 64, 5, 2>;
using S6 = G16Cfg<uint16_t, 1, 4, 32, 3, 3>;    // 512 bytes a row, 16 KB stages
using S7 = G16Cfg<uint16_t, 1, 4, 64, 5, 1>;    // 512 bytes a row, 32 KB stages
using S8 = G16Cfg<uint16_t, 2, 1, 64, 3, 3>;    // up and gate a stage: the act launch's
using S9 = G16Cfg<uint16_t, 2, 1, 96, 3, 2>;
using S10 = G16Cfg<uint16_t, 2, 2, 32, 3, 3>;

const char* const kNames[] = {
    "64 cols x 128 rows, 3 stages, 3 blocks an SM (norm_qkv's)",
    "64 cols x 128 rows, 6 stages, 1 block an SM (proj_norm's)",
    "64 cols x 128 rows, 4 stages, 2 blocks an SM",
    "64 cols x 64 rows, 6 stages, 3 blocks an SM",
    "2 boxes: 128 cols x 64 rows, 3 stages, 3 blocks an SM",
    "2 boxes: 128 cols x 64 rows, 5 stages, 2 blocks an SM",
    "4 boxes: 256 cols x 32 rows, 3 stages, 3 blocks an SM",
    "4 boxes: 256 cols x 64 rows, 5 stages, 1 block an SM",
    "2 weights: 64 cols x 64 rows, 3 stages, 3 blocks an SM",
    "2 weights: 64 cols x 96 rows, 3 stages, 2 blocks an SM",
    "2 weights, 2 boxes: 128 cols x 32 rows, 3 stages, 3 blocks an SM"};
constexpr int kConfigs = sizeof(kNames) / sizeof(kNames[0]);

template <class C>
int run_stream(const void* w0, const void* w1, int K, int N, int promo, void* sink, int dev,
               cudaStream_t s) {
  G16Args a{};
  a.g = g16_grid_of<C>(K, N, dev);
  a.K = K;
  a.N = N;
  a.part = static_cast<float*>(sink);
  cudaError_t e = g16_wmap(&a.wmap[0], w0, K, N, kTypeBf16, C::kTK, promo);
  if (e == cudaSuccess && C::kNM == 2) e = g16_wmap(&a.wmap[1], w1, K, N, kTypeBf16, C::kTK, promo);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(g16_launch(g16_stream_kernel<C>, C::kSmem, a, dev, s, kLaunchPlain));
}

}  // namespace

extern "C" {

int probe_configs() { return kConfigs; }
const char* probe_config_name(int cfg) { return cfg >= 0 && cfg < kConfigs ? kNames[cfg] : ""; }
int probe_config_weights(int cfg) { return cfg >= 8 ? 2 : 1; }

// Stream the bf16 weight w0 [K, N] (and w1 of the same shape, for the
// configurations of two weights a stage) through configuration `cfg` with
// the TMA's L2 promotion `promo` (128 or 256 bytes); `sink` 1 KB of fp32.
int probe_stream(int cfg, const void* w0, const void* w1, int K, int N, int promo, void* sink,
                 void* stream, int device) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return run_stream<S0>(w0, w1, K, N, promo, sink, device, s);
    case 1: return run_stream<S1>(w0, w1, K, N, promo, sink, device, s);
    case 2: return run_stream<S2>(w0, w1, K, N, promo, sink, device, s);
    case 3: return run_stream<S3>(w0, w1, K, N, promo, sink, device, s);
    case 4: return run_stream<S4>(w0, w1, K, N, promo, sink, device, s);
    case 5: return run_stream<S5>(w0, w1, K, N, promo, sink, device, s);
    case 6: return run_stream<S6>(w0, w1, K, N, promo, sink, device, s);
    case 7: return run_stream<S7>(w0, w1, K, N, promo, sink, device, s);
    case 8: return run_stream<S8>(w0, w1, K, N, promo, sink, device, s);
    case 9: return run_stream<S9>(w0, w1, K, N, promo, sink, device, s);
    case 10: return run_stream<S10>(w0, w1, K, N, promo, sink, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Read `bytes` (a multiple of 16, 16-byte aligned) at w with `blocks`
// blocks of 256 threads.
int probe_read(const void* w, long long bytes, void* sink, int blocks, void* stream) {
  read_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(w), bytes / 16, static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
