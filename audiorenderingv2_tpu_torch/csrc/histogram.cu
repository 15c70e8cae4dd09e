// K3: sum event weights into IR bins, and K3-bwd, the gather that is its
// backward pass.
//
// Replaces the TPU kernel audiorenderingv2_tpu/ops/histogram_pallas.py
// (_hist_kernel, launched by _hist_pallas_raw), which scatters 128 events at
// a time through a one-hot matrix product into a histogram held in VMEM.
//
// Here one thread takes one event and atomically adds its weights into a
// [n_bins, n_bands] float32 accumulator in device memory. What bounds it on
// Hopper: the event read (E * (4 + 4 * n_bands) bytes) and the atomics, which
// the L2 resolves; the stereo 2 s IR at 16 kHz is 64,000 bins (250 KiB),
// larger than the 227 KiB of shared memory a block may have, so the
// accumulator is not privatised per block yet. Events that are out of range
// or carry zero weight return before any write: padding rays, escaped rays
// and rays that never reach the receiver all leave such slots, and sending
// them to one sentinel address (as the TPU kernel does) would serialise
// their atomics on it. f32 atomics add in a run-dependent order, so sums
// agree with a sequential sum to a few ulp, not bit for bit.
//
// K3-bwd replaces the backward of the TPU version's custom VJP
// (histogram_pallas.py:124-143, an index_select on a zero-padded gradient):
// g_w[e, b] = g[bins[e], b], and 0 where bins[e] is out of range; the bins
// get no gradient. It is a pure gather with no atomics, so it equals its
// plain version bit for bit. The bytes it must move are the bins and g_w
// (E * (4 + 4 * n_bands)); what bounds it at one band is the gather: a
// warp's 32 reads of g touch about 32 cache lines, which the L1 (a 256 KB
// g) or the L2 (the posed histogram's 2 MB) serves a line at a time. On an
// H100 a one-event-a-thread kernel took 0.0220 ms at 4M events from
// 64,000 bins, the same kernel reading g contiguously 0.0167, and one that
// only reads the bins or only writes g_w 0.0118
// (benchmarks/torch_trace_ab.py, `bwd` phase). So at one band, where at
// least half of g fits a block's shared memory (the soft stereo IR's 64,000
// bins), each SM's one block of 1024 threads first copies g's first
// kStaged values into shared memory and gathers those from there, the rest
// through the L1; its threads take 4 events at a time as one 16-byte load
// of bins and one 16-byte store, kItems at a time with all loads issued
// before the gathers. That took the 64,000-bin case to 0.0168 ms, and made
// the 512,000-bin case slower (0.0697 against 0.0561: 11% staged), which
// therefore keeps one event a thread. At 4 and 8 bands the write of g_w
// sets the pace: one event is its row of g as float4s (a 16-byte gather
// and store each), kItems events a thread (0.0391 ms against 0.0606 at 4
// bands). Bins, g or g_w not 16-byte aligned (a view such as bins[1:]) and
// other band counts take one event a thread with scalar loads and stores.
// A warp's lanes take consecutive items, so that every load and store
// instruction of a warp covers contiguous bytes. Bins are read with
// streaming loads and g_w written with streaming stores: each is touched
// once, and g should stay in the caches.
//
// The wrappers (ops/histogram_cuda.py) zero-fill `out`, allocate `g_w` and
// check shapes, types and devices; nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

__global__ void histogram_kernel(const int* __restrict__ bins,
                                 const float* __restrict__ weights,
                                 long long n_events, int n_bins, int n_bands,
                                 float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_events) return;
  const int b = bins[e];
  if (b < 0 || b >= n_bins) return;
  const float* w = weights + e * n_bands;
  float* dst = out + (long long)b * n_bands;
  for (int k = 0; k < n_bands; ++k) {
    const float wk = w[k];
    if (wk != 0.0f) atomicAdd(dst + k, wk);
  }
}

constexpr int kBwdThreads = 256;
constexpr int kItems = 4;           // items a thread takes at a time
constexpr int kStaged = 57344;      // values of g in shared memory: 224 KiB
constexpr int kStagedThreads = 1024;

__device__ __forceinline__ bool in_range(int b, int n_bins) {
  return b >= 0 && b < n_bins;
}

// One band, 16-byte aligned, g's first n_staged values (a multiple of 4) in
// shared memory; one block an SM.
__device__ __forceinline__ float staged_value(const float* s_g,
                                              const float* __restrict__ g,
                                              int b, int n_bins,
                                              int n_staged) {
  if (!in_range(b, n_bins)) return 0.0f;
  return b < n_staged ? s_g[b] : __ldg(g + b);
}

__global__ void __launch_bounds__(kStagedThreads)
histogram_bwd_staged_kernel(const int* __restrict__ bins,
                            const float* __restrict__ g, long long n_events,
                            int n_bins, int n_staged,
                            float* __restrict__ g_w) {
  extern __shared__ float4 s_g4[];
  const float* s_g = reinterpret_cast<const float*>(s_g4);
  for (int k = threadIdx.x; k < n_staged / 4; k += blockDim.x)
    s_g4[k] = __ldg(reinterpret_cast<const float4*>(g) + k);
  __syncthreads();
  const long long n_quads = n_events >> 2;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kStagedThreads + threadIdx.x) >> 5;
  const long long n_warps = (long long)gridDim.x * (kStagedThreads / 32);
  for (long long base = warp * 32 * kItems; base < n_quads;
       base += n_warps * 32 * kItems) {
    int4 b[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long q = base + j * 32 + lane;
      b[j] = q < n_quads ? __ldcs(reinterpret_cast<const int4*>(bins) + q)
                         : make_int4(-1, -1, -1, -1);
    }
    float4 v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      v[j] = make_float4(staged_value(s_g, g, b[j].x, n_bins, n_staged),
                         staged_value(s_g, g, b[j].y, n_bins, n_staged),
                         staged_value(s_g, g, b[j].z, n_bins, n_staged),
                         staged_value(s_g, g, b[j].w, n_bins, n_staged));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long q = base + j * 32 + lane;
      if (q < n_quads) __stcs(reinterpret_cast<float4*>(g_w) + q, v[j]);
    }
  }
  // The last n_events % 4 events, one a thread.
  const long long e =
      4 * n_quads + (long long)blockIdx.x * kStagedThreads + threadIdx.x;
  if (e < n_events)
    __stcs(g_w + e, staged_value(s_g, g, __ldcs(bins + e), n_bins, n_staged));
}

// One event an item. kF4 > 0: rows of kF4 float4s (4 or 8 bands, 16-byte
// aligned), kItems events a thread; else n_bands scalars, one event a
// thread.
template <int kF4>
__global__ void __launch_bounds__(kBwdThreads)
histogram_bwd_kernel(const int* __restrict__ bins,
                     const float* __restrict__ g, long long n_events,
                     int n_bins, int n_bands, float* __restrict__ g_w) {
  constexpr int kPer = kF4 > 0 ? kItems : 1;
  const int lane = threadIdx.x & 31;
  const long long base =
      (((long long)blockIdx.x * kBwdThreads + threadIdx.x) >> 5) * 32 * kPer;
  int b[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = base + j * 32 + lane;
    b[j] = e < n_events ? __ldcs(bins + e) : -1;
  }
  if constexpr (kF4 > 0) {
    float4 v[kPer][kF4];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int k = 0; k < kF4; ++k)
        v[j][k] = in_range(b[j], n_bins)
                      ? __ldg(reinterpret_cast<const float4*>(g) +
                              (long long)b[j] * kF4 + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long e = base + j * 32 + lane;
      if (e < n_events)
#pragma unroll
        for (int k = 0; k < kF4; ++k)
          __stcs(reinterpret_cast<float4*>(g_w) + e * kF4 + k, v[j][k]);
    }
  } else {
    const long long e = base + lane;
    if (e >= n_events) return;
    const bool in = in_range(b[0], n_bins);
    const float* src = g + (long long)(in ? b[0] : 0) * n_bands;
    for (int k = 0; k < n_bands; ++k)
      __stcs(g_w + e * n_bands + k, in ? __ldg(src + k) : 0.0f);
  }
}

template <int kF4>
void launch_bwd(const int* bins, const float* g, long long n_events,
                int n_bins, int n_bands, float* g_w, cudaStream_t stream) {
  const long long per_block = (long long)kBwdThreads * (kF4 > 0 ? kItems : 1);
  histogram_bwd_kernel<kF4><<<(unsigned)((n_events + per_block - 1) /
                                         per_block),
                              kBwdThreads, 0, stream>>>(bins, g, n_events,
                                                        n_bins, n_bands, g_w);
}

}  // namespace

extern "C" int ar2_histogram(const int* bins, const float* weights,
                             long long n_events, int n_bins, int n_bands,
                             float* out, void* stream) {
  if (n_events <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n_events + threads - 1) / threads;
  histogram_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      bins, weights, n_events, n_bins, n_bands, out);
  return (int)cudaGetLastError();
}

extern "C" int ar2_histogram_bwd(const int* bins, const float* g,
                                 long long n_events, int n_bins, int n_bands,
                                 float* g_w, void* stream) {
  if (n_events <= 0) return (int)cudaSuccess;
  const bool aligned = ((reinterpret_cast<size_t>(bins) |
                         reinterpret_cast<size_t>(g) |
                         reinterpret_cast<size_t>(g_w)) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned && n_bands == 1 && n_bins <= 2 * kStaged) {
    const int n_staged = (n_bins < kStaged ? n_bins : kStaged) & ~3;
    const int smem = n_staged * (int)sizeof(float);
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(histogram_bwd_staged_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return (int)err;
    histogram_bwd_staged_kernel<<<sms, kStagedThreads, smem, s>>>(
        bins, g, n_events, n_bins, n_staged, g_w);
  } else if (aligned && n_bands == 4) {
    launch_bwd<1>(bins, g, n_events, n_bins, n_bands, g_w, s);
  } else if (aligned && n_bands == 8) {
    launch_bwd<2>(bins, g, n_events, n_bins, n_bands, g_w, s);
  } else {
    launch_bwd<0>(bins, g, n_events, n_bins, n_bands, g_w, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ar2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
