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
// get no gradient. One thread per event loops over the bands. It is a pure
// gather with no atomics, so it equals its plain version bit for bit. What
// bounds it: the write of g_w (E * 4 * n_bands bytes) and the read of the
// bins; the reads of g (250 KiB to a few MiB) are served by the L2.
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

__global__ void histogram_bwd_kernel(const int* __restrict__ bins,
                                     const float* __restrict__ g,
                                     long long n_events, int n_bins,
                                     int n_bands, float* __restrict__ g_w) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_events) return;
  const int b = bins[e];
  const bool in_range = b >= 0 && b < n_bins;
  const float* src = g + (long long)(in_range ? b : 0) * n_bands;
  float* dst = g_w + e * n_bands;
  for (int k = 0; k < n_bands; ++k) dst[k] = in_range ? src[k] : 0.0f;
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
  const int threads = 256;
  const long long blocks = (n_events + threads - 1) / threads;
  histogram_bwd_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(bins, g, n_events, n_bins,
                                                 n_bands, g_w);
  return (int)cudaGetLastError();
}

extern "C" const char* ar2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
