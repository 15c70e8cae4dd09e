// K3: sum event weights into IR bins (forward only).
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
// The wrapper (ops/histogram_cuda.py) zero-fills `out` and checks shapes,
// types and devices; nothing here allocates or synchronises.

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

extern "C" const char* ar2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
