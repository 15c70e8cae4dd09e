// The band split's spectral step: a signal's rfft [F] times each band's
// gain, complex64 [B, F], with the gains computed here from their
// definition, one thread a bin.
//
// Replaces no pl.pallas_call. On the TPU the split is plain XLA
// (audiorenderingv2_tpu/ops/filterbank.py:split_bands, :52-59): rfft, the
// product with gains that numpy builds on the host (band_gains) and jit
// holds as a constant, irfft. The port rebuilt those gains in float64
// numpy at every call (7 crossovers x 120,001 bins for a 5 s signal at
// 48 kHz, tens of milliseconds of host time with the card waiting) and
// uploaded them from pageable memory. This file computes band_gains'
// arithmetic step for step, in float64:
//
//   f      = i * ((sr / 2) / (F - 1)), the last bin sr / 2 itself
//            (np.linspace(0, sr / 2, F); F = 1 gives f = 0)
//   lp[e]  = 0.5 * (1 + cos(pi * clip((f - lo) / max(hi - lo, 1e-9), 0, 1)))
//            with lo, hi = f0 -+ f0 * transition for crossover e at f0
//   g[0]   = lp[0], g[b] = lp[b] - lp[b - 1], g[B - 1] = 1 - lp[B - 2]
//
// each gain rounded once to float32 (band_gains' .astype(np.float32)),
// then the product as PyTorch's complex64 * float32 computes it: the gain
// promoted to (g, 0) and (re * g - im * 0, re * 0 + im * g), so the value
// and the sign of a zero are the broadcast product's. The library is built
// with -fmad=false, so nothing is contracted. Python's max keeps a NaN
// width and np.clip a NaN ramp; so do the comparisons here. The one place
// the two can part is the float64 cosine: the card's cos against the
// host's libm in the last float64 place, which moves a gain only where it
// meets a float32 rounding boundary.
//
// Design. What bounds it is its bytes: 8 read and 8 * B written a bin
// (8.64 MB at 120,001 bins and 8 bands, 2.6 us at 3.35 TB/s), against
// B - 1 float64 cosines a bin. A thread reads its bin once and writes
// every band's, each band's row coalesced across the warp. The edges
// travel by value in the launch's parameters (at most kMaxEdges), so
// nothing is uploaded and nothing waits on the stream; the wrapper
// allocates the output.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxEdges = 31;
constexpr int kThreads = 256;

struct Edges {
  double f0[kMaxEdges];
};

// One crossover's lowpass at frequency f (band_gains' lp[e]).
__device__ __forceinline__ double lowpass(double f, double f0,
                                          double transition) {
  const double width = f0 * transition;
  const double lo = f0 - width, hi = f0 + width;
  const double span = hi - lo;
  const double den = 1e-9 > span ? 1e-9 : span;  // Python's max(span, 1e-9)
  double ramp = (f - lo) / den;
  ramp = ramp < 0.0 ? 0.0 : (ramp > 1.0 ? 1.0 : ramp);  // np.clip
  return 0.5 * (1.0 + cos(CUDART_PI * ramp));
}

__global__ void __launch_bounds__(kThreads)
band_split_kernel(const float2* __restrict__ spec, long long n_freqs,
                  double nyquist, double step, Edges edges, int n_edges,
                  double transition, float2* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_freqs) return;
  const double f =
      (n_freqs > 1 && i == n_freqs - 1) ? nyquist : (double)i * step;
  const float2 s = spec[i];
  double below = 0.0;  // lp of the crossover under band b
  for (int b = 0; b <= n_edges; ++b) {
    const double lp = b < n_edges ? lowpass(f, edges.f0[b], transition) : 1.0;
    const double g = b == 0 ? lp : (b < n_edges ? lp - below : 1.0 - below);
    below = lp;
    const float gf = __double2float_rn(g);
    out[b * n_freqs + i] =
        make_float2(s.x * gf - s.y * 0.0f, s.x * 0.0f + s.y * gf);
  }
}

}  // namespace

extern "C" int ar2_band_split(const float* spec, long long n_freqs,
                              double sample_rate, const double* edges,
                              int n_edges, double transition, float* out,
                              void* stream) {
  const long long blocks = (n_freqs + kThreads - 1) / kThreads;
  if (n_freqs < 1 || blocks > 0x7fffffffLL || n_edges < 1
      || n_edges > kMaxEdges)
    return (int)cudaErrorInvalidValue;
  Edges e;
  for (int k = 0; k < n_edges; ++k) e.f0[k] = edges[k];
  // np.linspace's step: the span over F - 1, each rounded as float64.
  const double nyquist = sample_rate / 2.0;
  const double step = n_freqs > 1 ? nyquist / (double)(n_freqs - 1) : 0.0;
  band_split_kernel<<<(unsigned)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(spec), n_freqs, nyquist, step, e,
      n_edges, transition, reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}
