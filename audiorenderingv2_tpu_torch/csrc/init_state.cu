// K4: the initial ray state with directions generated in the kernel.
//
// Replaces the TPU kernel audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:
// _init_state_kernel_v2 (launched by init_state_tiles, :279). Per ray it
// draws two uniforms, maps them to a uniform direction on the sphere with
// the mapping of core/sampling.py (theta = 2 pi u1, cos_phi = 2 u2 - 1,
// u = (bits >> 8) / 2^24) and writes every column of the state: P = the
// emitter, V = the direction, EN per band = e0 for a real ray and 0 for
// padding, DONE = 1 for padding, RAYID = the ray's global index,
// RECVD = -1, every other column 0. The emitter, e0 and the seed come from
// the scalar row (the seed in slot 14, below 2^23, so exact in f32), as on
// the TPU. No [N, 3] direction array exists at any point.
//
// The TPU draws from its hardware generator, seeded per tile; that stream
// exists on no other device. Here the bits are Philox4x32-10 (Salmon et
// al., "Parallel random numbers: as easy as 1, 2, 3", SC'11), written out
// below: counter = (ray index low word, high word, 0, 0), key = (seed, 0),
// words 0 and 1 of the output. A ray's direction is a function of (seed,
// global ray index) alone, so it does not depend on the launch geometry,
// and the plain PyTorch version (ops/raytrace_cuda.py:
// init_state_native_plain) reproduces the words exactly.
//
// Design. One thread per ray; each of the ncols column writes is coalesced
// across the warp. What bounds it on Hopper is the one write of ncols x
// n_pad x 4 bytes (64 MB at 1M rays and one band); the ~150 integer and
// floating operations per ray are far under that, and the kernel runs at
// 1.15x that bound (0.0220-0.0223 ms device time at 1,000,064 rays and one
// band on an H100; benchmarks/torch_trace_ab.py, `init` phase). Wider
// stores did not pay there: 4 consecutive rays a thread with one 16-byte
// store a column took 0.0246-0.0249 ms, 2 rays with 8-byte stores
// 0.0241-0.0243, 4 rays on a grid capped at 2 or 32 blocks an SM or not
// at all 0.0234-0.0247, and a block's [ncols, 512 rays] tile written
// from shared memory by bulk copies (cp.async.bulk) 0.0252.
// sincosf gives the direction's sine and cosine from one range reduction;
// they are the only steps that are not exactly rounded.

#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using namespace ar2;

constexpr int S_SEED = 14;  // scalar slot that carries the seed
constexpr unsigned kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Words 0 and 1 of Philox4x32-10 for counter (c0, c1, 0, 0), key (k0, 0).
__device__ __forceinline__ void philox4x32_10(unsigned c0, unsigned c1,
                                              unsigned k0, unsigned& out0,
                                              unsigned& out1) {
  unsigned c2 = 0u, c3 = 0u, k1 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const unsigned hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  out0 = c0;
  out1 = c1;
}

template <int LB>
__global__ void __launch_bounds__(kThreads)
init_state_kernel(float* __restrict__ st, long long n_pad, long long n_real,
                  const float* __restrict__ scal, int n_bands) {
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_pad) return;
  const unsigned seed = (unsigned)(int)scal[S_SEED];
  unsigned b0, b1;
  philox4x32_10((unsigned)(ray & 0xFFFFFFFFll), (unsigned)(ray >> 32), seed,
                b0, b1);
  const float unit = 1.0f / 16777216.0f;  // 2^-24
  const float u1 = (float)(b0 >> 8) * unit;
  const float u2 = (float)(b1 >> 8) * unit;
  const float theta = 6.283185307179586f * u1;
  const float cos_phi = 2.0f * u2 - 1.0f;
  const float sin_phi = sqrtf(fmaxf(0.0f, 1.0f - cos_phi * cos_phi));
  float sin_t, cos_t;
  sincosf(theta, &sin_t, &cos_t);
  const bool real = ray < n_real;
  const float e0 = real ? scal[S_E0] : 0.0f;

  // Every column is written once; the indices below are compile-time
  // constants after unrolling, so `v` lives in registers.
  float v[state_ncols<LB>()];
#pragma unroll
  for (int k = 0; k < state_ncols<LB>(); ++k) v[k] = 0.0f;
  v[C_PX] = scal[S_EMX];
  v[C_PY] = scal[S_EMY];
  v[C_PZ] = scal[S_EMZ];
  v[C_VX] = sin_phi * cos_t;
  v[C_VY] = sin_phi * sin_t;
  v[C_VZ] = cos_phi;
  v[C_DONE] = real ? 0.0f : 1.0f;
  v[C_RAYID] = (float)ray;
  v[C_RECVD] = -1.0f;
#pragma unroll
  for (int b = 0; b < LB; ++b)
    if (b < n_bands) v[en_col<LB>(b)] = e0;
  float* c = st + ray;
#pragma unroll
  for (int k = 0; k < state_ncols<LB>(); ++k) c[k * n_pad] = v[k];
}

template <int LB>
int launch(float* state, long long n_pad, int ncols, long long n_real,
           const float* scal, int n_bands, cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pad + kThreads - 1) / kThreads;
  init_state_kernel<LB><<<(unsigned)blocks, kThreads, 0, stream>>>(
      state, n_pad, n_real, scal, n_bands);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ar2_init_state(float* state, long long n_pad, int ncols,
                              long long n_real, const float* scal,
                              int n_bands, int layout_bands, void* stream) {
  if (n_pad <= 0 || n_real < 0 || n_real > n_pad || n_bands < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout_bands) {
    case 1:
      return launch<1>(state, n_pad, ncols, n_real, scal, n_bands, s);
    case 4:
      return launch<4>(state, n_pad, ncols, n_real, scal, n_bands, s);
    case 8:
      return launch<8>(state, n_pad, ncols, n_real, scal, n_bands, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
