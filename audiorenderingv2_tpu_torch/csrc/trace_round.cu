// K1: advance every ray by up to `budget` bounces over the triangle rows.
//
// Replaces the rows branch of the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2
// (launched by trace_round_v2; `n_blocks > 0`, with tri16 and the shared
// receiver/bounce tail). Same physics, same state columns, same results:
// per bounce, the nearest Moller-Trumbore hit over the triangle rows (ties
// to the lowest index), then the tail of trace_common.cuh.
//
// Design. The TPU kernel advances 128-ray tiles in lockstep. Here one
// thread owns one ray and loops over its own bounces, leaving as soon as the
// ray is done. The state stays in the port's [ncols, N] column layout, so
// neighbouring threads read neighbouring addresses, and lives in registers
// for the whole round. What bounds it on Hopper is FP32 throughput in the
// intersection loop (about 40 operations per ray and triangle; the state is
// read and written once per round), and divergence: a warp runs as long as
// its longest ray, which the alive-first partition between rounds
// (ops/raytrace_cuda.py) limits. Triangle rows are staged through shared
// memory in chunks of kChunk rows (48 KiB), so any triangle count works;
// a scene that fits one chunk is loaded once per block and each thread then
// runs free of barriers. A larger scene runs block-synchronously: all
// threads of a block step through the chunks of every bounce together.
//
// Poses (K1-pose: the same TPU kernel launched with `tiles_per_pose`,
// raytrace_pallas_v2.py:887-904, where tile i reads scalar row
// i // tiles_per_pose). `scal` is [P, 16] and the state is pose-major: rays
// [p * rays_per_pose, (p + 1) * rays_per_pose) belong to pose p.
// rays_per_pose is a multiple of the block size whenever P > 1, so a block
// never spans two poses and takes its scalar row from its first ray. One
// pose with rays_per_pose = n is the single-pose launch, unchanged.

#include "trace_common.cuh"

namespace {

using namespace ar2;

constexpr int kChunk = 512;  // triangle rows per shared-memory chunk

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_round_kernel(float* __restrict__ st, long long n,
                   const float* __restrict__ tris, int n_tris,
                   const float* __restrict__ scal, long long rays_per_pose,
                   int n_bands, int budget, int max_bounces) {
  extern __shared__ float s_rows[];
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool have_ray = ray < n;
  const bool one_chunk = n_tris <= kChunk;
  if (one_chunk) {
    load_rows(s_rows, tris, n_tris * kNR);
    __syncthreads();
  }
  const long long pose = ((long long)blockIdx.x * blockDim.x) / rays_per_pose;
  const Scalars sc(scal + pose * kNScal);
  const float fmax_b = (float)max_bounces;
  Ray<LB> r;
  r.load(st, n, ray, have_ray, n_bands);

  for (int i = 0; i < budget; ++i) {
    const bool running = have_ray && r.done == 0.f;
    if (one_chunk) {
      if (!running) break;
    } else if (!__syncthreads_or(running)) {
      break;
    }
    const bool can_cont = r.can_continue(sc, n_bands, fmax_b);
    const bool alive = running && can_cont;
    float best_t = CUDART_INF_F;
    int best_i = -1;
    for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
      const int rows = min(kChunk, n_tris - c0);
      if (!one_chunk) {
        __syncthreads();
        load_rows(s_rows, tris + (long long)c0 * kNR, rows * kNR);
        __syncthreads();
      }
      if (alive) r.intersect(s_rows, rows, c0, best_t, best_i);
    }
    r.finish_bounce(running, can_cont, best_t, best_i, tris, sc, n_bands);
  }
  if (have_ray) r.store(st, n, ray, n_bands);
}

template <int LB>
int launch(float* state, long long n, int ncols, const float* tris,
           int n_tris, const float* scal, long long rays_per_pose,
           int n_bands, int budget, int max_bounces, cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const size_t smem =
      sizeof(float) * kNR * (size_t)(n_tris < kChunk ? n_tris : kChunk);
  trace_round_kernel<LB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      state, n, tris, n_tris, scal, rays_per_pose, n_bands, budget,
      max_bounces);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ar2_trace_round(float* state, long long n, int ncols,
                               const float* tris, int n_tris,
                               const float* scal, int n_poses,
                               long long rays_per_pose, int n_bands,
                               int layout_bands, int budget, int max_bounces,
                               void* stream) {
  if (n <= 0 || n_tris < 0 || n_bands < 1 || budget < 1 || n_poses < 1 ||
      rays_per_pose * n_poses != n ||
      (n_poses > 1 && rays_per_pose % kThreads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout_bands) {
    case 1:
      return launch<1>(state, n, ncols, tris, n_tris, scal, rays_per_pose,
                       n_bands, budget, max_bounces, s);
    case 4:
      return launch<4>(state, n, ncols, tris, n_tris, scal, rays_per_pose,
                       n_bands, budget, max_bounces, s);
    case 8:
      return launch<8>(state, n, ncols, tris, n_tris, scal, rays_per_pose,
                       n_bands, budget, max_bounces, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
