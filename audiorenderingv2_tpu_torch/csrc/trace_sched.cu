// K2: one bounce of every ray over its tile's candidate clusters.
//
// Replaces the schedule branch of the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2
// (`use_cull and use_sched`, :501-546, launched by trace_round_v2 with
// `sched`). A tile is 128 consecutive rays; its row of the schedule
// (csrc/tile_schedule.cu) holds the count, then the ids of the clusters
// some ray of the tile can reach, ascending. Per ray: the nearest
// Moller-Trumbore hit over those clusters' rows, visited in list order with
// a strict running minimum (ties to the lowest row, as on the TPU), then
// K1's receiver test and bounce tail (trace_common.cuh). The round is one
// bounce: the schedule is computed from the positions before it.
//
// Design. One block of 128 threads is one tile, one thread one ray. For
// each candidate, block-synchronously, the cluster's cs rows (3 KiB at
// cs = 32) are staged into shared memory and every ray that is still alive
// tests them. What bounds it on Hopper: the reads of the candidate
// clusters' rows, which the L2 serves (the office scene's 19,872 rows are
// 1.9 MB), and FP32 intersection math; the coherent sort between rounds
// keeps a tile's rays close in position and direction, so its list stays
// short. Done rays reach every barrier: there is no early return before
// the loop, and a tile with count 0 still runs the receiver test.
//
// Poses (the TPU kernel with `tiles_per_pose`, raytrace_pallas_v2.py:
// 887-904): `scal` is [P, 16], the state pose-major, and tile i reads scalar
// row i // tiles_per_pose. The schedule is per tile and reads positions
// only, so it is the same for any P. One pose is the single-pose launch.

#include "trace_common.cuh"

namespace {

using namespace ar2;

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_sched_kernel(float* __restrict__ st, long long n,
                   const float* __restrict__ rows, int cs,
                   const int* __restrict__ sched, int width,
                   const float* __restrict__ scal, int tiles_per_pose,
                   int n_bands, int max_bounces) {
  extern __shared__ float s_rows[];
  const long long ray = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool have_ray = ray < n;
  const Scalars sc(scal + (long long)(blockIdx.x / tiles_per_pose) * kNScal);
  Ray<LB> r;
  r.load(st, n, ray, have_ray, n_bands);
  const bool running = have_ray && r.done == 0.f;
  const bool can_cont = r.can_continue(sc, n_bands, (float)max_bounces);
  const bool alive = running && can_cont;

  const int* list = sched + (long long)blockIdx.x * width;
  const int count = list[0];
  float best_t = CUDART_INF_F;
  int best_i = -1;
  for (int k = 0; k < count; ++k) {
    const int c = list[1 + k];
    __syncthreads();  // every thread is done with the previous cluster
    load_rows(s_rows, rows + (long long)c * cs * kNR, cs * kNR);
    __syncthreads();
    if (alive) r.intersect(s_rows, cs, c * cs, best_t, best_i);
  }
  r.finish_bounce(running, can_cont, best_t, best_i, rows, sc, n_bands);
  if (have_ray) r.store(st, n, ray, n_bands);
}

template <int LB>
int launch(float* state, long long n, int ncols, const float* rows, int cs,
           const int* sched, int width, const float* scal,
           int tiles_per_pose, int n_bands, int max_bounces,
           cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kNR * (size_t)cs;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = n / kThreads;
  trace_sched_kernel<LB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      state, n, rows, cs, sched, width, scal, tiles_per_pose, n_bands,
      max_bounces);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ar2_trace_sched(float* state, long long n, int ncols,
                               const float* rows, int cs, const int* sched,
                               int width, const float* scal, int n_poses,
                               long long rays_per_pose, int n_bands,
                               int layout_bands, int max_bounces,
                               void* stream) {
  if (n <= 0 || n % kThreads || cs < 1 || width < 1 || n_bands < 1 ||
      n_poses < 1 || rays_per_pose * n_poses != n || rays_per_pose % kThreads)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_pose = (int)(rays_per_pose / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout_bands) {
    case 1:
      return launch<1>(state, n, ncols, rows, cs, sched, width, scal,
                       tiles_per_pose, n_bands, max_bounces, s);
    case 4:
      return launch<4>(state, n, ncols, rows, cs, sched, width, scal,
                       tiles_per_pose, n_bands, max_bounces, s);
    case 8:
      return launch<8>(state, n, ncols, rows, cs, sched, width, scal,
                       tiles_per_pose, n_bands, max_bounces, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
