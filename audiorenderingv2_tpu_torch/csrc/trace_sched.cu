// K2: one bounce of every ray over its tile's candidate clusters.
//
// Replaces the schedule branch of the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2
// (`use_cull and use_sched`, :501-546, launched by trace_round_v2 with
// `sched`). A tile is 128 consecutive rays; its row of the schedule
// (csrc/tile_schedule.cu) holds the count, then the ids of the clusters
// some ray of the tile can reach, ascending. Per ray: the nearest
// Moller-Trumbore hit over the rows of those clusters that some ray of its
// warp reaches nearer than its hit so far (the cull below), visited in
// list order with a strict running minimum (ties to the lowest row, as on
// the TPU), then K1's receiver test and bounce tail (trace_common.cuh).
// The round is one bounce: the schedule is computed from the positions
// before it.
//
// Design. One block of 128 threads is one tile, one thread one ray, the
// ray's state in registers. The tile's candidate clusters stream through a
// ring of shared-memory stages: thread 0 fills a stage with one bulk
// asynchronous copy of the cluster's cs rows (cp.async.bulk, completing on
// the stage's "full" mbarrier), up to the ring's depth ahead; each warp
// arrives on the stage's "empty" mbarrier when its rays are done with it,
// and thread 0 refills the stage once all four warps have. No block-wide
// barrier in the loop, and the copies of the next clusters overlap the
// tests of this one. A test reads a row as four float4 broadcasts (columns
// 0-15), 16 rows unrolled (Ray::intersect_f4 of trace_common.cuh, shared
// with K1 and K5), and runs Ray::intersect's operations in its order. What
// bounds it: the issue of the test's instructions, built
// without FMA contraction for bit equality with the plain version: about
// 66 a test (37 FP32 operations, the IEEE division's ~10, the compares),
// against the bound's 40 operations. Exact pre-tests on each row (the
// sign of the quotient, the running minimum) skip too little work in a
// warp to pay for their branches, and were left out; the cull below
// tests a whole cluster at once.
//
// The cull. The tile's list is the union of what its 128 rays reach, but
// a warp runs the union of its own 32 lanes' work. So each live lane
// slab-tests its ray against the candidate's box with the schedule's own
// test (box_reached, the box read through the read-only cache), and the
// warp tests the cluster's rows only when some lane reaches the box at an
// entry nearer than the lane's running minimum; otherwise it just waits
// on and releases the stage. The warp's reached set is a subset of the
// tile's list, computed from the same positions by the same test, and a
// row inside a box the ray enters at or past its running minimum cannot
// beat it under the strict minimum, so a ray's nearest hit is unchanged
// wherever the schedule's own culling is exact; the visit order, the
// strict running minimum and the ties to the lowest row are as before.
// (On the office's states at 1M rays the entry term took 3-12% off K2's
// time beside the box test alone, and changed no ray.) Every warp still
// waits on every stage's full barrier, so that no warp runs a phase ahead
// of a copy (the parity wait could not tell the two phases apart). Done
// rays wait on and release every stage, and a tile with count 0 still
// runs the receiver test. `visits`, when not null, is int32 [n_tiles]:
// each warp adds the candidates whose rows it tested to its tile's entry.
//
// Poses (the TPU kernel with `tiles_per_pose`, raytrace_pallas_v2.py:
// 887-904): `scal` is [P, 16], the state pose-major, and tile i reads scalar
// row i // tiles_per_pose. The schedule is per tile and reads positions
// only, so it is the same for any P. One pose is the single-pose launch.

#include <cstdint>

#include "trace_common.cuh"

namespace {

using namespace ar2;

constexpr int kMaxStages = 4;
constexpr int kStageBudget = 16 * 1024;  // bytes of rows the ring aims for
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;  // rows per unrolled step; cs is a multiple

__host__ __device__ constexpr int ring_stages(int stage_bytes) {
  return stage_bytes * kMaxStages <= kStageBudget ? kMaxStages
         : stage_bytes * 3 <= kStageBudget        ? 3
                                                  : 2;
}

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_sched_kernel(float* __restrict__ st, long long n,
                   const float* __restrict__ rows, int cs,
                   const float* __restrict__ boxes,
                   const int* __restrict__ sched, int width,
                   const float* __restrict__ scal, int tiles_per_pose,
                   int n_bands, int max_bounces, int* __restrict__ visits) {
  extern __shared__ __align__(128) float s_rows[];
  __shared__ uint64_t s_full[kMaxStages], s_empty[kMaxStages];
  const int tid = threadIdx.x;
  const long long ray = (long long)blockIdx.x * kThreads + tid;
  const bool have_ray = ray < n;
  const Scalars sc(scal + (long long)(blockIdx.x / tiles_per_pose) * kNScal);
  Ray<LB> r;
  r.load(st, n, ray, have_ray, n_bands);
  const bool running = have_ray && r.done == 0.f;
  const bool can_cont = r.can_continue(sc, n_bands, (float)max_bounces);
  const bool alive = running && can_cont;

  const int* list = sched + (long long)blockIdx.x * width;
  const int count = list[0];
  const int stage_floats = cs * kNR;
  const uint32_t stage_bytes = (uint32_t)stage_floats * sizeof(float);
  const int stages = ring_stages((int)stage_bytes);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&s_full[s], 1);
      mbar_init(&s_empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < min(stages, count); ++k)
      bulk_load(s_rows + k * stage_floats,
                rows + (long long)list[1 + k] * stage_floats, stage_bytes,
                &s_full[k]);

  const float4* box4 = reinterpret_cast<const float4*>(boxes);
  const float ix = safe_inv(r.vx), iy = safe_inv(r.vy), iz = safe_inv(r.vz);
  float best_t = CUDART_INF_F;
  int best_i = -1;
  int n_visits = 0;
  for (int k = 0; k < count; ++k) {
    // Thread 0 refills the stage that candidate k - 1 used once every warp
    // has released it.
    const int j = k - 1, next = j + stages;
    if (tid == 0 && j >= 0 && next < count) {
      const int s = j % stages;
      mbar_wait(&s_empty[s], (uint32_t)(j / stages) & 1u);
      bulk_load(s_rows + s * stage_floats,
                rows + (long long)list[1 + next] * stage_floats, stage_bytes,
                &s_full[s]);
    }
    const int c = list[1 + k];
    float entry;
    const bool nearer = alive &&
                        box_reached(__ldg(box4 + 2 * c),
                                    __ldg(box4 + 2 * c + 1), r.px, r.py,
                                    r.pz, ix, iy, iz, entry) &&
                        entry < best_t;
    const bool visit = __ballot_sync(kAllLanes, nearer) != 0u;
    const int s = k % stages;
    mbar_wait(&s_full[s], (uint32_t)(k / stages) & 1u);
    if (visit) {
      ++n_visits;
      if (alive)
        r.template intersect_f4<kUnroll>(s_rows + s * stage_floats, cs,
                                         c * cs, best_t, best_i);
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&s_empty[s]);
  }
  if (visits != nullptr && (tid & 31) == 0 && n_visits > 0)
    atomicAdd(visits + blockIdx.x, n_visits);
  r.finish_bounce(running, can_cont, best_t, best_i, rows, sc, n_bands);
  if (have_ray) r.store(st, n, ray, n_bands);
}

template <int LB>
int launch(float* state, long long n, int ncols, const float* rows, int cs,
           const float* boxes, const int* sched, int width,
           const float* scal, int tiles_per_pose, int n_bands,
           int max_bounces, int* visits, cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  const size_t stage_bytes = sizeof(float) * kNR * (size_t)cs;
  const size_t smem = stage_bytes * ring_stages((int)stage_bytes);
  if (smem > 47 * 1024) {  // over the default 48 KiB with the barriers
    const cudaError_t err = cudaFuncSetAttribute(
        trace_sched_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = n / kThreads;
  trace_sched_kernel<LB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      state, n, rows, cs, boxes, sched, width, scal, tiles_per_pose,
      n_bands, max_bounces, visits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ar2_trace_sched(float* state, long long n, int ncols,
                               const float* rows, int cs,
                               const float* boxes, const int* sched,
                               int width, const float* scal, int n_poses,
                               long long rays_per_pose, int n_bands,
                               int layout_bands, int max_bounces,
                               int* visits, void* stream) {
  // A cluster's rows are one bulk copy: 16-byte aligned, whole 16 bytes;
  // a box is read as two float4.
  if (n <= 0 || n % kThreads || cs < 1 || cs % kUnroll || cs > 1024 ||
      width < 1 ||
      n_bands < 1 || n_poses < 1 || rays_per_pose * n_poses != n ||
      rays_per_pose % kThreads ||
      reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(boxes) % 16)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_pose = (int)(rays_per_pose / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout_bands) {
    case 1:
      return launch<1>(state, n, ncols, rows, cs, boxes, sched, width, scal,
                       tiles_per_pose, n_bands, max_bounces, visits, s);
    case 4:
      return launch<4>(state, n, ncols, rows, cs, boxes, sched, width, scal,
                       tiles_per_pose, n_bands, max_bounces, visits, s);
    case 8:
      return launch<8>(state, n, ncols, rows, cs, boxes, sched, width, scal,
                       tiles_per_pose, n_bands, max_bounces, visits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
