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
// thread runs one ray at a time through its own bounces, the state in the
// port's [ncols, N] column layout and in registers while the ray runs. What
// bounds it on Hopper is the issue of the intersection's instructions
// (about 40 FP32 operations a ray and triangle, built without FMA
// contraction, plus the IEEE division and the compares), and divergence: a
// warp that runs its 32 rays side by side runs as long as its longest one.
//
// A scene of at most kChunk rows (every scene the rows route takes) runs
// trace_rows_kernel. Each block stages the rows once into shared memory,
// zero rows padding them to a multiple of kUnroll, and the search stops at
// the last row whose VAL is set: a row with VAL 0 never hits, so leaving
// it out changes no result. A row is read as four float4 broadcasts,
// kUnroll rows unrolled (Ray::intersect_f4, the test K2 and K5 use), and
// the tail reads the bounced-off triangle's normal and absorptions from
// the staged rows. Rays come to a warp in groups of consecutive rays:
// warp w of W takes groups w, w + W, w + 2W, ..., and a lane whose ray
// ends (done, or its budget spent) stores it and takes the warp's next
// ray. A round of at most kPersistBudget bounces gets a warp per 32 rays,
// one group each, so a lane that ends early idles, as one ray a thread
// would. A longer round runs on a persistent grid (the blocks that stay
// resident) with groups of 8 rays (one 32-byte sector a column), so that
// lanes stay busy until the warp's share runs out instead of waiting on
// the warp's longest ray: in the box render's 68-bounce round one ray a
// thread keeps 57% of the lanes busy. In short rounds, where few lanes
// idle, the refills' scattered loads and the uneven shares cost more than
// they save. Each ray still runs its own bounces with the same arithmetic,
// so its result does not change. A ray that is done on entry only has
// LTRI cleared.
//
// A larger scene (the baseline of K1 over every row of a clustered scene)
// runs trace_chunks_kernel: one ray a thread, the rows staged through
// shared memory in chunks of kChunk (48 KiB), all threads of a block
// stepping through the chunks of every bounce together.
//
// Poses (K1-pose: the same TPU kernel launched with `tiles_per_pose`,
// raytrace_pallas_v2.py:887-904, where tile i reads scalar row
// i // tiles_per_pose). `scal` is [P, 16] and the state is pose-major: rays
// [p * rays_per_pose, (p + 1) * rays_per_pose) belong to pose p, and a ray
// reads the scalar row of its pose. One pose with rays_per_pose = n is the
// single-pose launch, unchanged.

#include "trace_common.cuh"

namespace {

using namespace ar2;

constexpr int kChunk = 512;   // triangle rows per shared-memory chunk
constexpr int kUnroll = 4;    // rows per unrolled step of the one-chunk test
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Rounds of more bounces than this run on a persistent grid; shorter ones
// give every warp 32 consecutive rays and no more (the same kernel).
constexpr int kPersistBudget = 32;

__host__ __device__ constexpr int padded_rows(int n_tris) {
  return (n_tris + kUnroll - 1) / kUnroll * kUnroll;
}

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_rows_kernel(float* __restrict__ st, long long n,
                  const float* __restrict__ tris, int n_tris,
                  const float* __restrict__ scal, long long rays_per_pose,
                  int n_bands, int budget, int max_bounces, int group_log2) {
  extern __shared__ __align__(16) float s_rows[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_last = -1;
  __syncthreads();
  int last = -1;
  for (int k = tid; k < padded_rows(n_tris) * kNR; k += kThreads) {
    const float v = k < n_tris * kNR ? tris[k] : 0.f;
    s_rows[k] = v;
    if (k % kNR == R_VAL && v > 0.f) last = k / kNR;
  }
  if (last >= 0) atomicMax(&s_last, last);
  __syncthreads();
  const int n_test = padded_rows(s_last + 1);
  const RowAttrs staged{s_rows};

  const long long warp = ((long long)blockIdx.x * kThreads + tid) >> 5;
  const long long n_warps = (long long)gridDim.x * kWarps;
  // The warp's rays come in groups of 2^group_log2 consecutive rays:
  // groups w, w + W, w + 2W, ... of W warps.
  const long long n_groups = ((n - 1) >> group_log2) + 1;
  const long long group_mask = (1ll << group_log2) - 1;
  const unsigned below = (1u << lane) - 1u;
  const float fmax_b = (float)max_bounces;
  long long taken = 0;  // rays this warp has handed out, warp-uniform
  bool exhausted = warp >= n_groups;
  long long ray = -1;   // this lane's ray; -1 while the lane is idle
  int bounces = 0;      // bounces of that ray in this round
  Ray<LB> r;
  Scalars sc(scal);

  while (true) {
    // Idle lanes take the warp's next rays, in order; a ray that is done
    // on entry only has LTRI cleared, and its lane takes the next one.
    while (!exhausted) {
      const unsigned need = __ballot_sync(kFull, ray < 0);
      if (need == 0u) break;
      if (ray < 0) {
        const long long j = taken + __popc(need & below);
        const long long group = warp + (j >> group_log2) * n_warps;
        const long long cand = (group << group_log2) + (j & group_mask);
        if (group < n_groups && cand < n) {
          if (st[C_DONE * n + cand] == 0.f) {
            ray = cand;
            bounces = 0;
            r = Ray<LB>();
            r.load(st, n, ray, true, n_bands);
            sc = Scalars(scal + (ray / rays_per_pose) * kNScal);
          } else {
            st[C_LTRI * n + cand] = 0.f;
          }
        }
      }
      taken += __popc(need);
      exhausted = warp + (taken >> group_log2) * n_warps >= n_groups;
    }
    if (!__any_sync(kFull, ray >= 0)) break;
    if (ray >= 0) {
      const bool can_cont = r.can_continue(sc, n_bands, fmax_b);
      float best_t = CUDART_INF_F;
      int best_i = -1;
      if (can_cont)
        r.template intersect_f4<kUnroll>(s_rows, n_test, 0, best_t, best_i);
      r.finish_bounce(true, can_cont, best_t, best_i, staged, sc, n_bands);
      if (r.done != 0.f || ++bounces == budget) {
        r.store(st, n, ray, n_bands);
        ray = -1;
      }
    }
  }
}

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_chunks_kernel(float* __restrict__ st, long long n,
                    const float* __restrict__ tris, int n_tris,
                    const float* __restrict__ scal, long long rays_per_pose,
                    int n_bands, int budget, int max_bounces) {
  extern __shared__ __align__(16) float s_rows[];
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool have_ray = ray < n;
  const long long pose = ((long long)blockIdx.x * blockDim.x) / rays_per_pose;
  const Scalars sc(scal + pose * kNScal);
  const float fmax_b = (float)max_bounces;
  Ray<LB> r;
  r.load(st, n, ray, have_ray, n_bands);

  for (int i = 0; i < budget; ++i) {
    const bool running = have_ray && r.done == 0.f;
    if (!__syncthreads_or(running)) break;
    const bool can_cont = r.can_continue(sc, n_bands, fmax_b);
    const bool alive = running && can_cont;
    float best_t = CUDART_INF_F;
    int best_i = -1;
    for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
      const int rows = min(kChunk, n_tris - c0);
      __syncthreads();
      load_rows(s_rows, tris + (long long)c0 * kNR, rows * kNR);
      __syncthreads();
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
  if (n_tris > kChunk) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    trace_chunks_kernel<LB><<<(unsigned)blocks, kThreads,
                              sizeof(float) * kNR * kChunk, stream>>>(
        state, n, tris, n_tris, scal, rays_per_pose, n_bands, budget,
        max_bounces);
    return (int)cudaGetLastError();
  }
  // The rows, padded, beside the static last-row index: over the default
  // 48 KiB a block at kChunk rows.
  const size_t smem = sizeof(float) * kNR * (size_t)padded_rows(n_tris);
  cudaError_t err = cudaSuccess;
  if (smem > 47 * 1024)
    err = cudaFuncSetAttribute(trace_rows_kernel<LB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trace_rows_kernel<LB>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // One warp per 32 consecutive rays, or as many blocks as stay resident,
  // each warp taking groups of 8 rays (one 32-byte sector a column).
  const long long want = (n + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const bool persist = budget > kPersistBudget && resident < want;
  trace_rows_kernel<LB><<<(unsigned)(persist ? resident : want), kThreads,
                          smem, stream>>>(
      state, n, tris, n_tris, scal, rays_per_pose, n_bands, budget,
      max_bounces, persist ? 3 : 5);
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
