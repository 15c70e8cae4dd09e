// K5: bounces of every ray over a clustered scene, the clusters found and
// ordered inside the kernel.
//
// Replaces the in-kernel traversal branch of the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2
// (`use_cull and not use_sched`, :547-661, with cluster_intersect :484-494,
// launched by trace_round_v2 with boxes and no `sched`). A tile is 128
// consecutive rays. Per bounce and tile:
//
//   1. every alive ray is slab-tested against every cluster box (the
//      arithmetic of csrc/tile_schedule.cu), and each cluster's entry
//      distance is the least max(t_near, 0) over the alive rays that reach
//      its box, +inf when none does or the box's valid flag is 0;
//   2. clusters are visited in increasing entry distance (ties: lowest id),
//      each visit testing the cluster's cs triangle rows against every alive
//      ray with a strict running minimum, so that among equal distances the
//      cluster visited first keeps the hit; the visits stop when the nearest
//      unvisited entry is not below the largest best hit of an alive ray
//      (+inf while some alive ray has no hit; 0 when no ray is alive): no
//      remaining cluster can then improve any ray;
//   3. K1's receiver test and bounce tail (trace_common.cuh).
//
// The slab pass sits inside the bounce, so a round may hold any number of
// bounces: positions are never stale.
//
// Design. One block of 128 threads is one tile, one thread one ray, state in
// registers for the round. Entry distances are >= 0, so their bit patterns
// order as unsigned integers: pass 1 folds a warp's entries with
// __reduce_min_sync and one shared atomicMin per warp and box, boxes staged
// through shared memory in chunks. Pass 2 picks the next cluster by a block
// reduction over 64-bit keys (entry bits, then id) and the stop test by a
// block maximum of the alive rays' best hits; the cluster's rows (12 KiB at
// cs = 128) are staged into shared memory; a visited cluster's entry is set
// to +inf. Every thread, done or not, reaches every barrier. What bounds it
// on Hopper: FP32 slab math (23 operations per ray and box, every bounce,
// where the schedule route pays them in a kernel of their own) and FP32
// intersection of the rows actually visited; three barriers per visit.
//
// Poses: `scal` is [P, 16], the state pose-major, and tile i reads scalar
// row i // tiles_per_pose, as in K2. `visits`, when not null, is int32
// [n_tiles]: the kernel adds each tile's cluster visits of the round to it.

#include "trace_common.cuh"

namespace {

using namespace ar2;

constexpr float kEpsDir = 1e-20f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxChunk = 256;  // boxes per shared-memory chunk (8 KiB)

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) > kEpsDir ? v : (v >= 0.f ? kEpsDir : -kEpsDir));
}

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_traverse_kernel(float* __restrict__ st, long long n,
                      const float* __restrict__ rows, int cs,
                      const float* __restrict__ boxes, int n_clusters,
                      const float* __restrict__ scal, int tiles_per_pose,
                      int n_bands, int budget, int max_bounces,
                      int* __restrict__ visits) {
  extern __shared__ float smem[];
  float* s_rows = smem;                                       // cs * kNR
  unsigned* s_entry = (unsigned*)(smem + (size_t)cs * kNR);   // n_clusters
  float* s_box = (float*)(s_entry + n_clusters);              // kBoxChunk * 8
  __shared__ unsigned long long s_key[kWarps];
  __shared__ unsigned s_far[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ray = (long long)blockIdx.x * kThreads + tid;
  const bool have_ray = ray < n;
  const Scalars sc(scal + (long long)(blockIdx.x / tiles_per_pose) * kNScal);
  const float fmax_b = (float)max_bounces;
  Ray<LB> r;
  r.load(st, n, ray, have_ray, n_bands);
  int n_visits = 0;

  for (int i = 0; i < budget; ++i) {
    const bool running = have_ray && r.done == 0.f;
    if (!__syncthreads_or(running)) break;
    const bool can_cont = r.can_continue(sc, n_bands, fmax_b);
    const bool alive = running && can_cont;

    // Pass 1: per-cluster entry distances of the tile.
    for (int c = tid; c < n_clusters; c += kThreads) s_entry[c] = kInfBits;
    const float ix = safe_inv(r.vx), iy = safe_inv(r.vy), iz = safe_inv(r.vz);
    for (int c0 = 0; c0 < n_clusters; c0 += kBoxChunk) {
      const int nb = min(kBoxChunk, n_clusters - c0);
      __syncthreads();  // entries reset; the previous chunk is consumed
      load_rows(s_box, boxes + (long long)c0 * 8, nb * 8);
      __syncthreads();
      for (int j = 0; j < nb; ++j) {
        const float* b = s_box + j * 8;
        unsigned e = kInfBits;
        if (alive) {
          float t1 = (b[0] - r.px) * ix;
          float t2 = (b[3] - r.px) * ix;
          float tn = fminf(t1, t2), tf = fmaxf(t1, t2);
          t1 = (b[1] - r.py) * iy;
          t2 = (b[4] - r.py) * iy;
          tn = fmaxf(tn, fminf(t1, t2));
          tf = fminf(tf, fmaxf(t1, t2));
          t1 = (b[2] - r.pz) * iz;
          t2 = (b[5] - r.pz) * iz;
          tn = fmaxf(tn, fminf(t1, t2));
          tf = fminf(tf, fmaxf(t1, t2));
          const float entry = tn > 0.f ? tn : 0.f;  // +0, never -0
          if (tf >= entry && b[6] > 0.f) e = __float_as_uint(entry);
        }
        e = __reduce_min_sync(kFull, e);
        if (lane == 0 && e != kInfBits) atomicMin(&s_entry[c0 + j], e);
      }
    }

    // Pass 2: visit clusters front to back.
    float best_t = CUDART_INF_F;
    int best_i = -1;
    while (true) {
      __syncthreads();  // pass 1's entries, or the last visit's mark
      unsigned long long key = ~0ull;
      for (int c = tid; c < n_clusters; c += kThreads) {
        const unsigned long long k =
            ((unsigned long long)s_entry[c] << 32) | (unsigned)c;
        key = k < key ? k : key;
      }
      for (int off = 16; off; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, key, off);
        key = o < key ? o : key;
      }
      const unsigned far =
          __reduce_max_sync(kFull, alive ? __float_as_uint(best_t) : 0u);
      if (lane == 0) {
        s_key[warp] = key;
        s_far[warp] = far;
      }
      __syncthreads();
      unsigned long long kmin = s_key[0];
      unsigned fmax = s_far[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        kmin = s_key[w] < kmin ? s_key[w] : kmin;
        fmax = s_far[w] > fmax ? s_far[w] : fmax;
      }
      const float tn_k = __uint_as_float((unsigned)(kmin >> 32));
      if (!(tn_k < __uint_as_float(fmax))) break;
      const int c = (int)(kmin & 0xffffffffu);
      load_rows(s_rows, rows + (long long)c * cs * kNR, cs * kNR);
      if (tid == 0) s_entry[c] = kInfBits;  // visited
      __syncthreads();
      if (alive) r.intersect(s_rows, cs, c * cs, best_t, best_i);
      ++n_visits;
    }
    r.finish_bounce(running, can_cont, best_t, best_i, rows, sc, n_bands);
  }
  if (visits != nullptr && tid == 0) visits[blockIdx.x] += n_visits;
  if (have_ray) r.store(st, n, ray, n_bands);
}

template <int LB>
int launch(float* state, long long n, int ncols, const float* rows, int cs,
           const float* boxes, int n_clusters, const float* scal,
           int tiles_per_pose, int n_bands, int budget, int max_bounces,
           int* visits, cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kNR * cs + n_clusters +
                                       (size_t)kBoxChunk * 8);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = n / kThreads;
  trace_traverse_kernel<LB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      state, n, rows, cs, boxes, n_clusters, scal, tiles_per_pose, n_bands,
      budget, max_bounces, visits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ar2_trace_traverse(float* state, long long n, int ncols,
                                  const float* rows, int cs,
                                  const float* boxes, int n_clusters,
                                  const float* scal, int n_poses,
                                  long long rays_per_pose, int n_bands,
                                  int layout_bands, int budget,
                                  int max_bounces, int* visits,
                                  void* stream) {
  if (n <= 0 || n % kThreads || cs < 1 || n_clusters < 1 || n_bands < 1 ||
      budget < 1 || n_poses < 1 || rays_per_pose * n_poses != n ||
      rays_per_pose % kThreads)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_pose = (int)(rays_per_pose / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout_bands) {
    case 1:
      return launch<1>(state, n, ncols, rows, cs, boxes, n_clusters, scal,
                       tiles_per_pose, n_bands, budget, max_bounces, visits,
                       s);
    case 4:
      return launch<4>(state, n, ncols, rows, cs, boxes, n_clusters, scal,
                       tiles_per_pose, n_bands, budget, max_bounces, visits,
                       s);
    case 8:
      return launch<8>(state, n, ncols, rows, cs, boxes, n_clusters, scal,
                       tiles_per_pose, n_bands, budget, max_bounces, visits,
                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
