// K5: bounces of every ray over a clustered scene, the clusters found and
// ordered inside the kernel.
//
// Replaces the in-kernel traversal branch of the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2
// (`use_cull and not use_sched`, :547-661, with cluster_intersect :484-494,
// launched by trace_round_v2 with boxes and no `sched`). A tile is 128
// consecutive rays. Per bounce and tile:
//
//   1. every alive ray is slab-tested against the cluster boxes (the
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
// order as unsigned integers, and (entry bits, id) as one 64-bit key orders
// the visits.
//
// Pass 1 tests two levels, as the schedule kernel does: each block builds,
// once, a superbox per group of 32 consecutive (Morton-ordered) clusters,
// the union of the group's flagged boxes; a warp slab-tests its rays
// against a superbox and computes its children's entries only when some
// lane reaches it. That is exact: under round-to-nearest (lo - p) * inv is
// monotone in lo, so a superbox's entry is at most each child's, and a ray
// that reaches a child reaches its superbox. A child's entry is folded over
// the warp with __reduce_min_sync and into the child's key with one shared
// atomicMin, its bit set in the group's mask word.
//
// Pass 2 sorts once. Warp 0 compacts the reached clusters (set mask bits)
// into a list of keys, and each thread ranks its keys against the whole
// list: the keys are distinct, so the ranks sort them. Visiting the sorted
// list in order is the old visit sequence: a visited cluster's entry never
// changes the others'. The stop test before each visit is one
// __syncthreads_or(alive && entry < best_t), true exactly when the entry
// is below the largest best hit of an alive ray. Past that barrier no
// thread still reads the previous visit's rows, so thread 0 copies the
// visit's cs rows with one cp.async.bulk that completes on an mbarrier, and
// the block waits for it: one barrier and one wait a visit. The test reads
// rows as float4, 16 rows unrolled (Ray::intersect_f4, K1's and K2's).
// Copying the next clusters' rows while this one is tested (K2's ring)
// measured slower on an H100: the stop test leaves copies unused, and the
// other blocks of the SM hide one copy's latency.
//
// What bounds it on Hopper: the issue of the FP32 intersection of the rows
// actually visited, and the slab tests of the superboxes and of the
// children of the reached ones. Every thread, done or not, reaches every
// barrier.
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
constexpr int kGroup = 32;   // clusters per superbox: one mask word
constexpr int kUnroll = 16;  // rows per unrolled step; cs is a multiple
// What a block may take: the card's 227 KiB, less the static barriers.
constexpr size_t kMaxSmem = 226 * 1024;

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) > kEpsDir ? v : (v >= 0.f ? kEpsDir : -kEpsDir));
}

// Dynamic shared memory of a block: one cluster's rows, then a superbox
// per group (two float4), a key per cluster, the sorted list (a key per
// cluster), a mask word per group.
__host__ __device__ inline size_t traverse_smem(int cs, int n_clusters) {
  const size_t groups = (n_clusters + kGroup - 1) / kGroup;
  return sizeof(float) * kNR * (size_t)cs + 32 * groups +
         16 * (size_t)n_clusters + 4 * groups;
}

// One ray's slab test. A box is two float4: (lo x, lo y, lo z, hi x),
// (hi y, hi z, flag, 0).
struct Slab {
  bool alive;
  float px, py, pz, ix, iy, iz;

  // The bits of the entry distance max(t_near, 0) when the ray is alive,
  // reaches the box and the box's flag is set; kInfBits otherwise. The
  // plain version's arithmetic (schedule_cuda.slab_pass), in its order.
  __device__ __forceinline__ unsigned entry(float4 a, float4 c) const {
    float t1 = (a.x - px) * ix;
    float t2 = (a.w - px) * ix;
    float tn = fminf(t1, t2), tf = fmaxf(t1, t2);
    t1 = (a.y - py) * iy;
    t2 = (c.x - py) * iy;
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
    t1 = (a.z - pz) * iz;
    t2 = (c.y - pz) * iz;
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
    const float e = tn > 0.f ? tn : 0.f;  // +0, never -0
    return alive && tf >= e && c.z > 0.f ? __float_as_uint(e) : kInfBits;
  }
};

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_traverse_kernel(float* __restrict__ st, long long n,
                      const float* __restrict__ rows, int cs,
                      const float* __restrict__ boxes, int n_clusters,
                      const float* __restrict__ scal, int tiles_per_pose,
                      int n_bands, int budget, int max_bounces,
                      int* __restrict__ visits) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t s_full;
  __shared__ int s_count;
  const int n_groups = (n_clusters + kGroup - 1) / kGroup;
  const int stage_floats = cs * kNR;
  const uint32_t stage_bytes = (uint32_t)stage_floats * sizeof(float);
  float* s_rows = smem;                                 // one cluster's rows
  float4* s_sup = (float4*)(s_rows + stage_floats);
  unsigned long long* s_key = (unsigned long long*)(s_sup + 2 * n_groups);
  unsigned long long* s_list = s_key + n_clusters;
  unsigned* s_mask = (unsigned*)(s_list + n_clusters);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ray = (long long)blockIdx.x * kThreads + tid;
  const bool have_ray = ray < n;
  const Scalars sc(scal + (long long)(blockIdx.x / tiles_per_pose) * kNScal);
  const float fmax_b = (float)max_bounces;
  const float4* box4 = reinterpret_cast<const float4*>(boxes);
  Ray<LB> r;
  r.load(st, n, ray, have_ray, n_bands);

  // Superboxes: warp w builds groups w, w + 4, ...; lane j reads child j.
  // A group with no flagged child keeps a zeroed box and flag 0.
  for (int g = warp; g < n_groups; g += kWarps) {
    const int j = g * kGroup + lane;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    if (j < n_clusters) {
      a = box4[2 * j];
      c = box4[2 * j + 1];
    }
    const bool valid = j < n_clusters && c.z > 0.f;
    const float inf = CUDART_INF_F;
    float lx = valid ? a.x : inf, ly = valid ? a.y : inf;
    float lz = valid ? a.z : inf, hx = valid ? a.w : -inf;
    float hy = valid ? c.x : -inf, hz = valid ? c.y : -inf;
    for (int off = 16; off; off >>= 1) {
      lx = fminf(lx, __shfl_xor_sync(kFull, lx, off));
      ly = fminf(ly, __shfl_xor_sync(kFull, ly, off));
      lz = fminf(lz, __shfl_xor_sync(kFull, lz, off));
      hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, off));
      hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, off));
      hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, off));
    }
    const bool any = __ballot_sync(kFull, valid) != 0u;
    if (lane == 0) {
      s_sup[2 * g] = any ? make_float4(lx, ly, lz, hx)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      s_sup[2 * g + 1] = any ? make_float4(hy, hz, 1.f, 0.f)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (tid == 0) {
    mbar_init(&s_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  uint32_t phase = 0;  // parity of the rows barrier's current phase
  int n_visits = 0;
  for (int i = 0; i < budget; ++i) {
    const bool running = have_ray && r.done == 0.f;
    if (!__syncthreads_or(running)) break;
    for (int c = tid; c < n_clusters; c += kThreads)
      s_key[c] = ((unsigned long long)kInfBits << 32) | (unsigned)c;
    for (int g = tid; g < n_groups; g += kThreads) s_mask[g] = 0u;
    __syncthreads();
    const bool can_cont = r.can_continue(sc, n_bands, fmax_b);
    const bool alive = running && can_cont;

    // Pass 1: each reached cluster's least entry over the tile.
    if (__any_sync(kFull, alive)) {
      const Slab slab{alive, r.px, r.py, r.pz, safe_inv(r.vx),
                      safe_inv(r.vy), safe_inv(r.vz)};
      for (int g = 0; g < n_groups; ++g) {
        if (!__any_sync(kFull,
                        slab.entry(s_sup[2 * g], s_sup[2 * g + 1]) !=
                            kInfBits))
          continue;
        const int j0 = g * kGroup, j1 = min(j0 + kGroup, n_clusters);
        for (int j = j0; j < j1; ++j) {
          unsigned e = slab.entry(__ldg(box4 + 2 * j), __ldg(box4 + 2 * j + 1));
          e = __reduce_min_sync(kFull, e);
          if (lane == 0 && e != kInfBits) {
            atomicMin(&s_key[j], ((unsigned long long)e << 32) | (unsigned)j);
            atomicOr(&s_mask[g], 1u << (j - j0));
          }
        }
      }
    }
    __syncthreads();

    // Pass 2: the reached clusters' keys, compacted in id order, then
    // sorted into s_key by rank.
    if (warp == 0) {
      int count = 0;
      for (int g0 = 0; g0 < n_groups; g0 += 32) {
        const int g = g0 + lane;
        const unsigned m = g < n_groups ? s_mask[g] : 0u;
        const int cnt = __popc(m);
        int incl = cnt;
        for (int off = 1; off < 32; off <<= 1) {
          const int up = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += up;
        }
        int pos = count + incl - cnt;
        for (unsigned bits = m; bits; bits &= bits - 1)
          s_list[pos++] = s_key[g * kGroup + __ffs(bits) - 1];
        count += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) s_count = count;
    }
    __syncthreads();
    const int n_reached = s_count;
    for (int a = tid; a < n_reached; a += kThreads) {
      const unsigned long long key = s_list[a];
      int rank = 0;
      for (int b = 0; b < n_reached; ++b) rank += s_list[b] < key ? 1 : 0;
      s_key[rank] = key;
    }
    __syncthreads();

    // Visit the sorted list front to back. Thread 0 copies the visit's
    // rows once every thread has passed the visit's barrier, so nobody
    // still reads the previous visit's.
    float best_t = CUDART_INF_F;
    int best_i = -1;
    int k = 0;
    for (; k < n_reached; ++k) {
      const unsigned long long key = s_key[k];
      const float tn_k = __uint_as_float((unsigned)(key >> 32));
      if (!__syncthreads_or(alive && tn_k < best_t)) break;
      const int c = (int)(unsigned)key;
      if (tid == 0)
        bulk_load(s_rows, rows + (long long)c * stage_floats, stage_bytes,
                  &s_full);
      mbar_wait(&s_full, phase);
      phase ^= 1u;
      if (alive)
        r.template intersect_f4<kUnroll>(s_rows, cs, c * cs, best_t, best_i);
    }
    n_visits += k;
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
  const size_t smem = traverse_smem(cs, n_clusters);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 47 * 1024) {  // over the default 48 KiB with the barriers
    const cudaError_t err = cudaFuncSetAttribute(
        trace_traverse_kernel<LB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
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
  // A cluster's rows are one bulk copy and boxes are read as float4: both
  // 16-byte aligned.
  if (n <= 0 || n % kThreads || cs < 1 || cs % kUnroll || n_clusters < 1 ||
      n_bands < 1 || budget < 1 || n_poses < 1 ||
      rays_per_pose * n_poses != n || rays_per_pose % kThreads ||
      reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(boxes) % 16)
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
