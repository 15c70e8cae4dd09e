// The per-tile schedule of the clustered route: for each tile of 128
// consecutive rays, the clusters that some ray of the tile that is not done
// can reach.
//
// Replaces audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:tile_schedule
// (exact mode, :1103-1182), which is plain XLA on the TPU, not a Pallas
// kernel. Each ray is slab-tested against the cluster boxes with the plain
// version's arithmetic (ops/schedule_cuda.py:tile_schedule_plain): inv =
// 1 / v with |v| floored at 1e-20 (IEEE division), t = (lo - p) * inv,
// entry = max(t_near, 0), reachable when t_far >= entry, the box's flag is
// set and the ray is not done. Output row: count, the reachable ids
// ascending, then zeros; rows equal the plain version's as integers.
//
// Design: a two-level test. One block per tile, one thread per ray. Boxes
// are staged through shared memory in chunks of kBoxChunk (32 KiB, read as
// two float4 a box); the block then builds, per group of 32 consecutive
// (Morton-ordered) clusters, a superbox: the union of the valid children's
// boxes, valid when any child is. A warp slab-tests its rays against a
// superbox with the same arithmetic and tests the 32 children only when
// some lane reaches it, ORing the children's ballots into the chunk's mask
// word. The list stays exact: under round-to-nearest (lo - p) * inv is
// monotone in lo, and min and max keep order, so a superbox's t_near is at
// most each child's and its t_far at least each child's; a ray that
// reaches a child reaches its superbox. Flag-0 children (padding) stay out
// of the union. A tile with no live ray writes count 0 and zeros; a warp
// with no live lane tests nothing. Warp 0 compacts each chunk's mask into
// ascending ids with __popc and a shuffle prefix sum.
//
// What bounds it: the all-pairs count (every ray against every box, about
// 23 FP32 operations a test) is no longer the work done; a coherent tile
// reaches a few superboxes. The bound of the function is the bytes: seven
// state columns read once and the rows written once.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "trace_common.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kGroup = 32;        // clusters per superbox: one mask word
constexpr int kBoxChunk = 1024;   // boxes per shared-memory chunk
constexpr int kGroups = kBoxChunk / kGroup;
constexpr unsigned kFull = 0xffffffffu;
enum { C_PX, C_PY, C_PZ, C_VX, C_VY, C_VZ, C_DONE = 9 };
using ar2::safe_inv;

// One box in shared memory: (lo x, lo y, lo z, hi x), (hi y, hi z, flag, 0).
struct Ray {
  bool live;
  float px, py, pz, ix, iy, iz;

  // The plain version's slab test (trace_common.cuh: box_reached).
  __device__ __forceinline__ bool reaches(const float4* b) const {
    float entry;
    return live &&
           ar2::box_reached(b[0], b[1], px, py, pz, ix, iy, iz, entry);
  }
};

__global__ void __launch_bounds__(kTile)
tile_schedule_kernel(const float* __restrict__ st, long long n,
                     const float* __restrict__ boxes, int n_clusters,
                     int* __restrict__ sched, int width) {
  __shared__ float4 s_box[kBoxChunk * 2];
  __shared__ float4 s_sup[kGroups * 2];
  __shared__ unsigned s_mask[kGroups];
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ray = (long long)blockIdx.x * kTile + tid;
  Ray r{false, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ray < n) {
    r.live = st[C_DONE * n + ray] == 0.f;
    r.px = st[C_PX * n + ray];
    r.py = st[C_PY * n + ray];
    r.pz = st[C_PZ * n + ray];
    r.ix = safe_inv(st[C_VX * n + ray]);
    r.iy = safe_inv(st[C_VY * n + ray]);
    r.iz = safe_inv(st[C_VZ * n + ray]);
  }
  int* row = sched + (long long)blockIdx.x * width;
  if (tid == 0) s_count = 0;
  if (!__syncthreads_or(r.live)) {  // every ray of the tile is done
    for (int k = tid; k < width; k += kTile) row[k] = 0;
    return;
  }
  const bool warp_live = __any_sync(kFull, r.live);
  const float4* box4 = reinterpret_cast<const float4*>(boxes);

  for (int c0 = 0; c0 < n_clusters; c0 += kBoxChunk) {
    const int nb = min(kBoxChunk, n_clusters - c0);
    const int ng = (nb + kGroup - 1) / kGroup;
    __syncthreads();  // the previous chunk's boxes and mask are consumed
    for (int k = tid; k < nb * 2; k += kTile)
      s_box[k] = box4[(long long)c0 * 2 + k];
    for (int k = tid; k < kGroups; k += kTile) s_mask[k] = 0u;
    __syncthreads();

    // Superboxes: warp w builds groups w, w + 4, ...; lane j reads child j.
    for (int g = warp; g < ng; g += kTile / 32) {
      const int j = g * kGroup + lane;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
      if (j < nb) {
        a = s_box[2 * j];
        c = s_box[2 * j + 1];
      }
      const bool valid = j < nb && c.z > 0.f;
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
        // A group with no valid child keeps a zeroed box and flag 0, as
        // padding clusters have.
        s_sup[2 * g] = any ? make_float4(lx, ly, lz, hx)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        s_sup[2 * g + 1] = any ? make_float4(hy, hz, 1.f, 0.f)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();

    if (warp_live) {
      for (int g = 0; g < ng; ++g) {
        if (!__ballot_sync(kFull, r.reaches(s_sup + 2 * g))) continue;
        const int j0 = g * kGroup, j1 = min(j0 + kGroup, nb);
        unsigned word = 0u;
        for (int j = j0; j < j1; ++j)
          if (__ballot_sync(kFull, r.reaches(s_box + 2 * j)))
            word |= 1u << (j - j0);
        if (lane == 0 && word) atomicOr(&s_mask[g], word);
      }
    }
    __syncthreads();

    if (warp == 0) {  // lane w compacts mask word w
      const unsigned m = lane < ng ? s_mask[lane] : 0u;
      const int cnt = __popc(m);
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      int pos = 1 + s_count + incl - cnt;
      for (unsigned bits = m; bits; bits &= bits - 1)
        row[pos++] = c0 + lane * kGroup + __ffs(bits) - 1;
      __syncwarp();
      if (lane == 31) s_count += incl;
    }
  }
  __syncthreads();
  const int count = s_count;
  if (tid == 0) row[0] = count;
  for (int k = 1 + count + tid; k < width; k += kTile) row[k] = 0;
}

}  // namespace

extern "C" int ar2_tile_schedule(const float* state, long long n,
                                 const float* boxes, int n_clusters,
                                 int* sched, int width, void* stream) {
  if (n <= 0 || n % kTile || n_clusters < 1 || width < n_clusters + 1 ||
      reinterpret_cast<unsigned long long>(boxes) % 16)
    return (int)cudaErrorInvalidValue;
  tile_schedule_kernel<<<(unsigned)(n / kTile), kTile, 0,
                         (cudaStream_t)stream>>>(state, n, boxes, n_clusters,
                                                 sched, width);
  return (int)cudaGetLastError();
}
