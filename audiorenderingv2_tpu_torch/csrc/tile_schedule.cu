// The per-tile schedule of the clustered route: for each tile of 128
// consecutive rays, the clusters that some ray of the tile that is not done
// can reach.
//
// Replaces audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:tile_schedule
// (exact mode, :1103-1182), which is plain XLA on the TPU, not a Pallas
// kernel; at 1M rays and 621 clusters it is 6.2e8 slab tests a round, which
// eager PyTorch would run through [tiles, 3, C, 128] intermediates in
// device memory. Each ray is slab-tested against each cluster box with the
// plain version's arithmetic (ops/schedule_cuda.py:tile_schedule_plain):
// inv = 1 / v with |v| floored at 1e-20 (IEEE division), t = (lo - p) * inv,
// entry = max(t_near, 0), reachable when t_far >= entry, the box's flag is
// set and the ray is not done. Output row: count, the reachable ids
// ascending, then zeros; rows equal the plain version's as integers.
//
// Design. One block per tile, one thread per ray. Boxes are staged through
// shared memory in chunks of kBoxChunk (32 KiB). Per box, a warp ORs its
// rays' verdicts with __ballot_sync; each warp gathers 32 verdicts into a
// word and ORs it into a shared bitmask with one atomicOr. Warp 0 then
// compacts the chunk's bitmask into ascending ids with __popc and a shuffle
// prefix sum. What bounds it: FP32 slab math, about 20 operations per ray
// and box (12 GFLOP a round at the office scene's full width); the box
// reads are shared-memory broadcasts.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kBoxChunk = 1024;  // boxes per shared-memory chunk; 32 words
constexpr float kEpsDir = 1e-20f;
constexpr unsigned kFull = 0xffffffffu;
enum { C_PX, C_PY, C_PZ, C_VX, C_VY, C_VZ, C_DONE = 9 };

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) > kEpsDir ? v : (v >= 0.f ? kEpsDir : -kEpsDir));
}

__global__ void __launch_bounds__(kTile)
tile_schedule_kernel(const float* __restrict__ st, long long n,
                     const float* __restrict__ boxes, int n_clusters,
                     int* __restrict__ sched, int width) {
  __shared__ float s_box[kBoxChunk * 8];
  __shared__ unsigned s_mask[kBoxChunk / 32];
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ray = (long long)blockIdx.x * kTile + tid;
  bool live = false;
  float px = 0.f, py = 0.f, pz = 0.f, ix = 0.f, iy = 0.f, iz = 0.f;
  if (ray < n) {
    live = st[C_DONE * n + ray] == 0.f;
    px = st[C_PX * n + ray];
    py = st[C_PY * n + ray];
    pz = st[C_PZ * n + ray];
    ix = safe_inv(st[C_VX * n + ray]);
    iy = safe_inv(st[C_VY * n + ray]);
    iz = safe_inv(st[C_VZ * n + ray]);
  }
  if (tid == 0) s_count = 0;
  int* row = sched + (long long)blockIdx.x * width;

  for (int c0 = 0; c0 < n_clusters; c0 += kBoxChunk) {
    const int nb = min(kBoxChunk, n_clusters - c0);
    __syncthreads();  // the previous chunk's mask and count are consumed
    for (int k = tid; k < nb * 8; k += kTile)
      s_box[k] = boxes[(long long)c0 * 8 + k];
    for (int k = tid; k < kBoxChunk / 32; k += kTile) s_mask[k] = 0u;
    __syncthreads();

    unsigned word = 0u;
    for (int j = 0; j < nb; ++j) {
      const float* b = s_box + j * 8;
      bool ok = false;
      if (live) {
        float t1 = (b[0] - px) * ix;
        float t2 = (b[3] - px) * ix;
        float tn = fminf(t1, t2), tf = fmaxf(t1, t2);
        t1 = (b[1] - py) * iy;
        t2 = (b[4] - py) * iy;
        tn = fmaxf(tn, fminf(t1, t2));
        tf = fminf(tf, fmaxf(t1, t2));
        t1 = (b[2] - pz) * iz;
        t2 = (b[5] - pz) * iz;
        tn = fmaxf(tn, fminf(t1, t2));
        tf = fminf(tf, fmaxf(t1, t2));
        ok = tf >= fmaxf(tn, 0.f) && b[6] > 0.f;
      }
      if (__ballot_sync(kFull, ok)) word |= 1u << (j & 31);
      if ((j & 31) == 31 || j == nb - 1) {
        if (lane == 0 && word) atomicOr(&s_mask[j >> 5], word);
        word = 0u;
      }
    }
    __syncthreads();

    if (warp == 0) {  // lane w compacts mask word w
      const unsigned m = lane < (nb + 31) / 32 ? s_mask[lane] : 0u;
      const int cnt = __popc(m);
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      int pos = 1 + s_count + incl - cnt;
      for (unsigned bits = m; bits; bits &= bits - 1)
        row[pos++] = c0 + lane * 32 + __ffs(bits) - 1;
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
  if (n <= 0 || n % kTile || n_clusters < 1 || width < n_clusters + 1)
    return (int)cudaErrorInvalidValue;
  tile_schedule_kernel<<<(unsigned)(n / kTile), kTile, 0,
                         (cudaStream_t)stream>>>(state, n, boxes, n_clusters,
                                                 sched, width);
  return (int)cudaGetLastError();
}
