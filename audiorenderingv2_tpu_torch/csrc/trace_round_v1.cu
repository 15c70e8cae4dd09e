// K7: the version-1 bounce round, rays in rows.
//
// Replaces the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas.py:_trace_round_kernel (launched
// by trace_round). Same physics as K1 over other layouts: the ray state is
// row-major [N, 16] (one 64-byte row per ray), the triangles a [17, T]
// table, T a multiple of 128 and not trimmed (quantity rows as in K1's
// triangle rows, then the absorption at row 15 and the valid flag at row
// 16). One band. Per bounce the nearest Moller-Trumbore hit over all T
// columns, the lowest index on ties, then the tail of trace_common.cuh.
// Columns 13-15 (RAYID, LTRI, RECVD) are stored as zeros: version 1 records
// no topology. The budget is an argument, so every round shares this one
// kernel.
//
// Design. The TPU kernel holds a tile of rays in sublanes and sweeps
// 128-triangle lane chunks with a running minimum across chunks. That is
// not carried over tile by tile: here one thread owns one ray, reads its
// row as four 16-byte loads, keeps it in registers for the whole round and
// leaves as soon as the ray is done. The table is staged in shared memory,
// kChunk columns at a time (a multiple of the TPU kernel's 128); every
// thread of a warp reads the same column of it, a broadcast. A table that
// fits one chunk (T <= 640) is loaded once per block and the threads then
// run free of barriers; a larger one runs block-synchronously, all threads
// of a block stepping through the chunks of every bounce together. What
// bounds it is FP32 throughput in the search, about 40 operations per ray
// and column over all T padded columns; the state is read and written once
// per round. The other design, a warp per ray with the triangles across the
// lanes and a shuffle arg-min, suits scenes of thousands of unclustered
// triangles and few rays; at a million rays and a few hundred columns a
// thread per ray keeps every lane busy without any reduction.

#include "trace_common.cuh"

namespace {

using namespace ar2;

constexpr int kRows = 17;     // rows of the triangle table
constexpr int kVAbs = 15;     // absorption row (the valid flag is row 16)
constexpr int kVVal = 16;
constexpr int kChunk = 640;   // columns per shared-memory chunk (43,520 B)
constexpr int kNCols = 16;    // floats per ray row

// The bounced-off triangle's attributes in the [17, T] table.
struct TableAttrs {
  const float* tris;
  int n_tris;
  __device__ float normal(int tri, int axis) const {
    return tris[(long long)(R_NX + axis) * n_tris + tri];
  }
  __device__ float absorption(int tri, int) const {
    return tris[(long long)kVAbs * n_tris + tri];
  }
};

// Stage columns [c0, c0 + cols) of every row: s[k * cols + j].
__device__ __forceinline__ void load_table(float* s, const float* tris,
                                           int n_tris, int c0, int cols) {
  for (int k = threadIdx.x; k < kRows * cols; k += blockDim.x) {
    const int row = k / cols, j = k - row * cols;
    s[k] = tris[(long long)row * n_tris + c0 + j];
  }
}

// Nearest valid hit over the staged columns (global index c0 + j), folded
// into (best_t, best_i) with a strict `<`: ties keep the lower index. The
// operations are K1's (Ray::intersect), in its order.
__device__ __forceinline__ void intersect_table(const Ray<1>& r,
                                                const float* s, int cols,
                                                int c0, float& best_t,
                                                int& best_i) {
  for (int j = 0; j < cols; ++j) {
    const float* q = s + j;
    const float pnx = q[R_PNX * cols], pny = q[R_PNY * cols],
                pnz = q[R_PNZ * cols];
    const float nd = r.vx * pnx + r.vy * pny + r.vz * pnz;
    const float no = r.px * pnx + r.py * pny + r.pz * pnz + q[R_PD * cols];
    const bool safe = fabsf(nd) > kSafeDen;
    const float tt = -no / (safe ? nd : 1.0f);
    const float aux = q[R_AUX * cols], auy = q[R_AUY * cols],
                auz = q[R_AUZ * cols];
    const float ou = r.px * aux + r.py * auy + r.pz * auz + q[R_AUO * cols];
    const float du = r.vx * aux + r.vy * auy + r.vz * auz;
    const float u = ou + tt * du;
    const float avx = q[R_AVX * cols], avy = q[R_AVY * cols],
                avz = q[R_AVZ * cols];
    const float ov = r.px * avx + r.py * avy + r.pz * avz + q[R_AVO * cols];
    const float dv = r.vx * avx + r.vy * avy + r.vz * avz;
    const float v = ov + tt * dv;
    const bool ok = safe && tt > kTMin && u >= -kBaryEps && v >= -kBaryEps &&
                    u + v <= 1.0f + kBaryEps && q[kVVal * cols] > 0.f;
    if (ok && tt < best_t) {
      best_t = tt;
      best_i = c0 + j;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
trace_round_v1_kernel(float* __restrict__ st, long long n,
                      const float* __restrict__ tris, int n_tris,
                      const float* __restrict__ scal, int budget,
                      int max_bounces) {
  extern __shared__ float s_table[];
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool have_ray = ray < n;
  const bool one_chunk = n_tris <= kChunk;
  if (one_chunk) {
    load_table(s_table, tris, n_tris, 0, n_tris);
    __syncthreads();
  }
  const Scalars sc(scal);
  const TableAttrs tri_attrs{tris, n_tris};
  const float fmax_b = (float)max_bounces;
  Ray<1> r;
  float4* row = reinterpret_cast<float4*>(st + ray * kNCols);
  if (have_ray) {
    const float4 a = row[0], b = row[1], c = row[2], d = row[3];
    r.px = a.x; r.py = a.y; r.pz = a.z; r.vx = a.w;
    r.vy = b.x; r.vz = b.y; r.dist = b.z; r.en[0] = b.w;
    r.depth = c.x; r.done = c.y; r.evb = c.z; r.ew[0] = c.w;
    r.eve = d.x;
  } else {
    r.en[0] = r.ew[0] = 0.f;
  }

  for (int i = 0; i < budget; ++i) {
    const bool running = have_ray && r.done == 0.f;
    if (one_chunk) {
      if (!running) break;
    } else if (!__syncthreads_or(running)) {
      break;
    }
    const bool can_cont = r.can_continue(sc, 1, fmax_b);
    const bool alive = running && can_cont;
    float best_t = CUDART_INF_F;
    int best_i = -1;
    for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
      const int cols = min(kChunk, n_tris - c0);
      if (!one_chunk) {
        __syncthreads();
        load_table(s_table, tris, n_tris, c0, cols);
        __syncthreads();
      }
      if (alive) intersect_table(r, s_table, cols, c0, best_t, best_i);
    }
    r.finish_bounce(running, can_cont, best_t, best_i, tri_attrs, sc, 1);
  }
  if (have_ray) {
    row[0] = make_float4(r.px, r.py, r.pz, r.vx);
    row[1] = make_float4(r.vy, r.vz, r.dist, r.en[0]);
    row[2] = make_float4(r.depth, r.done, r.evb, r.ew[0]);
    row[3] = make_float4(r.eve, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" int ar2_trace_round_v1(float* state, long long n,
                                  const float* tris, int n_tris,
                                  const float* scal, int budget,
                                  int max_bounces, void* stream) {
  if (n <= 0 || n_tris < 1 || budget < 1 ||
      (reinterpret_cast<size_t>(state) & 15))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const size_t smem =
      sizeof(float) * kRows * (size_t)(n_tris < kChunk ? n_tris : kChunk);
  trace_round_v1_kernel<<<(unsigned)blocks, kThreads, smem,
                          (cudaStream_t)stream>>>(state, n, tris, n_tris,
                                                  scal, budget, max_bounces);
  return (int)cudaGetLastError();
}
