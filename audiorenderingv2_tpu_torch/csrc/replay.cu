// The replay of recorded paths for an absorption-only gradient: a forward
// kernel that walks each ray's recorded triangles and writes its event
// slot, and a backward kernel that reduces the gradient of the events'
// weights into the absorption table.
//
// Replaces no pl.pallas_call. On the TPU the replay is plain XLA
// (audiorenderingv2_tpu/diff/replay.py:replay_events, a lax.scan over the
// bounces that jit fuses); the port ran it as an eager chain of about 100
// PyTorch launches a bounce, whose backward added every bounce's
// absorption gradient into the [T, n_bands] table by one index_add_ of all
// N rays (ops/replay_cuda.py:chain_events, still the path of a pose or a
// geometry gradient). With the poses and the geometry fixed, only a ray's
// weight depends on the parameters:
//
//   ev_w[i, b] = e0 * prod_{k < r_i, tri_ik >= 0} (1 - a[tri_ik, b]) * chord_i
//
// where r_i = recv_step[i] (a ray with r_i < 0 deposits nothing) and no
// step after r_i matters. This file computes the chain's events and that
// gradient; ops/replay_cuda.py's replay_plain and replay_bwd_plain are its
// plain versions.
//
// Forward, ar2_replay: one thread a ray. A ray that deposits walks
// k = 0 .. r - 1 with the chain's arithmetic in its order (the plane
// intersection, the reflection, the BOUNCE_EPSILON offset, the distance,
// the sequential product of (1 - a)), then takes the receiver sphere's
// entry at step r (core/tracer.py:_sphere_entry). The library is built
// with -fmad=false and IEEE division and square root, so ev_bin, ev_ear
// and ev_w equal the chain's on the card bit for bit. A row of tri_ids is
// read by 16-byte loads when K is a multiple of 4 (so every row is
// aligned), the triangle rows through the read-only cache. The kernel also
// writes chord [N] (0 where the ray deposits nothing), which the backward
// reads in place of walking the geometry again.
//
// Backward, ar2_replay_bwd: given g = d loss / d ev_w [N, n_bands],
//
//   grad_a[t, b] = sum over rays i, visits k of t before r_i of
//                  -g[i, b] * chord_i * e0 * prod_{j != k} (1 - a[tri_ij, b])
//
// with no division by (1 - a), so a row whose 1 - a is 0 gets the chain's
// gradient. One warp a depositing ray: lane l takes the ray's steps
// 4l .. 4l + 3 of a chunk of 128 (one 16-byte load a lane, the warp's row
// read as 512 contiguous bytes), the products before and after each step
// come from a multiplicative scan over the lanes (and over the chunks for
// K > 128). A warp finds its depositing rays 32 at a time by a ballot over
// recv_step and chord. What bounds it on this card is the reduction: most
// bounces of a room land on its few shell triangles, so the index_add_ it
// replaces issued about one contended global atomic a ray a bounce. Here
// the lanes of one warp that hold the same triangle first sum their values
// (__match_any_sync, then a shuffle tree over the peers), and one lane
// adds the sum into a per-block copy of the table in shared memory; at
// the end the block adds each non-zero entry with one global atomic.
// Where the table does not fit a block's shared memory (T * n_bands * 4
// bytes over the device's opt-in limit: the office's 19,852 rows fit at
// one band, 79 KB, not at 8, 635 KB), the peers' sum goes to device
// memory directly (a float4 reduction a 4-band row). The choice is made
// here from the table's shape. The f32 atomics add in a run-dependent
// order: the gradient agrees with the chain's to a few ulp of each sum,
// not bit for bit.
//
// The pose variant (ar2_replay and ar2_replay_bwd given a tan pointer):
// where the emitter requires a gradient as well, the same walk carries forward-mode
// tangents against the emitter's three coordinates. On a recorded path
// the directions do not depend on the emitter, so a move of the emitter
// moves each ray's line parallel to itself: along the first direction v0
// it shortens the path by as much (the arrival's tangent -v0), across it
// it displaces the line by P = I - v0 v0^T a unit move. A plane hit
// mirrors the line, so P <- (I - 2 n n^T) P, in registers (12 floats a
// ray with v0). (The hit point also slides along the line, by
// n^T P / (n.v); a slide along a line leaves the line and the arrival
// where they are, so carrying it, as the chain's autograd does, would only
// add terms that cancel later, which float32 would round away at a
// grazing hit.) At the receiver, with oc = p - c, b = oc.v and
// s = sqrt(b^2 - (oc.oc - r^2)), a displacement x across the line moves
// t1 = -b - s by (oc.x) / s, t2 = -b + s by -(oc.x) / s and the chord 2 s
// by -2 (oc.x) / s: the arrival's tangent is -v0 plus that of the branch
// the forward took (s taken in double for the tangents, below). The
// forward writes per ray tan [N, 6] = (d ev_bin / d e, d chord / d e),
// zeros where it deposits nothing. The backward runs the absorption
// backward above (unless the table needs no gradient) and reduces
//
//   grad_e = sum over depositing rays of
//            g_bin * d ev_bin / d e
//            + (sum_b g_w[b] ev_w[b]) / chord * d chord / d e
//
// (ev_w / chord is the ray's energy, which does not depend on the
// emitter) per thread, over the warp by shuffles, over the block in shared
// memory, and into the 3 outputs by one atomic a block and coordinate. The
// absorption-only kernels are the same templates with the pose flag off,
// under their own names, and so are the launchers. ops/replay_cuda.py's
// chain_events(tangents=True), through replay_plain and replay_bwd_plain,
// is the plain version.
//
// Band counts 1, 4 and 8 are the templates' capacities; a count between
// runs on the next capacity with the unused bands idle. The wrapper
// (ops/replay_cuda.py) allocates every output and checks shapes, types
// and devices; the backward zero-fills its gradient on the stream.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kChunk = 128;      // steps a warp takes at once, 4 a lane
constexpr int kMaxChunks = 32;   // chunk carries ride one a lane
constexpr unsigned kFull = 0xffffffffu;

// Scalars of the launch: emitter xyz, receiver centre xyz, sin and cos of
// the receiver's yaw (computed by PyTorch on the device, as the chain).
enum { S_EX, S_EY, S_EZ, S_CX, S_CY, S_CZ, S_SIN, S_COS };

struct Consts {
  float e0, bin_rate, eps, t_min, r2;
  int n_tris;
};

// A triangle id past the table is the caller's fault: stop the kernel, as
// index_select's device-side assert stops the chain.
__device__ __forceinline__ void check_id(int tri, int n_tris) {
  if (tri >= n_tris) __trap();
}

template <int LB>
struct Ray {
  float px, py, pz, vx, vy, vz, dist;
  float e[LB];
};

// The emitter's tangents of one ray (the pose variant): p[r][c], the
// displacement of the ray's line across its direction along axis r per
// unit move of the emitter along axis c, and d0, the first direction.
struct Tangent {
  float p[3][3];
  float d0[3];
};

// A plane hit mirrors the line: P <- P - 2 n (n^T P), in the order of
// ops/replay_cuda.py:_surface_tangent.
__device__ __forceinline__ void surface_tangent(Tangent& g, float nx,
                                                float ny, float nz) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float q2 =
        2.0f * ((nx * g.p[0][c] + ny * g.p[1][c]) + nz * g.p[2][c]);
    g.p[0][c] = g.p[0][c] - nx * q2;
    g.p[1][c] = g.p[1][c] - ny * q2;
    g.p[2][c] = g.p[2][c] - nz * q2;
  }
}

// The receiver entry's tangents (ops/replay_cuda.py:_entry_tangent): out
// = (d ev_bin / d e, d chord / d e) from the position, the direction, the
// centre, oc = p - c, the forward's s (the fallback) and the branch taken.
// The tangents scale as 1 / s, and near a grazing entry the forward's
// b^2 - (oc.oc - r^2) (some 100 m^2 against an s^2 of 1e-4) keeps few of
// float32's digits, so s is taken again in double from the same float32
// position and direction, and rounded to float once.
__device__ __forceinline__ void entry_tangent(const Tangent& g, float px,
                                              float py, float pz, float vx,
                                              float vy, float vz, float cx,
                                              float cy, float cz, float ox,
                                              float oy, float oz, float sq,
                                              bool first, float bin_rate,
                                              float r2, float* out) {
  const double dx = (double)px - (double)cx, dy = (double)py - (double)cy,
               dz = (double)pz - (double)cz;
  const double bd = (dx * (double)vx + dy * (double)vy) + dz * (double)vz;
  const double disc = bd * bd - (((dx * dx + dy * dy) + dz * dz) - (double)r2);
  float sh = (float)sqrt(disc > 0.0 ? disc : 0.0);
  sh = sh > 0.0f ? sh : sq;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float w = (ox * g.p[0][c] + oy * g.p[1][c]) + oz * g.p[2][c];
    const float ws = w / sh;
    const float dt = first ? ws : -ws;
    out[c] = (-g.d0[c] + dt) * bin_rate;
    out[3 + c] = -(ws + ws);
  }
}

// One surface step of the chain (ops/replay_cuda.py:chain_events), each
// operation rounded on its own: the plane intersection, the reflection,
// the offset along it, the distance and the energy; with ``kPose`` the
// tangents ``tg`` are mirrored too.
template <int LB, bool kPose>
__device__ __forceinline__ void advance(Ray<LB>& r, Tangent& tg, int tri,
                                        const float* __restrict__ plane_n,
                                        const float* __restrict__ plane_d,
                                        const float* __restrict__ normal,
                                        const float* __restrict__ absorb,
                                        int nb, const Consts& c) {
  check_id(tri, c.n_tris);
  const float pnx = __ldg(plane_n + 3 * tri), pny = __ldg(plane_n + 3 * tri + 1),
              pnz = __ldg(plane_n + 3 * tri + 2);
  const float nd = (pnx * r.vx + pny * r.vy) + pnz * r.vz;
  const float no = ((pnx * r.px + pny * r.py) + pnz * r.pz)
                   + __ldg(plane_d + tri);
  const float t = (-no) / (fabsf(nd) > 1e-12f ? nd : 1.0f);
  const float nx = __ldg(normal + 3 * tri), ny = __ldg(normal + 3 * tri + 1),
              nz = __ldg(normal + 3 * tri + 2);
  if constexpr (kPose) surface_tangent(tg, nx, ny, nz);
  const float s2 = 2.0f * ((r.vx * nx + r.vy * ny) + r.vz * nz);
  const float rx = r.vx - s2 * nx, ry = r.vy - s2 * ny, rz = r.vz - s2 * nz;
  r.px = (r.px + t * r.vx) + c.eps * rx;
  r.py = (r.py + t * r.vy) + c.eps * ry;
  r.pz = (r.pz + t * r.vz) + c.eps * rz;
  r.vx = rx;
  r.vy = ry;
  r.vz = rz;
  r.dist = r.dist + t;
  const float* a = absorb + (long long)tri * nb;
#pragma unroll
  for (int b = 0; b < LB; ++b)
    if (b < nb) r.e[b] = r.e[b] * (1.0f - __ldg(a + b));
}

// One ray of the forward; with ``kPose`` also its tangents into tan_out.
template <int LB, bool kPose>
__device__ __forceinline__ void replay_ray(
    const int* __restrict__ ids, long long n, int k_steps, bool vec4,
    const int* __restrict__ recv, const float* __restrict__ dirs,
    const float* __restrict__ scal, const float* __restrict__ plane_n,
    const float* __restrict__ plane_d, const float* __restrict__ normal,
    const float* __restrict__ absorb, int nb, const Consts& c,
    float* __restrict__ ev_bin, float* __restrict__ ev_w,
    int* __restrict__ ev_ear, float* __restrict__ chord_out,
    float* __restrict__ tan_out) {
  const long long i = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  if (i >= n) return;
  const int rs = recv[i];
  float bin = 0.0f, chord = 0.0f;
  int ear = 0;
  float w[LB];
#pragma unroll
  for (int b = 0; b < LB; ++b) w[b] = 0.0f;
  float tan[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  Tangent tg;
  if (rs >= 0 && rs < k_steps) {
    Ray<LB> r;
    r.px = __ldg(scal + S_EX);
    r.py = __ldg(scal + S_EY);
    r.pz = __ldg(scal + S_EZ);
    r.vx = dirs[3 * i];
    r.vy = dirs[3 * i + 1];
    r.vz = dirs[3 * i + 2];
    r.dist = 0.0f;
    if constexpr (kPose) {
      tg.d0[0] = r.vx;
      tg.d0[1] = r.vy;
      tg.d0[2] = r.vz;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          tg.p[a][b] = (a == b ? 1.0f : 0.0f) - tg.d0[a] * tg.d0[b];
    }
#pragma unroll
    for (int b = 0; b < LB; ++b) r.e[b] = c.e0;
    const int* row = ids + i * k_steps;
    if (vec4) {
      for (int k4 = 0; 4 * k4 < rs; ++k4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(row) + k4);
        const int t[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (4 * k4 + s < rs && t[s] >= 0)
            advance<LB, kPose>(r, tg, t[s], plane_n, plane_d, normal,
                               absorb, nb, c);
      }
    } else {
      for (int k = 0; k < rs; ++k) {
        const int t = __ldg(row + k);
        if (t >= 0)
          advance<LB, kPose>(r, tg, t, plane_n, plane_d, normal, absorb, nb,
                             c);
      }
    }
    // The receiver sphere's entry (core/tracer.py:_sphere_entry).
    const float cx = __ldg(scal + S_CX), cy = __ldg(scal + S_CY),
                cz = __ldg(scal + S_CZ);
    const float ox = r.px - cx, oy = r.py - cy, oz = r.pz - cz;
    const float bq = (ox * r.vx + oy * r.vy) + oz * r.vz;
    const float cq = ((ox * ox + oy * oy) + oz * oz) - c.r2;
    const float disc = bq * bq - cq;
    const bool hit = disc > 0.0f;
    const float sq = sqrtf(hit ? disc : 0.0f);
    const float t1 = -bq - sq, t2 = -bq + sq;
    const float t_hit = (hit && t1 > c.t_min) ? t1
                        : ((hit && t2 > c.t_min) ? t2 : CUDART_INF_F);
    if (isfinite(t_hit)) {
      chord = t2 - t1;
      bin = (r.dist + t_hit) * c.bin_rate;
      const float dx = (r.px + t_hit * r.vx) - cx;
      const float dz = (r.pz + t_hit * r.vz) - cz;
      const float lz = (-__ldg(scal + S_SIN)) * dx + __ldg(scal + S_COS) * dz;
      ear = lz >= 0.0f;
#pragma unroll
      for (int b = 0; b < LB; ++b) w[b] = r.e[b] * chord;
      if constexpr (kPose)
        entry_tangent(tg, r.px, r.py, r.pz, r.vx, r.vy, r.vz, cx, cy, cz,
                      ox, oy, oz, sq, hit && t1 > c.t_min, c.bin_rate, c.r2,
                      tan);
    }
  }
  ev_bin[i] = bin;
  ev_ear[i] = ear;
  chord_out[i] = chord;
#pragma unroll
  for (int b = 0; b < LB; ++b)
    if (b < nb) ev_w[i * nb + b] = w[b];
  if constexpr (kPose) {
#pragma unroll
    for (int a = 0; a < 6; ++a) tan_out[6 * i + a] = tan[a];
  }
}

template <int LB>
__global__ void __launch_bounds__(kFwdThreads)
replay_kernel(const int* __restrict__ ids, long long n, int k_steps,
              bool vec4, const int* __restrict__ recv,
              const float* __restrict__ dirs, const float* __restrict__ scal,
              const float* __restrict__ plane_n,
              const float* __restrict__ plane_d,
              const float* __restrict__ normal,
              const float* __restrict__ absorb, int nb, Consts c,
              float* __restrict__ ev_bin, float* __restrict__ ev_w,
              int* __restrict__ ev_ear, float* __restrict__ chord_out) {
  replay_ray<LB, false>(ids, n, k_steps, vec4, recv, dirs, scal, plane_n,
                        plane_d, normal, absorb, nb, c, ev_bin, ev_w, ev_ear,
                        chord_out, nullptr);
}

template <int LB>
__global__ void __launch_bounds__(kFwdThreads)
replay_pose_kernel(const int* __restrict__ ids, long long n, int k_steps,
                   bool vec4, const int* __restrict__ recv,
                   const float* __restrict__ dirs,
                   const float* __restrict__ scal,
                   const float* __restrict__ plane_n,
                   const float* __restrict__ plane_d,
                   const float* __restrict__ normal,
                   const float* __restrict__ absorb, int nb, Consts c,
                   float* __restrict__ ev_bin, float* __restrict__ ev_w,
                   int* __restrict__ ev_ear, float* __restrict__ chord_out,
                   float* __restrict__ tan_out) {
  replay_ray<LB, true>(ids, n, k_steps, vec4, recv, dirs, scal, plane_n,
                       plane_d, normal, absorb, nb, c, ev_bin, ev_w, ev_ear,
                       chord_out, tan_out);
}

// ------------------------------------------------------------- backward

// Products over the lanes: exclusive from below (lane 0 gets 1) and from
// above (lane 31 gets 1).
__device__ __forceinline__ float scan_below(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v *= o;
  }
  const float ex = __shfl_up_sync(kFull, v, 1);
  return lane ? ex : 1.0f;
}

__device__ __forceinline__ float scan_above(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v *= o;
  }
  const float ex = __shfl_down_sync(kFull, v, 1);
  return lane < 31 ? ex : 1.0f;
}

__device__ __forceinline__ float warp_product(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v *= __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum x over the lanes of ``peers`` (the lanes holding the same key) into
// the lowest of them: a tree over the peers' ranks, one shuffle a band a
// level.
template <int LB>
__device__ __forceinline__ void reduce_peers(unsigned peers, float (&x)[LB],
                                             int lane) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer up, 0 if none
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const float t = __shfl_sync(kFull, x[b], (next - 1) & 31);
      if (next) x[b] += t;
    }
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

// This lane's 4 steps of chunk ``c`` of the ray's row: the triangle of each
// step that counts (before r, on a surface), else -1.
__device__ __forceinline__ void chunk_ids(const int* __restrict__ row, int c,
                                          int lane, int rs, bool vec4,
                                          int n_tris, int (&t)[4]) {
  const int j0 = c * kChunk + 4 * lane;
  if (j0 >= rs) {
    t[0] = t[1] = t[2] = t[3] = -1;
    return;
  }
  if (vec4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(row + j0));
    t[0] = q.x;
    t[1] = q.y;
    t[2] = q.z;
    t[3] = q.w;
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) t[s] = j0 + s < rs ? __ldg(row + j0 + s) : -1;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (j0 + s >= rs || t[s] < 0) t[s] = -1;
    check_id(t[s], n_tris);
  }
}

template <int LB>
__device__ __forceinline__ void factors(const int (&t)[4],
                                        const float* __restrict__ absorb,
                                        int nb, float (&f)[4][LB]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* a = absorb + (long long)(t[s] < 0 ? 0 : t[s]) * nb;
#pragma unroll
    for (int b = 0; b < LB; ++b)
      f[s][b] = (t[s] >= 0 && b < nb) ? 1.0f - __ldg(a + b) : 1.0f;
  }
}

// The peers' sum of one row: into the block's table, or into device memory
// (float4 reductions where ``rows4``: the row fills the capacity and is
// 16-byte aligned).
template <int LB, bool kShared>
__device__ __forceinline__ void add_row(float* __restrict__ acc,
                                        float* __restrict__ grad, int tri,
                                        int nb, bool rows4,
                                        const float (&x)[LB]) {
  if (kShared) {
#pragma unroll
    for (int b = 0; b < LB; ++b)
      if (b < nb) atomicAdd(acc + tri * nb + b, x[b]);
  } else if (LB > 1 && rows4) {
    float4* dst = reinterpret_cast<float4*>(grad + (long long)tri * LB);
#pragma unroll
    for (int q = 0; q < LB / 4; ++q)
      atomicAdd(dst + q, make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                     x[4 * q + 3]));
  } else {
#pragma unroll
    for (int b = 0; b < LB; ++b)
      if (b < nb) atomicAdd(grad + (long long)tri * nb + b, x[b]);
  }
}

// One depositing ray, its scale G[b] = g * chord * e0, by one warp.
template <int LB, bool kShared>
__device__ void ray_gradient(const int* __restrict__ row, int rs, bool vec4,
                             const float (&G)[LB],
                             const float* __restrict__ absorb, int n_tris,
                             int nb, bool rows4, float* __restrict__ acc,
                             float* __restrict__ grad, int lane) {
  const int n_chunks = (rs + kChunk - 1) / kChunk;
  // The products of the chunks before and after this lane's chunk index.
  float below_c[LB], above_c[LB];
#pragma unroll
  for (int b = 0; b < LB; ++b) below_c[b] = above_c[b] = 1.0f;
  if (n_chunks > 1) {
    float mine[LB];
#pragma unroll
    for (int b = 0; b < LB; ++b) mine[b] = 1.0f;
    for (int c = 0; c < n_chunks; ++c) {
      int t[4];
      float f[4][LB];
      chunk_ids(row, c, lane, rs, vec4, n_tris, t);
      factors(t, absorb, nb, f);
#pragma unroll
      for (int b = 0; b < LB; ++b) {
        const float p = warp_product(((f[0][b] * f[1][b]) * f[2][b]) * f[3][b]);
        if (lane == c) mine[b] = p;
      }
    }
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      below_c[b] = scan_below(mine[b], lane);
      above_c[b] = scan_above(mine[b], lane);
    }
  }
  for (int c = 0; c < n_chunks; ++c) {
    int t[4];
    float f[4][LB];
    chunk_ids(row, c, lane, rs, vec4, n_tris, t);
    factors(t, absorb, nb, f);
    float pre[4][LB], suf[4][LB];
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const float p = ((f[0][b] * f[1][b]) * f[2][b]) * f[3][b];
      const float lo = scan_below(p, lane) * __shfl_sync(kFull, below_c[b], c);
      const float hi = scan_above(p, lane) * __shfl_sync(kFull, above_c[b], c);
      pre[0][b] = lo;
      pre[1][b] = lo * f[0][b];
      pre[2][b] = pre[1][b] * f[1][b];
      pre[3][b] = pre[2][b] * f[2][b];
      suf[3][b] = hi;
      suf[2][b] = hi * f[3][b];
      suf[1][b] = suf[2][b] * f[2][b];
      suf[0][b] = suf[1][b] * f[1][b];
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!__any_sync(kFull, t[s] >= 0)) continue;
      float x[LB];
#pragma unroll
      for (int b = 0; b < LB; ++b) x[b] = -(G[b] * pre[s][b]) * suf[s][b];
      const unsigned peers = __match_any_sync(kFull, t[s]);
      reduce_peers(peers, x, lane);
      if (t[s] >= 0 && lane == __ffs(peers) - 1)
        add_row<LB, kShared>(acc, grad, t[s], nb, rows4, x);
    }
  }
}

// The pose backward's extra operands: d loss / d ev_bin [N], the forward's
// ev_w [N, nb] and tan [N, 6], and the emitter's gradient [3].
struct Pose {
  const float* g_bin;
  const float* ev_w;
  const float* tan;
  float* grad_e;
};

// The backward of a block; with ``kPose`` each thread also sums its rays'
// emitter gradient, and ``grad`` null skips the table's gradient.
template <int LB, bool kShared, bool kPose>
__device__ __forceinline__ void replay_bwd_block(
    const int* __restrict__ ids, long long n, int k_steps, bool vec4,
    const int* __restrict__ recv, const float* __restrict__ chord,
    const float* __restrict__ g, const float* __restrict__ absorb,
    int n_tris, int nb, bool rows4, float e0, float* __restrict__ grad,
    const Pose& pose) {
  extern __shared__ float acc[];
  const int entries = n_tris * nb;
  if (kShared) {
    for (int j = threadIdx.x; j < entries; j += kBwdThreads) acc[j] = 0.0f;
    __syncthreads();
  }
  const bool table = !kPose || grad != nullptr;
  float ge[3] = {0.0f, 0.0f, 0.0f};
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kBwdThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kBwdThreads) >> 5;
  for (long long base = warp * 32; base < n; base += n_warps * 32) {
    const long long i = base + lane;
    const int r_l = i < n ? recv[i] : -1;
    const float ch_l = i < n ? chord[i] : 0.0f;
    if constexpr (kPose) {
      if (r_l >= 0 && r_l < k_steps && ch_l != 0.0f) {
        float ws = 0.0f;
#pragma unroll
        for (int b = 0; b < LB; ++b)
          if (b < nb)
            ws = ws + __ldg(g + i * nb + b) * __ldg(pose.ev_w + i * nb + b);
        const float energy = ws / ch_l;
        const float gb = __ldg(pose.g_bin + i);
        const float* t = pose.tan + 6 * i;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          ge[a] = ge[a] + (gb * __ldg(t + a) + energy * __ldg(t + 3 + a));
      }
    }
    if (!table) continue;
    unsigned todo =
        __ballot_sync(kFull, r_l > 0 && r_l < k_steps && ch_l != 0.0f);
    while (todo) {
      const int q = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int rs = __shfl_sync(kFull, r_l, q);
      const float ch = __shfl_sync(kFull, ch_l, q);
      const long long ray = base + q;
      float G[LB];
#pragma unroll
      for (int b = 0; b < LB; ++b)
        G[b] = b < nb ? (__ldg(g + ray * nb + b) * ch) * e0 : 0.0f;
      ray_gradient<LB, kShared>(ids + ray * k_steps, rs, vec4, G, absorb,
                                n_tris, nb, rows4, acc, grad, lane);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < entries; j += kBwdThreads) {
      const float v = acc[j];
      if (v != 0.0f) atomicAdd(grad + j, v);
    }
  }
  if constexpr (kPose) {
    __shared__ float block_ge[3];
    if (threadIdx.x < 3) block_ge[threadIdx.x] = 0.0f;
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ge[a] += __shfl_xor_sync(kFull, ge[a], off);
      if (lane == 0) atomicAdd(block_ge + a, ge[a]);
    }
    __syncthreads();
    if (threadIdx.x < 3) atomicAdd(pose.grad_e + threadIdx.x,
                                   block_ge[threadIdx.x]);
  }
}

template <int LB, bool kShared>
__global__ void __launch_bounds__(kBwdThreads)
replay_bwd_kernel(const int* __restrict__ ids, long long n, int k_steps,
                  bool vec4, const int* __restrict__ recv,
                  const float* __restrict__ chord,
                  const float* __restrict__ g,
                  const float* __restrict__ absorb, int n_tris, int nb,
                  bool rows4, float e0, float* __restrict__ grad) {
  replay_bwd_block<LB, kShared, false>(ids, n, k_steps, vec4, recv, chord, g,
                                       absorb, n_tris, nb, rows4, e0, grad,
                                       Pose{});
}

template <int LB, bool kShared>
__global__ void __launch_bounds__(kBwdThreads)
replay_pose_bwd_kernel(const int* __restrict__ ids, long long n, int k_steps,
                       bool vec4, const int* __restrict__ recv,
                       const float* __restrict__ chord,
                       const float* __restrict__ g,
                       const float* __restrict__ absorb, int n_tris, int nb,
                       bool rows4, float e0, float* __restrict__ grad,
                       Pose pose) {
  replay_bwd_block<LB, kShared, true>(ids, n, k_steps, vec4, recv, chord, g,
                                      absorb, n_tris, nb, rows4, e0, grad,
                                      pose);
}

template <int LB, bool kPose>
int launch_fwd(const int* ids, long long n, int k_steps, bool vec4,
               const int* recv, const float* dirs, const float* scal,
               const float* plane_n, const float* plane_d,
               const float* normal, const float* absorb, int nb,
               const Consts& c, float* ev_bin, float* ev_w, int* ev_ear,
               float* chord, float* tan, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kFwdThreads - 1) / kFwdThreads);
  if constexpr (kPose)
    replay_pose_kernel<LB><<<blocks, kFwdThreads, 0, s>>>(
        ids, n, k_steps, vec4, recv, dirs, scal, plane_n, plane_d, normal,
        absorb, nb, c, ev_bin, ev_w, ev_ear, chord, tan);
  else
    replay_kernel<LB><<<blocks, kFwdThreads, 0, s>>>(
        ids, n, k_steps, vec4, recv, dirs, scal, plane_n, plane_d, normal,
        absorb, nb, c, ev_bin, ev_w, ev_ear, chord);
  return (int)cudaGetLastError();
}

// A backward kernel on as many blocks as stay resident, fewer where the
// rays do not fill them (each shared-memory block zeroes and flushes the
// whole table).
template <typename Kernel, typename... Args>
int launch_resident(Kernel kernel, long long n, size_t smem, int sms,
                    cudaStream_t s, Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 47 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBwdThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + kBwdThreads - 1) / kBwdThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(want < resident ? want : resident), kBwdThreads, smem,
           s>>>(args...);
  return (int)cudaGetLastError();
}

template <int LB, bool kShared, bool kPose>
int launch_bwd(const int* ids, long long n, int k_steps, bool vec4,
               const int* recv, const float* chord, const float* g,
               const float* absorb, int n_tris, int nb, bool rows4,
               float e0, float* grad, const Pose& pose, size_t smem, int sms,
               cudaStream_t s) {
  if constexpr (kPose)
    return launch_resident(replay_pose_bwd_kernel<LB, kShared>, n, smem, sms,
                           s, ids, n, k_steps, vec4, recv, chord, g, absorb,
                           n_tris, nb, rows4, e0, grad, pose);
  else
    return launch_resident(replay_bwd_kernel<LB, kShared>, n, smem, sms, s,
                           ids, n, k_steps, vec4, recv, chord, g, absorb,
                           n_tris, nb, rows4, e0, grad);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

// ``tan`` null: the absorption kernel; else the pose kernel, which writes
// each deposit's 6 tangents there.
extern "C" int ar2_replay(const int* ids, long long n, int k_steps,
                          const int* recv, const float* dirs,
                          const float* scal, const float* plane_n,
                          const float* plane_d, const float* normal,
                          const float* absorb, int n_tris, int n_bands,
                          float e0, float bin_rate, float eps, float t_min,
                          float r2, float* ev_bin, float* ev_w, int* ev_ear,
                          float* chord, float* tan, void* stream) {
  if (n < 0 || k_steps < 1 || n_tris < 1 || n_bands < 1 || n_bands > 8)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const bool vec4 = k_steps % 4 == 0 && aligned16(ids);
  const Consts c{e0, bin_rate, eps, t_min, r2, n_tris};
  cudaStream_t s = (cudaStream_t)stream;
#define AR2_REPLAY(LB)                                                       \
  (tan != nullptr                                                            \
       ? launch_fwd<LB, true>(ids, n, k_steps, vec4, recv, dirs, scal,       \
                              plane_n, plane_d, normal, absorb, n_bands, c,  \
                              ev_bin, ev_w, ev_ear, chord, tan, s)           \
       : launch_fwd<LB, false>(ids, n, k_steps, vec4, recv, dirs, scal,      \
                               plane_n, plane_d, normal, absorb, n_bands, c, \
                               ev_bin, ev_w, ev_ear, chord, nullptr, s))
  if (n_bands == 1) return AR2_REPLAY(1);
  if (n_bands <= 4) return AR2_REPLAY(4);
  return AR2_REPLAY(8);
#undef AR2_REPLAY
}

// ``tan`` null: the absorption kernel's backward into ``grad``; else the
// pose kernel's, which also sums the emitter's gradient into ``grad_e``
// [3] from ``g_bin``, ``ev_w`` and ``tan``, and skips the table where
// ``grad`` is null.
extern "C" int ar2_replay_bwd(const int* ids, long long n, int k_steps,
                              const int* recv, const float* chord,
                              const float* g, const float* absorb,
                              int n_tris, int n_bands, float e0,
                              float* grad, const float* g_bin,
                              const float* ev_w, const float* tan,
                              float* grad_e, void* stream) {
  const bool pose = tan != nullptr;
  if (n < 0 || k_steps < 1 || k_steps > kChunk * kMaxChunks || n_tris < 1
      || n_bands < 1 || n_bands > 8 || (!pose && grad == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t entries = (size_t)n_tris * n_bands;
  cudaError_t err = cudaSuccess;
  if (pose) err = cudaMemsetAsync(grad_e, 0, 3 * sizeof(float), s);
  if (err == cudaSuccess && grad != nullptr)
    err = cudaMemsetAsync(grad, 0, entries * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  int device = 0, sms = 0, smem_max = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = k_steps % 4 == 0 && aligned16(ids);
  const size_t smem = entries * sizeof(float);
  // The pose kernel's block sums of the emitter's gradient take 3 floats of
  // static shared memory beside the table.
  const bool shared =
      grad != nullptr
      && smem + (pose ? 3 * sizeof(float) : 0) <= (size_t)smem_max;
  // A 4- or 8-band row in device memory takes float4 reductions when
  // aligned, any other row scalar atomics.
  const bool rows4 = grad != nullptr && aligned16(grad)
                     && (n_bands == 4 || n_bands == 8);
  const Pose p{g_bin, ev_w, tan, grad_e};
#define AR2_REPLAY_BWD(LB, POSE)                                              \
  (shared ? launch_bwd<LB, true, POSE>(ids, n, k_steps, vec4, recv, chord, g, \
                                       absorb, n_tris, n_bands, rows4, e0,    \
                                       grad, p, smem, sms, s)                 \
          : launch_bwd<LB, false, POSE>(ids, n, k_steps, vec4, recv, chord,   \
                                        g, absorb, n_tris, n_bands, rows4,    \
                                        e0, grad, p, 0, sms, s))
  if (n_bands == 1)
    return pose ? AR2_REPLAY_BWD(1, true) : AR2_REPLAY_BWD(1, false);
  if (n_bands <= 4)
    return pose ? AR2_REPLAY_BWD(4, true) : AR2_REPLAY_BWD(4, false);
  return pose ? AR2_REPLAY_BWD(8, true) : AR2_REPLAY_BWD(8, false);
#undef AR2_REPLAY_BWD
}
