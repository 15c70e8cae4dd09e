// What K1 and K7 (trace_round.cu), K2 (trace_sched.cu), K5
// (trace_traverse.cu) and K6 (trace_group.cu) share: the state, scalar and
// triangle-row layouts, one ray's state in registers, the Moller-Trumbore
// search over triangle rows (read as 17 scalars, or as float4 with rows
// unrolled: K1, K2 and K5), the bounce tail, the hand-out of rays to the
// lanes of a warp (K1, K7 and K6), the ray-box slab test of the schedule
// (tile_schedule.cu) and K2's cull, and the bulk copies on mbarriers that
// K2 (a ring of them) and K5 stage cluster rows with.
//
// The tail is the TPU kernel's (audiorenderingv2_tpu/ops/
// raytrace_pallas_v2.py:_trace_round_kernel_v2, :692-747): the analytic
// receiver sphere tested before the surface, the event (arrival bin,
// energy * chord, ear), then a specular reflection, per-band absorption and
// a 1e-3 offset. LTRI and RECVD are written as the TPU kernel writes them.
//
// Arithmetic order follows the plain PyTorch version (ops/raytrace_cuda.py,
// _nearest_hit and _bounce) operation by operation; the library is built
// with -fmad=false so no multiply-add pair is contracted into an FMA that
// the plain version does not do.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace ar2 {

constexpr int kThreads = 128;  // rays per block; a tile of the clustered route
constexpr int kNR = 24;        // floats per triangle row
constexpr int kNScal = 16;     // floats per scalar row (one row per pose)
constexpr float kTMin = 1e-4f;
constexpr float kBaryEps = 1e-7f;
constexpr float kSafeDen = 1e-12f;
constexpr float kBounceEps = 1e-3f;

// Ray-state columns (raytrace_pallas.py:72-75); banded layouts append the
// extra energy and event-weight columns from 16 on.
enum { C_PX, C_PY, C_PZ, C_VX, C_VY, C_VZ, C_DIST, C_EN, C_DEPTH, C_DONE,
       C_EVB, C_EVW, C_EVE, C_RAYID, C_LTRI, C_RECVD };
// Scalar slots (raytrace_pallas.py:61-63).
enum { S_EMX, S_EMY, S_EMZ, S_RCX, S_RCY, S_RCZ, S_SINY, S_COSY, S_E0,
       S_ETHR, S_DTHR, S_BINRATE, S_R2 };
// Triangle-row columns (raytrace_pallas_v2.py:60-63).
enum { R_PNX, R_PNY, R_PNZ, R_PD, R_AUX, R_AUY, R_AUZ, R_AUO, R_AVX, R_AVY,
       R_AVZ, R_AVO, R_NX, R_NY, R_NZ, R_VAL, R_ABS };

template <int LB>
__host__ __device__ constexpr int state_ncols() {
  return 16 + ((2 * (LB - 1) + 7) / 8) * 8;
}

template <int LB>
__device__ __forceinline__ int en_col(int b) {
  return b == 0 ? C_EN : 16 + b - 1;
}

template <int LB>
__device__ __forceinline__ int evw_col(int b) {
  return b == 0 ? C_EVW : 16 + (LB - 1) + b - 1;
}

// Where the tail finds the normal and the absorptions of the triangle a ray
// bounced off: rows indexed by the triangle, in global memory (K2, K5 and
// K1's multi-chunk branch) or staged in shared memory (the one-chunk branch
// of K1 and K7). K6, and K7's multi-chunk branch, keep them in tables of
// their own layouts and bring their own.
struct RowAttrs {
  const float* tris;
  __device__ float normal(int tri, int axis) const {
    return tris[(long long)tri * kNR + R_NX + axis];
  }
  __device__ float absorption(int tri, int band) const {
    return tris[(long long)tri * kNR + R_ABS + band];
  }
};

// One pose's scalar row, read once per thread.
struct Scalars {
  float rcx, rcy, rcz, siny, cosy, ethr, dthr, binrate, r2;
  __device__ explicit Scalars(const float* s)
      : rcx(s[S_RCX]), rcy(s[S_RCY]), rcz(s[S_RCZ]), siny(s[S_SINY]),
        cosy(s[S_COSY]), ethr(s[S_ETHR]), dthr(s[S_DTHR]),
        binrate(s[S_BINRATE]), r2(s[S_R2]) {}
};

// One ray's state in registers for a round; column c of ray i lives at
// st[c * n + i], so neighbouring threads touch neighbouring addresses.
template <int LB>
struct Ray {
  float px = 0.f, py = 0.f, pz = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  float dist = 0.f, depth = 0.f, done = 1.f, evb = 0.f, eve = 0.f;
  float recvd = 0.f, ltri = 0.f;  // LTRI restarts at 0 every round
  float en[LB], ew[LB];

  __device__ void load(const float* st, long long n, long long ray,
                       bool have_ray, int n_bands) {
    if (have_ray) {
      const float* c = st + ray;
      px = c[C_PX * n]; py = c[C_PY * n]; pz = c[C_PZ * n];
      vx = c[C_VX * n]; vy = c[C_VY * n]; vz = c[C_VZ * n];
      dist = c[C_DIST * n]; depth = c[C_DEPTH * n]; done = c[C_DONE * n];
      evb = c[C_EVB * n]; eve = c[C_EVE * n]; recvd = c[C_RECVD * n];
    }
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const bool used = have_ray && b < n_bands;
      en[b] = used ? st[en_col<LB>(b) * n + ray] : 0.f;
      ew[b] = used ? st[evw_col<LB>(b) * n + ray] : 0.f;
    }
  }

  // Load `ray` and return true, or, for a ray done on entry, clear its LTRI
  // and return false (the round-start writes of K1's and K6's layout).
  __device__ bool take(float* st, long long n, long long ray, int n_bands) {
    if (st[C_DONE * n + ray] != 0.f) {
      st[C_LTRI * n + ray] = 0.f;
      return false;
    }
    *this = Ray<LB>();
    load(st, n, ray, true, n_bands);
    return true;
  }

  __device__ void store(float* st, long long n, long long ray,
                        int n_bands) const {
    float* c = st + ray;
    c[C_PX * n] = px; c[C_PY * n] = py; c[C_PZ * n] = pz;
    c[C_VX * n] = vx; c[C_VY * n] = vy; c[C_VZ * n] = vz;
    c[C_DIST * n] = dist; c[C_DEPTH * n] = depth; c[C_DONE * n] = done;
    c[C_EVB * n] = evb; c[C_EVE * n] = eve;
    c[C_LTRI * n] = ltri; c[C_RECVD * n] = recvd;
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      if (b < n_bands) {
        c[en_col<LB>(b) * n] = en[b];
        c[evw_col<LB>(b) * n] = ew[b];
      }
    }
  }

  __device__ bool can_continue(const Scalars& sc, int n_bands,
                               float fmax_b) const {
    float e_max = en[0];
#pragma unroll
    for (int b = 1; b < LB; ++b)
      if (b < n_bands) e_max = fmaxf(e_max, en[b]);
    return dist < sc.dthr && e_max > sc.ethr && depth < fmax_b;
  }

  // Nearest valid hit over `n_rows` rows at `rows` (global row index
  // `base` + t), folded into (best_t, best_i) with a strict `<`: ties keep
  // the lower index.
  __device__ __forceinline__ void intersect(const float* rows, int n_rows,
                                            int base, float& best_t,
                                            int& best_i) const {
    for (int t = 0; t < n_rows; ++t) {
      const float* r = rows + t * kNR;
      const float nd = vx * r[R_PNX] + vy * r[R_PNY] + vz * r[R_PNZ];
      const float no =
          px * r[R_PNX] + py * r[R_PNY] + pz * r[R_PNZ] + r[R_PD];
      const bool safe = fabsf(nd) > kSafeDen;
      const float tt = -no / (safe ? nd : 1.0f);
      const float ou =
          px * r[R_AUX] + py * r[R_AUY] + pz * r[R_AUZ] + r[R_AUO];
      const float du = vx * r[R_AUX] + vy * r[R_AUY] + vz * r[R_AUZ];
      const float u = ou + tt * du;
      const float ov =
          px * r[R_AVX] + py * r[R_AVY] + pz * r[R_AVZ] + r[R_AVO];
      const float dv = vx * r[R_AVX] + vy * r[R_AVY] + vz * r[R_AVZ];
      const float v = ov + tt * dv;
      const bool ok = safe && tt > kTMin && u >= -kBaryEps &&
                      v >= -kBaryEps && u + v <= 1.0f + kBaryEps &&
                      r[R_VAL] > 0.f;
      if (ok && tt < best_t) {
        best_t = tt;
        best_i = base + t;
      }
    }
  }

  // The same search with each row read as four float4 broadcasts (columns
  // 0-15; `rows` 16-byte aligned) instead of 17 scalars, U rows unrolled;
  // n_rows a multiple of U. The arithmetic is intersect's, operation for
  // operation, so the two give the same bits.
  template <int U>
  __device__ __forceinline__ void intersect_f4(const float* rows, int n_rows,
                                               int base, float& best_t,
                                               int& best_i) const {
    const float4* row4 = reinterpret_cast<const float4*>(rows);
    for (int t0 = 0; t0 < n_rows; t0 += U)
#pragma unroll
    for (int t = t0; t < t0 + U; ++t) {
      const float4 pl = row4[t * (kNR / 4)];      // R_PNX, R_PNY, R_PNZ, R_PD
      const float4 au = row4[t * (kNR / 4) + 1];  // R_AUX, R_AUY, R_AUZ, R_AUO
      const float4 av = row4[t * (kNR / 4) + 2];  // R_AVX, R_AVY, R_AVZ, R_AVO
      const float val = row4[t * (kNR / 4) + 3].w;  // R_VAL
      const float nd = vx * pl.x + vy * pl.y + vz * pl.z;
      const float no = px * pl.x + py * pl.y + pz * pl.z + pl.w;
      const bool safe = fabsf(nd) > kSafeDen;
      const float tt = -no / (safe ? nd : 1.0f);
      const float ou = px * au.x + py * au.y + pz * au.z + au.w;
      const float du = vx * au.x + vy * au.y + vz * au.z;
      const float u = ou + tt * du;
      const float ov = px * av.x + py * av.y + pz * av.z + av.w;
      const float dv = vx * av.x + vy * av.y + vz * av.z;
      const float v = ov + tt * dv;
      const bool ok = safe && tt > kTMin && u >= -kBaryEps &&
                      v >= -kBaryEps && u + v <= 1.0f + kBaryEps && val > 0.f;
      if (ok && tt < best_t) {
        best_t = tt;
        best_i = base + t;
      }
    }
  }

  // The rest of one bounce, given the nearest hit (best_t = inf on a
  // miss): receiver sphere first, then the surface. `tris` holds the rows
  // in global memory, indexed by best_i.
  __device__ __forceinline__ void finish_bounce(
      bool running, bool can_cont, float best_t, int best_i,
      const float* __restrict__ tris, const Scalars& sc, int n_bands) {
    finish_bounce(running, can_cont, best_t, best_i, RowAttrs{tris}, sc,
                  n_bands);
  }

  // The same with the bounced-off triangle's attributes read through
  // `attrs` (normal(tri, axis), absorption(tri, band)).
  template <class Attrs>
  __device__ __forceinline__ void finish_bounce(
      bool running, bool can_cont, float best_t, int best_i,
      const Attrs& attrs, const Scalars& sc, int n_bands) {
    const float inf = CUDART_INF_F;
    const bool alive = running && can_cont;
    const float ocx = px - sc.rcx, ocy = py - sc.rcy, ocz = pz - sc.rcz;
    const float bq = ocx * vx + ocy * vy + ocz * vz;
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - sc.r2;
    const float disc = bq * bq - cq;
    const bool sph_hit = disc > 0.f;
    const float sq = sqrtf(sph_hit ? disc : 0.f);
    const float t1 = -bq - sq;
    const float t2 = -bq + sq;
    const float t_sph = (sph_hit && t1 > kTMin)   ? t1
                        : (sph_hit && t2 > kTMin) ? t2
                                                  : inf;
    const float chord = t2 - t1;  // also from inside the sphere
    const bool receiver = alive && t_sph < best_t;
    const bool surface = alive && !receiver && best_t < inf;
    const bool miss = alive && !receiver && !surface;

    if (receiver) {
      const float hx = px + t_sph * vx - sc.rcx;
      const float hz = pz + t_sph * vz - sc.rcz;
      const float local_z = -sc.siny * hx + sc.cosy * hz;
      evb = (dist + t_sph) * sc.binrate;
#pragma unroll
      for (int b = 0; b < LB; ++b) ew[b] = en[b] * chord;
      eve = local_z >= 0.f ? 1.f : 0.f;
      recvd = depth;  // depth before any increment
    }
    if (surface) {
      const float nx = attrs.normal(best_i, 0);
      const float ny = attrs.normal(best_i, 1);
      const float nz = attrs.normal(best_i, 2);
      const float dn = vx * nx + vy * ny + vz * nz;
      const float rx = vx - 2.0f * dn * nx;
      const float ry = vy - 2.0f * dn * ny;
      const float rz = vz - 2.0f * dn * nz;
      px = px + best_t * vx + kBounceEps * rx;
      py = py + best_t * vy + kBounceEps * ry;
      pz = pz + best_t * vz + kBounceEps * rz;
      vx = rx;
      vy = ry;
      vz = rz;
      dist = dist + best_t;
#pragma unroll
      for (int b = 0; b < LB; ++b)
        if (b < n_bands)
          en[b] = en[b] * (1.0f - attrs.absorption(best_i, b));
      ltri = (float)best_i + 1.0f;
      depth = depth + 1.0f;
    }
    if (running && (receiver || miss || !can_cont)) done = 1.f;
  }
};

// How K1 (and K7) and K6 hand rays to a warp: warp w of W takes groups w,
// w + W, w + 2W, ... of 2^group_log2 consecutive rays, and a lane whose ray
// has ended takes the warp's next one. The state is warp-uniform; every
// lane of the warp calls refill.
constexpr unsigned kAllLanes = 0xffffffffu;

struct RayHandout {
  long long n, warp, n_warps, n_groups, group_mask;
  int group_log2;
  unsigned below;       // the lanes under this one
  long long taken = 0;  // rays this warp has handed out
  bool exhausted;

  __device__ RayHandout(long long n_rays, long long warp_id,
                        long long warps, int log2_group, int lane)
      : n(n_rays), warp(warp_id), n_warps(warps),
        n_groups(((n_rays - 1) >> log2_group) + 1),
        group_mask((1ll << log2_group) - 1), group_log2(log2_group),
        below((1u << lane) - 1u), exhausted(warp_id >= n_groups) {}

  // Idle lanes (ray < 0) take the warp's next rays, in order, until none
  // is idle or the warp's share is spent. take(cand) loads ray cand and
  // returns true, or, for a ray done on entry, makes its round-start
  // writes and returns false, and the lane takes the next one.
  template <class Take>
  __device__ __forceinline__ void refill(long long& ray, Take&& take) {
    while (!exhausted) {
      const unsigned need = __ballot_sync(kAllLanes, ray < 0);
      if (need == 0u) break;
      if (ray < 0) {
        const long long j = taken + __popc(need & below);
        const long long group = warp + (j >> group_log2) * n_warps;
        const long long cand = (group << group_log2) + (j & group_mask);
        if (group < n_groups && cand < n && take(cand)) ray = cand;
      }
      taken += __popc(need);
      exhausted = warp + (taken >> group_log2) * n_warps >= n_groups;
    }
  }
};

// The clustered route's exact ray-box slab test, which the schedule
// (tile_schedule.cu) and K2's per-warp cull both run, in the order of
// operations of the plain version (ops/schedule_cuda.py:slab_pass):
// 1 / v with |v| floored at 1e-20 (IEEE division), t = (lo - p) * inv,
// entry = max(t_near, 0), reached when t_far >= entry and the box's flag
// is set; `entry` is returned through its argument. A box is two float4:
// (lo x, lo y, lo z, hi x), (hi y, hi z, flag, 0).
constexpr float kEpsDir = 1e-20f;

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) > kEpsDir ? v : (v >= 0.f ? kEpsDir : -kEpsDir));
}

__device__ __forceinline__ bool box_reached(float4 a, float4 c, float px,
                                            float py, float pz, float ix,
                                            float iy, float iz,
                                            float& entry) {
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
  entry = fmaxf(tn, 0.f);
  return tf >= entry && c.z > 0.f;
}

// Bulk copies (K2's ring, K5): thread 0 copies a cluster's rows into a
// shared-memory stage with one cp.async.bulk that completes on the stage's
// "full" mbarrier; the k-th use of a stage waits on parity k & 1 of the
// stage's own count (in K2's ring of S stages, use k of the ring is use
// k / S of stage k % S).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Thread 0: copy `bytes` from `src` (global, 16-byte aligned) into `dst`
// (shared), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace ar2
