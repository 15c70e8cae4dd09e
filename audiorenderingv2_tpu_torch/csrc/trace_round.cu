// K1: advance every ray by up to `budget` bounces over the triangle rows.
//
// Replaces the rows branch of the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2
// (launched by trace_round_v2; `n_blocks > 0`, with tri16 and the shared
// receiver/bounce tail). Same physics, same state columns, same results:
// per bounce, the nearest Moller-Trumbore hit over the triangle rows (ties
// to the lowest index), the analytic receiver sphere tested first, the
// event (arrival bin, energy * chord, ear), then a specular reflection,
// per-band absorption and a 1e-3 offset. LTRI and RECVD are written as the
// TPU kernel writes them.
//
// Design. The TPU kernel advances 128-ray tiles in lockstep. Here one
// thread owns one ray and loops over its own bounces, leaving as soon as the
// ray is done. The state stays in the port's [ncols, N] column layout, so
// neighbouring threads read neighbouring addresses, and lives in registers
// for the whole round. What bounds it on Hopper is FP32 throughput in the
// intersection loop (about 40 operations per ray and triangle; the state is
// read and written once per round), and divergence: a warp runs as long as
// its longest ray, which the alive-first partition between rounds
// (ops/raytrace_cuda.py) limits. Triangle rows are staged through shared
// memory in chunks of kChunk rows (48 KiB), so any triangle count works;
// a scene that fits one chunk (every scene of the export path) is loaded
// once per block and each thread then runs free of barriers. A larger scene
// runs block-synchronously: all threads of a block step through the chunks
// of every bounce together.
//
// Arithmetic order follows the plain PyTorch version (and the TPU kernel)
// operation by operation; the library is built with -fmad=false so no
// multiply-add pair is contracted into an FMA that the plain version does
// not do.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;  // triangle rows per shared-memory chunk
constexpr int kNR = 24;      // floats per triangle row
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

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int n_floats) {
  for (int k = threadIdx.x; k < n_floats; k += blockDim.x) dst[k] = src[k];
}

template <int LB>
__global__ void __launch_bounds__(kThreads)
trace_round_kernel(float* __restrict__ st, long long n,
                   const float* __restrict__ tris, int n_tris,
                   const float* __restrict__ scal, int n_bands, int budget,
                   int max_bounces) {
  extern __shared__ float s_rows[];
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool have_ray = ray < n;
  const bool one_chunk = n_tris <= kChunk;
  if (one_chunk) {
    load_rows(s_rows, tris, n_tris * kNR);
    __syncthreads();
  }

  const float rcx = scal[S_RCX], rcy = scal[S_RCY], rcz = scal[S_RCZ];
  const float siny = scal[S_SINY], cosy = scal[S_COSY];
  const float ethr = scal[S_ETHR], dthr = scal[S_DTHR];
  const float binrate = scal[S_BINRATE], r2 = scal[S_R2];
  const float fmax_b = (float)max_bounces;
  const float inf = CUDART_INF_F;

  float px = 0.f, py = 0.f, pz = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  float dist = 0.f, depth = 0.f, done = 1.f, evb = 0.f, eve = 0.f;
  float recvd = 0.f, ltri = 0.f;  // LTRI restarts at 0 every round
  float en[LB], ew[LB];
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

  for (int i = 0; i < budget; ++i) {
    const bool running = have_ray && done == 0.f;
    if (one_chunk) {
      if (!running) break;
    } else if (!__syncthreads_or(running)) {
      break;
    }
    float e_max = en[0];
#pragma unroll
    for (int b = 1; b < LB; ++b)
      if (b < n_bands) e_max = fmaxf(e_max, en[b]);
    const bool can_continue =
        dist < dthr && e_max > ethr && depth < fmax_b;
    const bool alive = running && can_continue;

    // ---- nearest triangle ----
    float best_t = inf;
    int best_i = -1;
    for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
      const int rows = min(kChunk, n_tris - c0);
      if (!one_chunk) {
        __syncthreads();
        load_rows(s_rows, tris + (long long)c0 * kNR, rows * kNR);
        __syncthreads();
      }
      if (!alive) continue;
      for (int t = 0; t < rows; ++t) {
        const float* r = s_rows + t * kNR;
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
        if (ok && tt < best_t) {  // strict: ties keep the lower index
          best_t = tt;
          best_i = c0 + t;
        }
      }
    }

    // ---- receiver sphere, tested before the surface ----
    const float ocx = px - rcx, ocy = py - rcy, ocz = pz - rcz;
    const float bq = ocx * vx + ocy * vy + ocz * vz;
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
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
      const float hx = px + t_sph * vx - rcx;
      const float hz = pz + t_sph * vz - rcz;
      const float local_z = -siny * hx + cosy * hz;
      evb = (dist + t_sph) * binrate;
#pragma unroll
      for (int b = 0; b < LB; ++b) ew[b] = en[b] * chord;
      eve = local_z >= 0.f ? 1.f : 0.f;
      recvd = depth;  // depth before any increment
    }
    if (surface) {
      const float* r = tris + (long long)best_i * kNR;
      const float nx = r[R_NX], ny = r[R_NY], nz = r[R_NZ];
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
        if (b < n_bands) en[b] = en[b] * (1.0f - r[R_ABS + b]);
      ltri = (float)best_i + 1.0f;
      depth = depth + 1.0f;
    }
    if (running && (receiver || miss || !can_continue)) done = 1.f;
  }

  if (!have_ray) return;
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

template <int LB>
int launch(float* state, long long n, int ncols, const float* tris,
           int n_tris, const float* scal, int n_bands, int budget,
           int max_bounces, cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const size_t smem =
      sizeof(float) * kNR * (size_t)(n_tris < kChunk ? n_tris : kChunk);
  trace_round_kernel<LB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      state, n, tris, n_tris, scal, n_bands, budget, max_bounces);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ar2_trace_round(float* state, long long n, int ncols,
                               const float* tris, int n_tris,
                               const float* scal, int n_bands,
                               int layout_bands, int budget, int max_bounces,
                               void* stream) {
  if (n <= 0 || n_tris < 0 || n_bands < 1 || budget < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout_bands) {
    case 1:
      return launch<1>(state, n, ncols, tris, n_tris, scal, n_bands, budget,
                       max_bounces, s);
    case 4:
      return launch<4>(state, n, ncols, tris, n_tris, scal, n_bands, budget,
                       max_bounces, s);
    case 8:
      return launch<8>(state, n, ncols, tris, n_tris, scal, n_bands, budget,
                       max_bounces, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
