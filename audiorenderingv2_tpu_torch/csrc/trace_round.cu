// K1: advance every ray by up to `budget` bounces over the triangle rows;
// and K7, the version-1 round: the same kernels over the version-1 layouts.
//
// K1 replaces the rows branch of the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2
// (launched by trace_round_v2; `n_blocks > 0`, with tri16 and the shared
// receiver/bounce tail). Same physics, same state columns, same results:
// per bounce, the nearest Moller-Trumbore hit over the triangle rows (ties
// to the lowest index), then the tail of trace_common.cuh.
//
// K7 replaces the TPU kernel
// audiorenderingv2_tpu/ops/raytrace_pallas.py:_trace_round_kernel (launched
// by trace_round): K1's physics over a row-major ray state [N, 16] (one
// 64-byte row a ray) and the untrimmed triangle table [17, T] (T a multiple
// of 128: the quantities of K1's rows as table rows, then the absorption at
// row 15 and the valid flag at row 16), one band. Columns 13-15 (RAYID,
// LTRI, RECVD) are stored as zeros: version 1 records no topology. K7 is
// not a kernel of its own: the kernels below are templates on a layout of
// the state and the triangles (ColumnsRows for K1, RowsTable for K7), and
// K7 is their second instantiation, so it equals K1 bit for bit in columns
// 0-12.
//
// Design. The TPU kernels advance 128-ray tiles in lockstep. Here one
// thread runs one ray at a time through its own bounces, the state in
// registers while the ray runs. What bounds it on Hopper is the issue of
// the intersection's instructions (about 40 FP32 operations a ray and
// triangle, built without FMA contraction, plus the IEEE division and the
// compares), and divergence: a warp that runs its 32 rays side by side runs
// as long as its longest one.
//
// A scene of at most kChunk rows (every scene of K1's rows route, and a
// version-1 table of at most kChunk columns) runs trace_rows_kernel. Each
// block finds the last row whose VAL is set (one pass over the valid
// flags), then stages the rows up to it into shared memory, zero rows
// padding them to a multiple of kUnroll (K7 transposes its table into K1's
// row layout here, R_VAL from table row 16 and R_ABS from row 15), and the
// search stops there: a row with VAL 0 never hits, so leaving the later
// ones out changes no result (a 12-triangle room in K7's 128 columns tests
// 12). A row is read as four float4 broadcasts, kUnroll rows unrolled
// (Ray::intersect_f4, the test K2 and K5 use), and the tail reads the
// bounced-off triangle's normal and absorptions from the staged rows. Rays
// come to a warp in groups of consecutive rays: warp w of W takes groups w,
// w + W, w + 2W, ..., and a lane whose ray ends (done, or its budget spent)
// stores it and takes the warp's next ray (RayHandout, trace_common.cuh).
// A round of at most kPersistBudget bounces gets a warp per 32 rays, one
// group each, so a lane that ends early idles, as one ray a thread would.
// A longer round runs on a persistent grid (the blocks that stay resident)
// with groups of 8 rays (one 32-byte sector a column; in K7's rows, 512
// contiguous bytes), so that lanes stay busy until the warp's share runs
// out instead of waiting on the warp's longest ray: in the box render's
// 68-bounce round one ray a thread keeps 57% of the lanes busy. In short
// rounds, where few lanes idle, the refills' scattered loads and the uneven
// shares cost more than they save. Each ray still runs its own bounces with
// the same arithmetic, so its result does not change. A ray that is done on
// entry only gets its round-start writes: K1 clears LTRI, K7 zeroes columns
// 13-15.
//
// A larger scene (the baseline of K1 over every row of a clustered scene;
// a version-1 table of more than kChunk columns, which version 1 never
// clusters) runs trace_chunks_kernel: one ray a thread, the rows staged
// through shared memory in chunks of kChunk (48 KiB), all threads of a
// block stepping through the chunks of every bounce together.
//
// Poses (K1-pose: the same TPU kernel launched with `tiles_per_pose`,
// raytrace_pallas_v2.py:887-904, where tile i reads scalar row
// i // tiles_per_pose). `scal` is [P, 16] and the state is pose-major: rays
// [p * rays_per_pose, (p + 1) * rays_per_pose) belong to pose p, and a ray
// reads the scalar row of its pose. One pose with rays_per_pose = n is the
// single-pose launch, unchanged; K7 has one pose.

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

// K1's layout: the state in columns [ncols, N] (column c of ray i at
// st[c * n + i]), the triangles in rows [n_tris, kNR].
template <int LB>
struct ColumnsRows {
  static constexpr int kBands = LB;
  float* st;
  long long n;
  const float* tris;
  int n_tris;
  int n_bands;

  // The last of this thread's rows in [c0, c0 + rows) with VAL set, -1 if
  // none (relative to c0).
  __device__ int last_valid(int c0, int rows) const {
    int last = -1;
    for (int t = threadIdx.x; t < rows; t += blockDim.x)
      if (tris[(long long)(c0 + t) * kNR + R_VAL] > 0.f) last = t;
    return last;
  }
  // Rows [c0, c0 + rows) into s, then zero rows up to `padded`.
  __device__ void stage(float* s, int c0, int rows, int padded) const {
    const float* src = tris + (long long)c0 * kNR;
    for (int k = threadIdx.x; k < padded * kNR; k += blockDim.x)
      s[k] = k < rows * kNR ? src[k] : 0.f;
  }
  __device__ RowAttrs attrs() const { return RowAttrs{tris}; }

  __device__ void load(Ray<LB>& r, long long ray, bool have_ray) const {
    r.load(st, n, ray, have_ray, n_bands);
  }
  __device__ void store(const Ray<LB>& r, long long ray) const {
    r.store(st, n, ray, n_bands);
  }
  // Load `ray` into r and return true, or, for a ray done on entry, clear
  // its LTRI and return false.
  __device__ bool take(Ray<LB>& r, long long ray) const {
    return r.take(st, n, ray, n_bands);
  }
};

// K7's layout: the state in rows [N, 16], the triangles in the columns of
// the table [17, n_tris].
constexpr int kTableAbs = 15;  // absorption row; the valid flag is row 16
constexpr int kTableVal = 16;
constexpr int kRowFloats = 16;  // floats a ray row

// The bounced-off triangle's attributes in the [17, T] table.
struct TableAttrs {
  const float* tris;
  int n_tris;
  __device__ float normal(int tri, int axis) const {
    return tris[(long long)(R_NX + axis) * n_tris + tri];
  }
  __device__ float absorption(int tri, int) const {
    return tris[(long long)kTableAbs * n_tris + tri];
  }
};

struct RowsTable {
  static constexpr int kBands = 1;
  static constexpr int n_bands = 1;
  float* st;
  long long n;
  const float* tris;
  int n_tris;

  __device__ int last_valid(int c0, int cols) const {
    int last = -1;
    for (int t = threadIdx.x; t < cols; t += blockDim.x)
      if (tris[(long long)kTableVal * n_tris + c0 + t] > 0.f) last = t;
    return last;
  }
  // Columns [c0, c0 + cols) as K1's rows into s (table row q to field q,
  // but R_VAL from row 16 and R_ABS from row 15), then zero rows up to
  // `padded`. A thread a column: its 17 loads are coalesced across the
  // warp, and its row goes out as four float4 stores and one scalar (a
  // float4 store at a 96-byte stride meets one other lane on its banks,
  // where scalar stores would meet seven). Fields 17-23 (further bands)
  // are not written: one band reads none of them.
  __device__ void stage(float* s, int c0, int cols, int padded) const {
    for (int t = threadIdx.x; t < padded; t += blockDim.x) {
      const bool in = t < cols;
      const float* c = tris + c0 + t;
      const auto at = [&](int q) {
        return in ? c[(long long)q * n_tris] : 0.f;
      };
      float4* d = reinterpret_cast<float4*>(s + t * kNR);
      d[0] = make_float4(at(R_PNX), at(R_PNY), at(R_PNZ), at(R_PD));
      d[1] = make_float4(at(R_AUX), at(R_AUY), at(R_AUZ), at(R_AUO));
      d[2] = make_float4(at(R_AVX), at(R_AVY), at(R_AVZ), at(R_AVO));
      d[3] = make_float4(at(R_NX), at(R_NY), at(R_NZ), at(kTableVal));
      s[t * kNR + R_ABS] = at(kTableAbs);
    }
  }
  __device__ TableAttrs attrs() const { return TableAttrs{tris, n_tris}; }

  __device__ float4* row(long long ray) const {
    return reinterpret_cast<float4*>(st + ray * kRowFloats);
  }
  __device__ void load(Ray<1>& r, long long ray, bool have_ray) const {
    if (!have_ray) {
      r.en[0] = r.ew[0] = 0.f;
      return;
    }
    const float4* p = row(ray);
    const float4 a = p[0], b = p[1], c = p[2], d = p[3];
    r.px = a.x; r.py = a.y; r.pz = a.z; r.vx = a.w;
    r.vy = b.x; r.vz = b.y; r.dist = b.z; r.en[0] = b.w;
    r.depth = c.x; r.done = c.y; r.evb = c.z; r.ew[0] = c.w;
    r.eve = d.x;
  }
  __device__ void store(const Ray<1>& r, long long ray) const {
    float4* p = row(ray);
    p[0] = make_float4(r.px, r.py, r.pz, r.vx);
    p[1] = make_float4(r.vy, r.vz, r.dist, r.en[0]);
    p[2] = make_float4(r.depth, r.done, r.evb, r.ew[0]);
    p[3] = make_float4(r.eve, 0.f, 0.f, 0.f);
  }
  // Load `ray` into r and return true, or, for a ray done on entry, zero
  // its columns 13-15 and return false.
  __device__ bool take(Ray<1>& r, long long ray) const {
    r = Ray<1>();
    load(r, ray, true);
    if (r.done == 0.f) return true;
    row(ray)[3] = make_float4(r.eve, 0.f, 0.f, 0.f);
    return false;
  }
};

template <class L>
__global__ void __launch_bounds__(kThreads)
trace_rows_kernel(L lay, const float* __restrict__ scal,
                  long long rays_per_pose, int budget, int max_bounces,
                  int group_log2) {
  constexpr int LB = L::kBands;
  extern __shared__ __align__(16) float s_rows[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_last = -1;
  __syncthreads();
  const int last = lay.last_valid(0, lay.n_tris);
  if (last >= 0) atomicMax(&s_last, last);
  __syncthreads();
  const int n_test = padded_rows(s_last + 1);
  lay.stage(s_rows, 0, min(n_test, lay.n_tris), n_test);
  __syncthreads();
  const RowAttrs staged{s_rows};

  // The warp's rays come in groups of 2^group_log2 consecutive rays:
  // groups w, w + W, w + 2W, ... of W warps.
  RayHandout hand(lay.n, ((long long)blockIdx.x * kThreads + tid) >> 5,
                  (long long)gridDim.x * kWarps, group_log2, lane);
  const float fmax_b = (float)max_bounces;
  long long ray = -1;   // this lane's ray; -1 while the lane is idle
  int bounces = 0;      // bounces of that ray in this round
  Ray<LB> r;
  Scalars sc(scal);

  while (true) {
    // Idle lanes take the warp's next rays; a ray that is done on entry
    // only gets its round-start writes, and its lane takes the next one.
    hand.refill(ray, [&](long long cand) {
      if (!lay.take(r, cand)) return false;
      bounces = 0;
      sc = Scalars(scal + (cand / rays_per_pose) * kNScal);
      return true;
    });
    if (!__any_sync(kFull, ray >= 0)) break;
    if (ray >= 0) {
      const bool can_cont = r.can_continue(sc, lay.n_bands, fmax_b);
      float best_t = CUDART_INF_F;
      int best_i = -1;
      if (can_cont)
        r.template intersect_f4<kUnroll>(s_rows, n_test, 0, best_t, best_i);
      r.finish_bounce(true, can_cont, best_t, best_i, staged, sc,
                      lay.n_bands);
      if (r.done != 0.f || ++bounces == budget) {
        lay.store(r, ray);
        ray = -1;
      }
    }
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads)
trace_chunks_kernel(L lay, const float* __restrict__ scal,
                    long long rays_per_pose, int budget, int max_bounces) {
  extern __shared__ __align__(16) float s_rows[];
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool have_ray = ray < lay.n;
  const long long pose = ((long long)blockIdx.x * blockDim.x) / rays_per_pose;
  const Scalars sc(scal + pose * kNScal);
  const float fmax_b = (float)max_bounces;
  Ray<L::kBands> r;
  lay.load(r, ray, have_ray);

  for (int i = 0; i < budget; ++i) {
    const bool running = have_ray && r.done == 0.f;
    if (!__syncthreads_or(running)) break;
    const bool can_cont = r.can_continue(sc, lay.n_bands, fmax_b);
    const bool alive = running && can_cont;
    float best_t = CUDART_INF_F;
    int best_i = -1;
    for (int c0 = 0; c0 < lay.n_tris; c0 += kChunk) {
      const int rows = min(kChunk, lay.n_tris - c0);
      __syncthreads();
      lay.stage(s_rows, c0, rows, rows);
      __syncthreads();
      if (alive) r.intersect(s_rows, rows, c0, best_t, best_i);
    }
    r.finish_bounce(running, can_cont, best_t, best_i, lay.attrs(), sc,
                    lay.n_bands);
  }
  if (have_ray) lay.store(r, ray);
}

template <class L>
int launch(const L& lay, const float* scal, long long rays_per_pose,
           int budget, int max_bounces, cudaStream_t stream) {
  const long long n = lay.n;
  if (lay.n_tris > kChunk) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    trace_chunks_kernel<L><<<(unsigned)blocks, kThreads,
                             sizeof(float) * kNR * kChunk, stream>>>(
        lay, scal, rays_per_pose, budget, max_bounces);
    return (int)cudaGetLastError();
  }
  // The rows, padded, beside the static last-row index: over the default
  // 48 KiB a block at kChunk rows.
  const size_t smem = sizeof(float) * kNR * (size_t)padded_rows(lay.n_tris);
  cudaError_t err = cudaSuccess;
  if (smem > 47 * 1024)
    err = cudaFuncSetAttribute(trace_rows_kernel<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trace_rows_kernel<L>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // One warp per 32 consecutive rays, or as many blocks as stay resident,
  // each warp taking groups of 8 rays (one 32-byte sector a column).
  const long long want = (n + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const bool persist = budget > kPersistBudget && resident < want;
  trace_rows_kernel<L><<<(unsigned)(persist ? resident : want), kThreads,
                         smem, stream>>>(lay, scal, rays_per_pose, budget,
                                         max_bounces, persist ? 3 : 5);
  return (int)cudaGetLastError();
}

template <int LB>
int launch_k1(float* state, long long n, int ncols, const float* tris,
              int n_tris, const float* scal, long long rays_per_pose,
              int n_bands, int budget, int max_bounces, cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  return launch(ColumnsRows<LB>{state, n, tris, n_tris, n_bands}, scal,
                rays_per_pose, budget, max_bounces, stream);
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
      return launch_k1<1>(state, n, ncols, tris, n_tris, scal, rays_per_pose,
                          n_bands, budget, max_bounces, s);
    case 4:
      return launch_k1<4>(state, n, ncols, tris, n_tris, scal, rays_per_pose,
                          n_bands, budget, max_bounces, s);
    case 8:
      return launch_k1<8>(state, n, ncols, tris, n_tris, scal, rays_per_pose,
                          n_bands, budget, max_bounces, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K7: the state [n, 16] row-major (16-byte aligned), the table [17, n_tris].
extern "C" int ar2_trace_round_v1(float* state, long long n,
                                  const float* tris, int n_tris,
                                  const float* scal, int budget,
                                  int max_bounces, void* stream) {
  if (n <= 0 || n_tris < 1 || budget < 1 ||
      (reinterpret_cast<size_t>(state) & 15))
    return (int)cudaErrorInvalidValue;
  return launch(RowsTable{state, n, tris, n_tris}, scal, n, budget,
                max_bounces, (cudaStream_t)stream);
}
