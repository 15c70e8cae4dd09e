// K3: sum event weights into IR bins, and K3-bwd, the gather that is its
// backward pass.
//
// Replaces the TPU kernel audiorenderingv2_tpu/ops/histogram_pallas.py
// (_hist_kernel, launched by _hist_pallas_raw), which scatters 128 events at
// a time through a one-hot matrix product into a histogram held in VMEM.
//
// Here each event is added atomically into a [n_bins, n_bands] float32
// accumulator in device memory, which the entry point zero-fills on the
// same stream first (cudaMemsetAsync: no separate fill launch from the
// host). What bounds it on Hopper: the event read (E * (4 + 4 * n_bands)
// bytes) and the atomics, which the L2 resolves; the stereo 2 s IR at
// 16 kHz is 64,000 bins (250 KiB), larger than the 227 KiB of shared
// memory a block may have, and at ~15 events a bin a private copy's flush
// would issue about as many atomics as the events, so the accumulator is
// not privatised. Events that are out of range or carry zero weight return
// before any atomic: padding rays, escaped rays and rays that never reach
// the receiver all leave such slots, and sending them to one sentinel
// address (as the TPU kernel does) would serialise their atomics on it.
// f32 atomics add in a run-dependent order, so sums agree with a
// sequential sum to a few ulp, not bit for bit; they flush subnormal
// values to zero (RED.F32.FTZ in the SASS), as PyTorch's index_add_ on
// the card does.
//
// The atomics are Hopper's vector reductions where a row allows them: a
// 4-band event is one 16-byte load of its weights and one
// `red.global.add.v4.f32` (atomicAdd on a float4, sm_90; REDG.E.ADD.F32x4
// in the SASS), an 8-band event two of each; at one band a thread takes 4
// events at a time, one 16-byte load of bins and one of weights, with
// scalar reductions. A warp's lanes take consecutive items, kQuadItems or
// kRowItems items a thread with every load issued before the first
// atomic. Rows that are not 16-byte aligned and other band counts take
// one event a thread with scalar loads and atomics. On an H100, device
// time at 1,000,064 events (benchmarks/torch_trace_ab.py, `hist` levers:
// this kernel against a copy with one lever undone), scalar atomics in
// place of the vector reductions took 4 bands from 0.0135 to 0.0418 ms and
// 8 from 0.0252 to 0.0802; one event a thread in place of the 4-event
// items at one band took the box render's own events from 0.0154 to
// 0.0198 ms and changed nothing on uniform bins (the atomics' rate sets
// that pace). Warp-aggregated adds (__match_any_sync, one atomic a
// distinct bin; benchmarks/torch_hist_init_probes.py) were 11-32% slower
// on every one-band input, the render's own events included.

// The hard-binning stage (core/tracer.py:_histogram_from_events_posed) is
// the second forward entry, ar2_histogram_binned, in one launch: it reads
// the tracer's events as they are (bin_f f32 [P, E], weights f32 [P, E,
// n_bands], ear int32 [P, E], 0 or 1), rounds each arrival time
// half to even (rintf, as torch.round), drops inactive (every band zero)
// and out-of-range events, and adds the weights at bin b of its ear of
// pose p: flat row (p * 2 + ear) * ir_length + b. Unless mono it also adds
// (1 - hrtf) * w at the other ear, at bin b + delay, or at b when that
// passes the IR's end (the reference's overflow fallback,
// devicePrograms.cu:124-168). The two-step PyTorch stage, which sums the
// same-ear deposits and derives the cross-ear ones by a shift of the
// finished histogram, gives the same sums up to the order of f32
// additions; it took about 27 launches. Poses run on the grid's y axis, so
// indices never leave 64 bits and no pose chunking is needed here.
//
// K3-bwd replaces the backward of the TPU version's custom VJP
// (histogram_pallas.py:124-143, an index_select on a zero-padded gradient):
// g_w[e, b] = g[bins[e], b], and 0 where bins[e] is out of range; the bins
// get no gradient. It is a pure gather with no atomics, so it equals its
// plain version bit for bit. The bytes it must move are the bins and g_w
// (E * (4 + 4 * n_bands)); what bounds it at one band is the gather: a
// warp's 32 reads of g touch about 32 cache lines, which the L1 (a 256 KB
// g) or the L2 (the posed histogram's 2 MB) serves a line at a time. On an
// H100 a one-event-a-thread kernel took 0.0220 ms at 4M events from
// 64,000 bins, the same kernel reading g contiguously 0.0167, and one that
// only reads the bins or only writes g_w 0.0118
// (benchmarks/torch_trace_ab.py, `bwd` phase). So at one band, where at
// least half of g fits a block's shared memory (the soft stereo IR's 64,000
// bins), each SM's one block of 1024 threads first copies g's first
// kStaged values into shared memory and gathers those from there, the rest
// through the L1; its threads take 4 events at a time as one 16-byte load
// of bins and one 16-byte store, kItems at a time with all loads issued
// before the gathers. That took the 64,000-bin case to 0.0168 ms, and made
// the 512,000-bin case slower (0.0697 against 0.0561: 11% staged), which
// therefore keeps one event a thread. At 4 and 8 bands the write of g_w
// sets the pace: one event is its row of g as float4s (a 16-byte gather
// and store each), kItems events a thread (0.0391 ms against 0.0606 at 4
// bands). Bins, g or g_w not 16-byte aligned (a view such as bins[1:]) and
// other band counts take one event a thread with scalar loads and stores.
// A warp's lanes take consecutive items, so that every load and store
// instruction of a warp covers contiguous bytes. Bins are read with
// streaming loads and g_w written with streaming stores: each is touched
// once, and g should stay in the caches.
//
// The wrappers (ops/histogram_cuda.py) allocate `out` and `g_w` and check
// shapes, types and devices; nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
// Items a thread of the forward takes at a time, its loads issued before
// its first atomic: 4 events an item at one band, one event an item at 4
// and 8 bands (benchmarks/torch_trace_ab.py, `hist` levers, on an H100: 1
// quad a thread within 2% of 2, 4 quads up to 5% slower; 4 banded events
// 3-5% slower than 1).
constexpr int kQuadItems = 2;
constexpr int kRowItems = 1;

__device__ __forceinline__ bool in_range(int b, int n_bins) {
  return b >= 0 && b < n_bins;
}

__device__ __forceinline__ bool any_nonzero(const float4& v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

__device__ __forceinline__ float4 scaled(const float4& v, float s) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

// One atomic for each non-zero weight.
__device__ __forceinline__ void add_scalar(float* dst, float w) {
  if (w != 0.0f) atomicAdd(dst, w);
}

// Scalar path: one event a thread, n_bands scalar loads and atomics.
__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(const int* __restrict__ bins,
                 const float* __restrict__ weights, long long n_events,
                 int n_bins, int n_bands, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_events) return;
  const int b = bins[e];
  if (!in_range(b, n_bins)) return;
  const float* w = weights + e * n_bands;
  float* dst = out + (long long)b * n_bands;
  for (int k = 0; k < n_bands; ++k) add_scalar(dst + k, w[k]);
}

// One band, 16-byte aligned: an item is 4 consecutive events (one int4 of
// bins, one float4 of weights); the last n_events % 4 events one a thread.
__global__ void __launch_bounds__(kHistThreads)
histogram_quad_kernel(const int* __restrict__ bins,
                      const float* __restrict__ weights, long long n_events,
                      int n_bins, float* __restrict__ out) {
  const long long n_quads = n_events >> 2;
  const int lane = threadIdx.x & 31;
  const long long base =
      (((long long)blockIdx.x * kHistThreads + threadIdx.x) >> 5) * 32 *
      kQuadItems;
  int4 b[kQuadItems];
  float4 w[kQuadItems];
#pragma unroll
  for (int j = 0; j < kQuadItems; ++j) {
    const long long q = base + j * 32 + lane;
    if (q < n_quads) {
      b[j] = __ldcs(reinterpret_cast<const int4*>(bins) + q);
      w[j] = __ldcs(reinterpret_cast<const float4*>(weights) + q);
    } else {
      b[j] = make_int4(-1, -1, -1, -1);
      w[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int j = 0; j < kQuadItems; ++j) {
    if (in_range(b[j].x, n_bins)) add_scalar(out + b[j].x, w[j].x);
    if (in_range(b[j].y, n_bins)) add_scalar(out + b[j].y, w[j].y);
    if (in_range(b[j].z, n_bins)) add_scalar(out + b[j].z, w[j].z);
    if (in_range(b[j].w, n_bins)) add_scalar(out + b[j].w, w[j].w);
  }
  const long long e =
      4 * n_quads + (long long)blockIdx.x * kHistThreads + threadIdx.x;
  if (e < n_events) {
    const int bt = bins[e];
    if (in_range(bt, n_bins)) add_scalar(out + bt, weights[e]);
  }
}

// 4 (kF4 = 1) or 8 (kF4 = 2) bands, 16-byte aligned: an item is one event,
// its row one or two float4s, each added by one vector reduction.
template <int kF4>
__global__ void __launch_bounds__(kHistThreads)
histogram_rows_kernel(const int* __restrict__ bins,
                      const float* __restrict__ weights, long long n_events,
                      int n_bins, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long base =
      (((long long)blockIdx.x * kHistThreads + threadIdx.x) >> 5) * 32 *
      kRowItems;
  int b[kRowItems];
  float4 w[kRowItems][kF4];
#pragma unroll
  for (int j = 0; j < kRowItems; ++j) {
    const long long e = base + j * 32 + lane;
    b[j] = e < n_events ? __ldcs(bins + e) : -1;
#pragma unroll
    for (int k = 0; k < kF4; ++k)
      w[j][k] = e < n_events
                    ? __ldcs(reinterpret_cast<const float4*>(weights) +
                             e * kF4 + k)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < kRowItems; ++j) {
    bool active = false;
#pragma unroll
    for (int k = 0; k < kF4; ++k) active = active || any_nonzero(w[j][k]);
    if (!active || !in_range(b[j], n_bins)) continue;
    float4* dst = reinterpret_cast<float4*>(out) + (long long)b[j] * kF4;
#pragma unroll
    for (int k = 0; k < kF4; ++k) atomicAdd(dst + k, w[j][k]);
  }
}

// ----------------------------------------------- the hard-binning stage

// The event's bin, or -1 when it is out of [0, nb): rintf rounds half to
// even, as torch.round; NaN fails both comparisons.
__device__ __forceinline__ int hard_bin(float bin_f, int nb) {
  const float r = rintf(bin_f);
  if (!(r >= 0.0f && r < 2147483648.0f)) return -1;
  const int b = (int)r;
  return b < nb ? b : -1;
}

__device__ __forceinline__ int ear_of(int ear) { return ear != 0; }

struct Binned {
  float* out;     // [P, 2, nb, n_bands] of this launch's first pose
  int nb;
  int delay;
  float scale;    // 1 - hrtf_absorption_rate
  bool mono;

  // The rows (p * 2 + ear) * nb + b of the same and the other ear.
  __device__ __forceinline__ long long same_row(long long pose, int ear,
                                                int b) const {
    return (pose * 2 + ear) * nb + b;
  }
  __device__ __forceinline__ long long cross_row(long long pose, int ear,
                                                 int b) const {
    return (pose * 2 + 1 - ear) * nb + (b + delay < nb ? b + delay : b);
  }
};

// One band, 16-byte aligned, E a multiple of 4: an item is 4 consecutive
// events of one pose (a float4 of arrival times, of weights, of ears).
__global__ void __launch_bounds__(kHistThreads)
binned_quad_kernel(const float* __restrict__ bin_f,
                   const float* __restrict__ weights,
                   const int* __restrict__ ear, long long per_pose,
                   Binned h) {
  const long long pose = blockIdx.y;
  const long long n_quads = per_pose >> 2;
  const long long first = pose * n_quads;
  const int lane = threadIdx.x & 31;
  const long long base =
      (((long long)blockIdx.x * kHistThreads + threadIdx.x) >> 5) * 32 *
      kQuadItems;
  float4 t[kQuadItems], w[kQuadItems];
  int4 s[kQuadItems];
#pragma unroll
  for (int j = 0; j < kQuadItems; ++j) {
    const long long q = base + j * 32 + lane;
    t[j] = w[j] = make_float4(0.f, 0.f, 0.f, 0.f);  // zero weight: skipped
    s[j] = make_int4(0, 0, 0, 0);
    if (q < n_quads) {
      t[j] = __ldcs(reinterpret_cast<const float4*>(bin_f) + first + q);
      w[j] = __ldcs(reinterpret_cast<const float4*>(weights) + first + q);
      s[j] = __ldcs(reinterpret_cast<const int4*>(ear) + first + q);
    }
  }
#pragma unroll
  for (int j = 0; j < kQuadItems; ++j) {
    const float tv[4] = {t[j].x, t[j].y, t[j].z, t[j].w};
    const float wv[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
    const int ev[4] = {ear_of(s[j].x), ear_of(s[j].y), ear_of(s[j].z),
                       ear_of(s[j].w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (wv[i] == 0.0f) continue;
      const int b = hard_bin(tv[i], h.nb);
      if (b < 0) continue;
      atomicAdd(h.out + h.same_row(pose, ev[i], b), wv[i]);
      if (!h.mono) atomicAdd(h.out + h.cross_row(pose, ev[i], b),
                             h.scale * wv[i]);
    }
  }
}

// 4 (kF4 = 1) or 8 (kF4 = 2) bands, 16-byte aligned: an item is one event,
// its weights one or two float4s, each deposit one or two vector
// reductions.
template <int kF4>
__global__ void __launch_bounds__(kHistThreads)
binned_rows_kernel(const float* __restrict__ bin_f,
                   const float* __restrict__ weights,
                   const int* __restrict__ ear, long long per_pose,
                   Binned h) {
  const long long pose = blockIdx.y;
  const long long first = pose * per_pose;
  const int lane = threadIdx.x & 31;
  const long long base =
      (((long long)blockIdx.x * kHistThreads + threadIdx.x) >> 5) * 32 *
      kRowItems;
  float t[kRowItems];
  int s[kRowItems];
  float4 w[kRowItems][kF4];
#pragma unroll
  for (int j = 0; j < kRowItems; ++j) {
    const long long e = base + j * 32 + lane;
    const bool in = e < per_pose;
    t[j] = in ? __ldcs(bin_f + first + e) : -1.0f;
    s[j] = in ? ear_of(__ldcs(ear + first + e)) : 0;
#pragma unroll
    for (int k = 0; k < kF4; ++k)
      w[j][k] = in ? __ldcs(reinterpret_cast<const float4*>(weights) +
                            (first + e) * kF4 + k)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < kRowItems; ++j) {
    bool active = false;
#pragma unroll
    for (int k = 0; k < kF4; ++k) active = active || any_nonzero(w[j][k]);
    if (!active) continue;
    const int b = hard_bin(t[j], h.nb);
    if (b < 0) continue;
    float4* same = reinterpret_cast<float4*>(h.out) +
                   h.same_row(pose, s[j], b) * kF4;
#pragma unroll
    for (int k = 0; k < kF4; ++k) atomicAdd(same + k, w[j][k]);
    if (h.mono) continue;
    float4* cross = reinterpret_cast<float4*>(h.out) +
                    h.cross_row(pose, s[j], b) * kF4;
#pragma unroll
    for (int k = 0; k < kF4; ++k) atomicAdd(cross + k, scaled(w[j][k],
                                                               h.scale));
  }
}

// Any layout: one event a thread, n_bands scalar loads and atomics.
__global__ void __launch_bounds__(kHistThreads)
binned_kernel(const float* __restrict__ bin_f,
              const float* __restrict__ weights,
              const int* __restrict__ ear, long long per_pose, int n_bands,
              Binned h) {
  const long long pose = blockIdx.y;
  const long long e = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  if (e >= per_pose) return;
  const long long i = pose * per_pose + e;
  const float* w = weights + i * n_bands;
  bool active = false;
  for (int k = 0; k < n_bands; ++k) active = active || w[k] != 0.0f;
  if (!active) return;
  const int b = hard_bin(bin_f[i], h.nb);
  if (b < 0) return;
  const int side = ear_of(ear[i]);
  float* same = h.out + h.same_row(pose, side, b) * n_bands;
  for (int k = 0; k < n_bands; ++k) add_scalar(same + k, w[k]);
  if (h.mono) return;
  float* cross = h.out + h.cross_row(pose, side, b) * n_bands;
  for (int k = 0; k < n_bands; ++k) add_scalar(cross + k, h.scale * w[k]);
}

template <typename... T>
bool aligned16(const T*... p) {
  return ((reinterpret_cast<size_t>(p) | ...) & 15) == 0;
}

// Blocks of kHistThreads threads that take `per_thread` of `items` each.
unsigned blocks_for(long long items, int per_thread) {
  const long long per_block = (long long)kHistThreads * per_thread;
  return (unsigned)((items + per_block - 1) / per_block);
}

void launch_binned(const float* bin_f, const float* w, const int* ear,
                   int n_poses, long long per_pose, int n_bands, Binned h,
                   cudaStream_t s) {
  const bool aligned = aligned16(bin_f, w, ear, h.out);
  const dim3 quads(blocks_for(per_pose / 4, kQuadItems), n_poses);
  const dim3 rows(blocks_for(per_pose, kRowItems), n_poses);
  if (aligned && n_bands == 1 && per_pose % 4 == 0) {
    binned_quad_kernel<<<quads, kHistThreads, 0, s>>>(
        bin_f, w, ear, per_pose, h);
  } else if (aligned && n_bands == 4) {
    binned_rows_kernel<1><<<rows, kHistThreads, 0, s>>>(bin_f, w, ear,
                                                       per_pose, h);
  } else if (aligned && n_bands == 8) {
    binned_rows_kernel<2><<<rows, kHistThreads, 0, s>>>(bin_f, w, ear,
                                                       per_pose, h);
  } else {
    const unsigned blocks =
        (unsigned)((per_pose + kHistThreads - 1) / kHistThreads);
    binned_kernel<<<dim3(blocks, n_poses), kHistThreads, 0, s>>>(
        bin_f, w, ear, per_pose, n_bands, h);
  }
}

constexpr int kBwdThreads = 256;
constexpr int kItems = 4;           // items a thread takes at a time
constexpr int kStaged = 57344;      // values of g in shared memory: 224 KiB
constexpr int kStagedThreads = 1024;

// One band, 16-byte aligned, g's first n_staged values (a multiple of 4) in
// shared memory; one block an SM.
__device__ __forceinline__ float staged_value(const float* s_g,
                                              const float* __restrict__ g,
                                              int b, int n_bins,
                                              int n_staged) {
  if (!in_range(b, n_bins)) return 0.0f;
  return b < n_staged ? s_g[b] : __ldg(g + b);
}

__global__ void __launch_bounds__(kStagedThreads)
histogram_bwd_staged_kernel(const int* __restrict__ bins,
                            const float* __restrict__ g, long long n_events,
                            int n_bins, int n_staged,
                            float* __restrict__ g_w) {
  extern __shared__ float4 s_g4[];
  const float* s_g = reinterpret_cast<const float*>(s_g4);
  for (int k = threadIdx.x; k < n_staged / 4; k += blockDim.x)
    s_g4[k] = __ldg(reinterpret_cast<const float4*>(g) + k);
  __syncthreads();
  const long long n_quads = n_events >> 2;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kStagedThreads + threadIdx.x) >> 5;
  const long long n_warps = (long long)gridDim.x * (kStagedThreads / 32);
  for (long long base = warp * 32 * kItems; base < n_quads;
       base += n_warps * 32 * kItems) {
    int4 b[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long q = base + j * 32 + lane;
      b[j] = q < n_quads ? __ldcs(reinterpret_cast<const int4*>(bins) + q)
                         : make_int4(-1, -1, -1, -1);
    }
    float4 v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      v[j] = make_float4(staged_value(s_g, g, b[j].x, n_bins, n_staged),
                         staged_value(s_g, g, b[j].y, n_bins, n_staged),
                         staged_value(s_g, g, b[j].z, n_bins, n_staged),
                         staged_value(s_g, g, b[j].w, n_bins, n_staged));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long q = base + j * 32 + lane;
      if (q < n_quads) __stcs(reinterpret_cast<float4*>(g_w) + q, v[j]);
    }
  }
  // The last n_events % 4 events, one a thread.
  const long long e =
      4 * n_quads + (long long)blockIdx.x * kStagedThreads + threadIdx.x;
  if (e < n_events)
    __stcs(g_w + e, staged_value(s_g, g, __ldcs(bins + e), n_bins, n_staged));
}

// One event an item. kF4 > 0: rows of kF4 float4s (4 or 8 bands, 16-byte
// aligned), kItems events a thread; else n_bands scalars, one event a
// thread.
template <int kF4>
__global__ void __launch_bounds__(kBwdThreads)
histogram_bwd_kernel(const int* __restrict__ bins,
                     const float* __restrict__ g, long long n_events,
                     int n_bins, int n_bands, float* __restrict__ g_w) {
  constexpr int kPer = kF4 > 0 ? kItems : 1;
  const int lane = threadIdx.x & 31;
  const long long base =
      (((long long)blockIdx.x * kBwdThreads + threadIdx.x) >> 5) * 32 * kPer;
  int b[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = base + j * 32 + lane;
    b[j] = e < n_events ? __ldcs(bins + e) : -1;
  }
  if constexpr (kF4 > 0) {
    float4 v[kPer][kF4];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int k = 0; k < kF4; ++k)
        v[j][k] = in_range(b[j], n_bins)
                      ? __ldg(reinterpret_cast<const float4*>(g) +
                              (long long)b[j] * kF4 + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long e = base + j * 32 + lane;
      if (e < n_events)
#pragma unroll
        for (int k = 0; k < kF4; ++k)
          __stcs(reinterpret_cast<float4*>(g_w) + e * kF4 + k, v[j][k]);
    }
  } else {
    const long long e = base + lane;
    if (e >= n_events) return;
    const bool in = in_range(b[0], n_bins);
    const float* src = g + (long long)(in ? b[0] : 0) * n_bands;
    for (int k = 0; k < n_bands; ++k)
      __stcs(g_w + e * n_bands + k, in ? __ldg(src + k) : 0.0f);
  }
}

template <int kF4>
void launch_bwd(const int* bins, const float* g, long long n_events,
                int n_bins, int n_bands, float* g_w, cudaStream_t stream) {
  const long long per_block = (long long)kBwdThreads * (kF4 > 0 ? kItems : 1);
  histogram_bwd_kernel<kF4><<<(unsigned)((n_events + per_block - 1) /
                                         per_block),
                              kBwdThreads, 0, stream>>>(bins, g, n_events,
                                                        n_bins, n_bands, g_w);
}

}  // namespace

extern "C" int ar2_histogram(const int* bins, const float* weights,
                             long long n_events, int n_bins, int n_bands,
                             float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)n_bins * n_bands * sizeof(float), s);
  if (err != cudaSuccess || n_events <= 0) return (int)err;
  const bool aligned = aligned16(bins, weights, out);
  if (aligned && n_bands == 1) {
    histogram_quad_kernel<<<blocks_for((n_events + 3) / 4, kQuadItems),
                            kHistThreads, 0, s>>>(bins, weights, n_events, n_bins, out);
  } else if (aligned && n_bands == 4) {
    histogram_rows_kernel<1><<<blocks_for(n_events, kRowItems),
                             kHistThreads, 0, s>>>(
        bins, weights, n_events, n_bins, out);
  } else if (aligned && n_bands == 8) {
    histogram_rows_kernel<2><<<blocks_for(n_events, kRowItems),
                             kHistThreads, 0, s>>>(
        bins, weights, n_events, n_bins, out);
  } else {
    const long long blocks = (n_events + kHistThreads - 1) / kHistThreads;
    histogram_kernel<<<(unsigned)blocks, kHistThreads, 0, s>>>(
        bins, weights, n_events, n_bins, n_bands, out);
  }
  return (int)cudaGetLastError();
}

// The hard-binning stage: out f32 [n_poses, 2, ir_length, n_bands], zero
// filled here; `ear` int32 [n_poses, per_pose], 0 or 1.
extern "C" int ar2_histogram_binned(const float* bin_f, const float* weights,
                                    const int* ear, int n_poses,
                                    long long per_pose,
                                    int n_bands, int ir_length, int is_mono,
                                    int delay, float scale, float* out,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long pose_floats = 2LL * ir_length * n_bands;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)n_poses * pose_floats * sizeof(float), s);
  if (err != cudaSuccess || per_pose <= 0) return (int)err;
  if (n_bands < 1 || ir_length < 1 || delay < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int kMaxGridY = 65535;
  for (int p0 = 0; p0 < n_poses; p0 += kMaxGridY) {
    const int np = n_poses - p0 < kMaxGridY ? n_poses - p0 : kMaxGridY;
    const long long first = (long long)p0 * per_pose;
    const Binned h{out + p0 * pose_floats, ir_length, delay, scale,
                   is_mono != 0};
    launch_binned(bin_f + first, weights + first * n_bands, ear + first, np,
                  per_pose, n_bands, h, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int ar2_histogram_bwd(const int* bins, const float* g,
                                 long long n_events, int n_bins, int n_bands,
                                 float* g_w, void* stream) {
  if (n_events <= 0) return (int)cudaSuccess;
  const bool aligned = ((reinterpret_cast<size_t>(bins) |
                         reinterpret_cast<size_t>(g) |
                         reinterpret_cast<size_t>(g_w)) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned && n_bands == 1 && n_bins <= 2 * kStaged) {
    const int n_staged = (n_bins < kStaged ? n_bins : kStaged) & ~3;
    const int smem = n_staged * (int)sizeof(float);
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(histogram_bwd_staged_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return (int)err;
    histogram_bwd_staged_kernel<<<sms, kStagedThreads, smem, s>>>(
        bins, g, n_events, n_bins, n_staged, g_w);
  } else if (aligned && n_bands == 4) {
    launch_bwd<1>(bins, g, n_events, n_bins, n_bands, g_w, s);
  } else if (aligned && n_bands == 8) {
    launch_bwd<2>(bins, g, n_events, n_bins, n_bands, g_w, s);
  } else {
    launch_bwd<0>(bins, g, n_events, n_bins, n_bands, g_w, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ar2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
