// The clustered route's coherence keys: one int32 sort key a ray, in two
// launches, a bounds pass and a key pass.
//
// Replaces no pl.pallas_call. On the TPU the keys are plain XLA
// (audiorenderingv2_tpu/ops/raytrace_pallas.py:_compaction_keys, :270-351,
// dir72 layout), which jit fuses into one pass; the port ran the same
// function as an eager chain of about 116 small PyTorch launches a round
// (ops/raytrace_cuda.py:_compaction_keys, still the plain version). This
// file computes that function, integer for integer:
//
//   done   = (int)state[DONE]
//   for each of the n_poses equal segments of the ray axis: the min and
//          max of px, py, pz over ALL its rays, done and padded ones too
//   cell   = clamp((int)((p - pmin) / max(pmax - pmin, 1e-6f) * scale),
//                  0, res - 1), res = 2^cell_bits, every step rounded as
//          float32, scale = (float)(res - 0.001)
//   octant = (vx > 0) * 4 + (vy > 0) * 2 + (vz > 0)
//   a0, a1 = the dominant axis of |v| and the next, ties to the lower index
//   key    = done * 72 * res^3 + (octant * 9 + a0 * 3 + a1) * res^3
//            + Morton(cell) over 3 * cell_bits bits
//
// with the plain chain's NaN behaviour: the min and max propagate a NaN,
// the clamp of the span keeps it, and the casts are the card's
// round-toward-zero conversion (cvt.rzi), as PyTorch's own casts are.
// The library is built with -fmad=false and IEEE division, so each float
// operation rounds as in the chain.
//
// Design. What bounds it is its bytes, about 44 a ray: 3 position floats
// read by the bounds pass, 7 floats read and one int32 written by the key
// pass (44 MB at 1,000,064 rays, 13 us at 3.35 TB/s). So each pass reads
// its columns once, coalesced, with several loads in flight a thread:
//
// * bounds pass: a grid of (B, n_poses) blocks of 512 threads; block (b, p)
//   reduces its stride of pose p's rays to six numbers in registers, then
//   through the warps' shuffles and shared memory, and writes them to
//   partials [n_poses, 6, B]. Min and max do not depend on the order of
//   reduction, so no atomics and no zero fill are needed, and the result
//   is the same whatever B is;
// * key pass: a grid of (ceil(rays_per_pose / 1024), n_poses) blocks of
//   256 threads; warp q of a block first folds quantity q of its pose's B
//   partials (B <= 1024; 128 at most from the wrapper, 3 KB read from L2 a
//   block), then each thread makes the keys of 4 rays.
//
// Two launches a call, in place of the chain's ~116; nothing is allocated
// here (the wrapper hands in partials and keys) and nothing is read back.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBoundsThreads = 512;
constexpr int kBoundsUnroll = 4;
constexpr int kKeyThreads = 256;
constexpr int kKeyRays = 4;  // rays a thread of the key pass
constexpr int kMaxCellBits = 7;
constexpr unsigned kFull = 0xffffffffu;
enum { C_PX, C_PY, C_PZ, C_VX, C_VY, C_VZ, C_DONE = 9 };

// torch.amin / amax on the card: a NaN on either side wins.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ void fold(float (&v)[6], const float (&w)[6]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v[q] = min_nan(v[q], w[q]);
    v[q + 3] = max_nan(v[q + 3], w[q + 3]);
  }
}

__global__ void __launch_bounds__(kBoundsThreads)
keys_bounds_kernel(const float* __restrict__ st, long long n,
                   long long per_pose, int n_blocks,
                   float* __restrict__ partials) {
  const int pose = blockIdx.y;
  const long long base = (long long)pose * per_pose;
  const long long stride = (long long)n_blocks * kBoundsThreads;
  float v[6] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (long long i0 = (long long)blockIdx.x * kBoundsThreads + threadIdx.x;
       i0 < per_pose; i0 += stride * kBoundsUnroll) {
    float x[kBoundsUnroll][3];
#pragma unroll
    for (int u = 0; u < kBoundsUnroll; ++u) {
      const long long i = i0 + u * stride;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        x[u][q] = i < per_pose ? st[q * n + base + i] : CUDART_NAN_F;
    }
#pragma unroll
    for (int u = 0; u < kBoundsUnroll; ++u) {
      if (i0 + u * stride >= per_pose) break;
      const float w[6] = {x[u][0], x[u][1], x[u][2],
                          x[u][0], x[u][1], x[u][2]};
      fold(v, w);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float w[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) w[q] = __shfl_xor_sync(kFull, v[q], off);
    fold(v, w);
  }
  __shared__ float warp_v[kBoundsThreads / 32][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) warp_v[warp][q] = v[q];
  }
  __syncthreads();
  if (warp) return;
  if (lane < kBoundsThreads / 32) {
#pragma unroll
    for (int q = 0; q < 6; ++q) v[q] = warp_v[lane][q];
  }
  // Lanes past the warp count hold their own values, already folded in.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    float w[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) w[q] = __shfl_xor_sync(kFull, v[q], off);
    fold(v, w);
  }
  if (lane < 6) {
    float out = v[0];
#pragma unroll
    for (int q = 1; q < 6; ++q)
      if (lane == q) out = v[q];
    partials[((long long)pose * 6 + lane) * n_blocks + blockIdx.x] = out;
  }
}

// The dominant axis of (a, b, c), ties to the lower index
// (_dominant_axis's nested where).
__device__ __forceinline__ int dominant(float a, float b, float c) {
  return (a >= b && a >= c) ? 0 : (b >= c ? 1 : 2);
}

__device__ __forceinline__ int cell_of(float p, float lo, float span,
                                       float scale, int res) {
  const int c = __float2int_rz((p - lo) / span * scale);
  return c < 0 ? 0 : (c > res - 1 ? res - 1 : c);
}

__global__ void __launch_bounds__(kKeyThreads)
keys_kernel(const float* __restrict__ st, long long n, long long per_pose,
            const float* __restrict__ partials, int n_blocks, int cell_bits,
            float scale, int* __restrict__ keys) {
  const int pose = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float bnd[6];
  if (warp < 6) {
    const float* src = partials + ((long long)pose * 6 + warp) * n_blocks;
    const bool is_min = warp < 3;
    float v = is_min ? CUDART_INF_F : -CUDART_INF_F;
    for (int j = lane; j < n_blocks; j += 32)
      v = is_min ? min_nan(v, src[j]) : max_nan(v, src[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float w = __shfl_xor_sync(kFull, v, off);
      v = is_min ? min_nan(v, w) : max_nan(v, w);
    }
    if (lane == 0) bnd[warp] = v;
  }
  __syncthreads();
  const int res = 1 << cell_bits;
  const unsigned res3 = (unsigned)res * res * res;
  float lo[3], span[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    lo[q] = bnd[q];
    const float s = bnd[q + 3] - bnd[q];
    span[q] = s != s ? s : fmaxf(s, 1e-6f);  // clamp(min=1e-6) keeps a NaN
  }
  const long long base = (long long)pose * per_pose;
  const long long first =
      (long long)blockIdx.x * (kKeyThreads * kKeyRays) + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kKeyRays; ++r) {
    const long long i = first + r * kKeyThreads;
    if (i >= per_pose) break;
    const float* c = st + base + i;
    const float px = c[C_PX * n], py = c[C_PY * n], pz = c[C_PZ * n];
    const float vx = c[C_VX * n], vy = c[C_VY * n], vz = c[C_VZ * n];
    const unsigned done = (unsigned)__float2int_rz(c[C_DONE * n]);
    const int cx = cell_of(px, lo[0], span[0], scale, res);
    const int cy = cell_of(py, lo[1], span[1], scale, res);
    const int cz = cell_of(pz, lo[2], span[2], scale, res);
    const int octant = (vx > 0.f) * 4 + (vy > 0.f) * 2 + (vz > 0.f);
    const float ax = fabsf(vx), ay = fabsf(vy), az = fabsf(vz);
    const int a0 = dominant(ax, ay, az);
    const int a1 = dominant(a0 == 0 ? -CUDART_INF_F : ax,
                            a0 == 1 ? -CUDART_INF_F : ay,
                            a0 == 2 ? -CUDART_INF_F : az);
    unsigned morton = 0u;
#pragma unroll
    for (int b = 0; b < kMaxCellBits; ++b) {
      if (b >= cell_bits) break;
      morton |= (((unsigned)cx >> b) & 1u) << (3 * b)
              | (((unsigned)cy >> b) & 1u) << (3 * b + 1)
              | (((unsigned)cz >> b) & 1u) << (3 * b + 2);
    }
    const unsigned dirbin = (unsigned)(octant * 9 + a0 * 3 + a1);
    keys[base + i] = (int)(done * (72u * res3) + dirbin * res3 + morton);
  }
}

}  // namespace

extern "C" int ar2_compaction_keys(const float* state, long long n,
                                   int ncols, int n_poses, int cell_bits,
                                   float* partials, int n_blocks, int* keys,
                                   void* stream) {
  if (n <= 0 || ncols < 16 || n_poses < 1 || n_poses > 65535
      || n % n_poses || cell_bits < 0 || cell_bits > kMaxCellBits
      || n_blocks < 1 || n_blocks > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long per_pose = n / n_poses;
  keys_bounds_kernel<<<dim3((unsigned)n_blocks, (unsigned)n_poses),
                       kBoundsThreads, 0, s>>>(state, n, per_pose, n_blocks,
                                               partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Python's float32(res - 0.001): the double difference, rounded once.
  const float scale = (float)((double)(1 << cell_bits) - 0.001);
  const long long key_blocks =
      (per_pose + kKeyThreads * kKeyRays - 1) / (kKeyThreads * kKeyRays);
  keys_kernel<<<dim3((unsigned)key_blocks, (unsigned)n_poses), kKeyThreads,
                0, s>>>(state, n, per_pose, partials, n_blocks, cell_bits,
                        scale, keys);
  return (int)cudaGetLastError();
}
