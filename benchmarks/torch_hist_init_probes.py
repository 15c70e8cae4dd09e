"""Probes of K3 and K4 designs that were measured on one NVIDIA GPU and not
kept, each beside this tree's kernel.

K3 (csrc/histogram.cu): ``tree_warp_agg``, warp-aggregated adds in the
one-band kernels (the flat-bin quad kernel and the hard-binning quad
kernel): lanes whose deposits share a row sum them by shuffles, and one of
them adds the sum. K4 (csrc/init_state.cu): ``tree_rays4``,
``tree_rays2``, 4 or 2 consecutive rays a thread with one 16- or 8-byte
store a column on a grid of 4 blocks an SM; ``tree_rays4_blocks2``,
``tree_rays4_blocks32``, ``tree_rays4_one_wave``, the same with 2 or 32
blocks an SM or every block at once; ``tree_rays4_bulk``, a block's
[ncols, 512 rays] tile staged in shared memory and each column written by
one bulk copy (``cp.async.bulk`` global <- shared).

    python3 benchmarks/torch_hist_init_probes.py [--rays N] [--out FILE]

Each probe is a copy of this tree's source with a text edit, built into a
library of its own under the package's ``_build/``; the committed sources
are not touched, and after an edit to them a probe may raise, naming the
text it missed. ``hist_levers`` and ``init_levers`` of
benchmarks/torch_trace_ab.py hold every library's output against the
plain version, then time it: device time of 20 calls in one CUDA graph,
forward and reverse order (K3: the flat-bin entry at 1, 4 and 8 bands and
posed on uniform bins and on the box render's own bins, the hard-binning
entry on the box render's and the 2 x 4 matrix's events; K4: 1, 4 and 8
bands). Prints one JSON line (and writes it to ``--out``); exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_trace_ab import (_replace, build_variants, hist_levers,  # noqa: E402
                            init_levers)

# Warp-aggregated adds for the one-band kernels of K3 (the flat-bin quad
# kernel and the hard-binning quad kernel): lanes whose deposits share a
# row sum them by shuffles and one of them adds the sum.
_AGG = r"""
__device__ __forceinline__ void agg_add(float* out, long long row, float w) {
  const unsigned all = 0xffffffffu;
  const unsigned peers = __match_any_sync(all, row);
  if (__any_sync(all, row >= 0 && __popc(peers) > 1)) {
    float sum = 0.0f;
    for (int src = 0; src < 32; ++src) {
      const float x = __shfl_sync(all, w, src);
      if ((peers >> src) & 1u) sum += x;
    }
    if (row >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(out + row, sum);
  } else if (row >= 0) {
    atomicAdd(out + row, w);
  }
}
"""


def hist_probes(tree: str) -> dict[str, str]:
    """Copies of csrc/histogram.cu: ``tree_warp_agg``."""
    out = {}
    agg = _replace(tree, "// Scalar path: one event a thread, n_bands scalar",
                   _AGG + "// Scalar path: one event a thread, n_bands scalar")
    agg = _replace(agg, """  for (int j = 0; j < kQuadItems; ++j) {
    if (in_range(b[j].x, n_bins)) add_scalar(out + b[j].x, w[j].x);
    if (in_range(b[j].y, n_bins)) add_scalar(out + b[j].y, w[j].y);
    if (in_range(b[j].z, n_bins)) add_scalar(out + b[j].z, w[j].z);
    if (in_range(b[j].w, n_bins)) add_scalar(out + b[j].w, w[j].w);
  }""", """  for (int j = 0; j < kQuadItems; ++j) {
    const int bv[4] = {b[j].x, b[j].y, b[j].z, b[j].w};
    const float wv[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      agg_add(out, in_range(bv[i], n_bins) && wv[i] != 0.0f ? bv[i] : -1,
              wv[i]);
  }""")
    agg = _replace(agg, """    for (int i = 0; i < 4; ++i) {
      if (wv[i] == 0.0f) continue;
      const int b = hard_bin(tv[i], h.nb);
      if (b < 0) continue;
      atomicAdd(h.out + h.same_row(pose, ev[i], b), wv[i]);
      if (!h.mono) atomicAdd(h.out + h.cross_row(pose, ev[i], b),
                             h.scale * wv[i]);
    }""", """    for (int i = 0; i < 4; ++i) {
      const int b = wv[i] == 0.0f ? -1 : hard_bin(tv[i], h.nb);
      agg_add(h.out, b < 0 ? -1 : h.same_row(pose, ev[i], b), wv[i]);
      if (!h.mono)
        agg_add(h.out, b < 0 ? -1 : h.cross_row(pose, ev[i], b),
                h.scale * wv[i]);
    }""")
    out["tree_warp_agg"] = agg
    return out


# K4 with kRays consecutive rays a thread (one store of kRays floats a
# column) on a grid of kBlocksPerSM blocks an SM that stride over the rays:
# the design csrc/init_state.cu measured against its one ray a thread.
_K4_RAYS = r"""constexpr int kRays = 4;         // consecutive rays a thread: 1, 2 or 4
constexpr int kBlocksPerSM = 4;  // the grid's blocks stride over the rays

// kRays floats as one store: float, float2 or float4.
template <int R> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T of(const float* v) { return v[0]; }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static T of(const float* v) { return make_float2(v[0], v[1]); }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static T of(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int LB>
__global__ void __launch_bounds__(kThreads)
init_state_kernel(float* __restrict__ st, long long n_pad, long long n_real,
                  const float* __restrict__ scal, int n_bands) {
  using V = Vec<kRays>;
  const long long n_groups = n_pad / kRays;
  const unsigned seed = (unsigned)(int)scal[S_SEED];
  const float e0 = scal[S_E0];
  const float unit = 1.0f / 16777216.0f;  // 2^-24
  const float px = scal[S_EMX], py = scal[S_EMY], pz = scal[S_EMZ];
  for (long long group = (long long)blockIdx.x * kThreads + threadIdx.x;
       group < n_groups; group += (long long)gridDim.x * kThreads) {
    float vx[kRays], vy[kRays], vz[kRays], en[kRays], done[kRays],
        id[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const long long ray = group * kRays + r;
      unsigned b0, b1;
      philox4x32_10((unsigned)(ray & 0xFFFFFFFFll), (unsigned)(ray >> 32),
                    seed, b0, b1);
      const float u1 = (float)(b0 >> 8) * unit;
      const float u2 = (float)(b1 >> 8) * unit;
      const float theta = 6.283185307179586f * u1;
      const float cos_phi = 2.0f * u2 - 1.0f;
      const float sin_phi = sqrtf(fmaxf(0.0f, 1.0f - cos_phi * cos_phi));
      float s, c;
      sincosf(theta, &s, &c);
      vx[r] = sin_phi * c;
      vy[r] = sin_phi * s;
      vz[r] = cos_phi;
      const bool real = ray < n_real;
      en[r] = real ? e0 : 0.0f;
      done[r] = real ? 0.0f : 1.0f;
      id[r] = (float)ray;
    }
    // Column k of ray r; k and r are compile-time constants after
    // unrolling, so the selection folds away and every value stays in a
    // register.
    auto value = [&](int k, int r) -> float {
      if (k == C_PX) return px;
      if (k == C_PY) return py;
      if (k == C_PZ) return pz;
      if (k == C_VX) return vx[r];
      if (k == C_VY) return vy[r];
      if (k == C_VZ) return vz[r];
      if (k == C_DONE) return done[r];
      if (k == C_RAYID) return id[r];
      if (k == C_RECVD) return -1.0f;
      // EN of band 0, and of bands 1.. in columns 16.. (en_col).
      if (k == C_EN) return en[r];
      if (k >= 16 && k < 16 + LB - 1 && k - 15 < n_bands) return en[r];
      return 0.0f;
    };
    // Every column once, one store of kRays floats a column.
    typename V::T* c = reinterpret_cast<typename V::T*>(st) + group;
#pragma unroll
    for (int k = 0; k < state_ncols<LB>(); ++k) {
      float v[kRays];
#pragma unroll
      for (int r = 0; r < kRays; ++r) v[r] = value(k, r);
      c[k * n_groups] = V::of(v);
    }
  }
}

// The grid: at most kBlocksPerSM blocks an SM, so that a block's stores
// drain while its threads draw their next rays.
cudaError_t grid_blocks(long long groups, unsigned* blocks) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
  }
  const long long need = (groups + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  *blocks = (unsigned)(need < cap ? need : cap);
  return cudaSuccess;
}

template <int LB>
int launch(float* state, long long n_pad, int ncols, long long n_real,
           const float* scal, int n_bands, cudaStream_t stream) {
  if (ncols != state_ncols<LB>() || n_bands > LB)
    return (int)cudaErrorInvalidValue;
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(n_pad / kRays, &blocks);
  if (err != cudaSuccess) return (int)err;
  init_state_kernel<LB><<<blocks, kThreads, 0, stream>>>(
      state, n_pad, n_real, scal, n_bands);
  return (int)cudaGetLastError();
}

"""


def init_variants(tree: str) -> dict[str, str]:
    """Copies of csrc/init_state.cu with its kernel replaced by
    ``_K4_RAYS``: ``tree_rays4`` (16-byte stores, 4 blocks an SM),
    ``tree_rays2`` (8-byte stores), ``tree_rays4_blocks2``, ``_blocks32``
    and ``_one_wave`` (the grid capped at 2 or 32 blocks an SM, or not at
    all), and ``tree_rays4_bulk``, which stages a block's [ncols, 512 rays]
    tile in shared memory and writes each column with one bulk copy
    (``cp.async.bulk`` global <- shared, one thread a column) instead of
    the threads' 16-byte stores."""
    start = tree.index("template <int LB>\n__global__ void __launch_bounds__"
                       "(kThreads)\ninit_state_kernel(")
    rays4 = tree[:start] + _K4_RAYS + tree[tree.index("}  // namespace"):]
    rays = "constexpr int kRays = 4;"
    cap = "constexpr int kBlocksPerSM = 4;"
    out = {"tree_rays4": rays4,
           "tree_rays2": _replace(rays4, rays, "constexpr int kRays = 2;")}
    out.update({f"tree_rays4_blocks{k}": _replace(
        rays4, cap, f"constexpr int kBlocksPerSM = {k};") for k in (2, 32)})
    out["tree_rays4_one_wave"] = _replace(
        rays4, cap, "constexpr int kBlocksPerSM = 1 << 20;")
    src = _replace(rays4, """  for (long long group = (long long)blockIdx.x * kThreads + threadIdx.x;
       group < n_groups; group += (long long)gridDim.x * kThreads) {""",
                   """  extern __shared__ float4 s_tile[];
  for (long long base = (long long)blockIdx.x * kThreads; base < n_groups;
       base += (long long)gridDim.x * kThreads) {
    const long long group = base + threadIdx.x;""")
    src = _replace(src, """    typename V::T* c = reinterpret_cast<typename V::T*>(st) + group;
""", "")
    src = _replace(src, """      c[k * n_groups] = V::of(v);
    }
  }
}""", """      s_tile[k * kThreads + threadIdx.x] = V::of(v);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x < state_ncols<LB>()) {
      const int k = threadIdx.x;
      const long long nq = n_groups - base < kThreads ? n_groups - base
                                                      : kThreads;
      float4* dst = reinterpret_cast<float4*>(st) + k * n_groups + base;
      const unsigned src =
          (unsigned)__cvta_generic_to_shared(s_tile + k * kThreads);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(dst), "r"(src), "r"((unsigned)(nq * 16)) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    __syncthreads();
  }
}""")
    src = _replace(src, """  init_state_kernel<LB><<<blocks, kThreads, 0, stream>>>(
      state, n_pad, n_real, scal, n_bands);""", """  const int smem = state_ncols<LB>() * kThreads * (int)sizeof(float4);
  const cudaError_t attr = cudaFuncSetAttribute(
      init_state_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  init_state_kernel<LB><<<blocks, kThreads, smem, stream>>>(
      state, n_pad, n_real, scal, n_bands);""")
    out["tree_rays4_bulk"] = src
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rays", type=int, default=1_000_000)
    ap.add_argument("--out", type=Path,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hist_init_probes: no CUDA device", file=sys.stderr)
        return 2
    from audiorenderingv2_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sources = {
        **{f"k3_{k}": v for k, v in hist_probes(
            (_build.CSRC / "histogram.cu").read_text()).items()},
        **{f"k4_{k}": v for k, v in init_variants(
            (_build.CSRC / "init_state.cu").read_text()).items()}}
    probes = build_variants(_build, sources, _build.CSRC,
                            _build.BUILD_ROOT / "hist_init_probes")
    tree = _build.library()

    def libs(prefix: str) -> dict:
        return {"tree": tree, **{k[3:]: v for k, v in probes.items()
                                 if k.startswith(prefix)}}

    result = {"device": card, "rays": args.rays,
              "hist": hist_levers(libs("k3_"), args.rays),
              "init": init_levers(libs("k4_"), args.rays)}
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
