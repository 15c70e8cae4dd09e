"""A/B of the PyTorch port's K1, K1-pose, K7, K5, K6, K3, K3-bwd and K4 on
one NVIDIA GPU.

K1 and K7 (csrc/trace_round.cu: K7 is K1's kernels over the version-1
layouts), K1 with a scalar row per pose and K5 (csrc/trace_traverse.cu) of
this checkout against those of another checkout of the repository (for
example the parent commit, unpacked with ``git archive``), and against
variants compiled from copies of the sources, each held bit for bit against
the kernel's plain PyTorch version on the same state; K2
(csrc/trace_sched.cu) of both checkouts beside them; K3-bwd
(csrc/histogram.cu) of both beside probes of its limit and index_select;
K3, the hard-binning stage and K4 (csrc/init_state.cu) as each checkout's
wrappers run them, and every library's C entries beside lever variants.

    python3 benchmarks/torch_trace_ab.py --parent DIR [--rays N]
        [--phases k1,k1_pose,k7,k5,k2,k6,render,bwd,hist,init,e2e] [--paths P,...]
        [--out FILE]

States (1,000,064 rays unless ``--rays``):

  K1       the box of the export path (14 x 9 x 11 m, 12 triangles in 16
           rows, 100 bounces): the start state of round 1 (8 bounces) and
           the states before round 2 (24) and round 3 (68), each after the
           alive-first partition, reached through the kernel; per round the
           tests made, the bound, and the lane use of one ray a thread (a
           warp's bounces over 32 times its longest ray's)
  K1-pose  the multi-pose demo's box, 8 poses x 1,000,064 rays: round 1 (8
           bounces) and round 2 (32)
  K7       the same box as the [17, 128] table, row-major state, through
           version 1's rounds (6, 12, 24, 58) with the row partition
           between them; the 320-triangle icosphere padded to 512 columns
           (rounds 1-2); the 1,280-triangle icosphere (the multi-chunk
           branch; round 1 at 65,536 rays); K1 on the same state beside it
  K5       the office (19,852 triangles) in clusters of 32 and of 128, one
           bounce from the start state and from the state after one bounce
           and the dir72 sort; visits per tile
  K2       the office in clusters of 32: round 1 unsorted, after one bounce
           and the sort, after 16 bounces
  K6       (csrc/trace_group.cu) both precisions: the box through the
           group route's rounds (6, 12, 24, 58) at 1 and 4 bands, its
           8-bounce round from the start state, the 320-triangle icosphere
           (40 groups, 8 bounces), the multi-pose demo's box (8 poses x
           1,000,064 rays, 8 bounces); "highest" bit for bit against its
           plain version, "high" on chip_smoke.py's bar; K1 beside each

Variants (each its own library, built under the package's ``_build/`` from
a copy of one source; the committed sources are not touched; a K1 variant
changes K7 alike):

  K1  tree_scalar    this tree's kernel with Ray::intersect (17 scalars)
      tree_unroll1   this tree's float4 test, not unrolled
      tree_ilp       the float4 test in steps of 4 rows: their divisors,
                     then the 4 divisions, then the rest, then the fold
      tree_all_rows  no trim: the rows up to the last valid one and padding
                     rows tested alike
      tree_global_tail
                     the tail reads the normal and absorptions from global
                     memory
      tree_grid_all  one warp per 32 rays in every round, no lane takes a
                     second ray
      tree_persist_all
                     the persistent grid in every round
      tree_chunk32   the persistent grid handing out 32 rays at a time
      tree_refill8   the persistent grid, idle lanes refilled only once 8
                     of them wait (or all)
      tree_lb8       __launch_bounds__(128, 8): at most 64 registers
      tree_2x        the test run twice a bounce (the second result
                     discarded): tree_2x - tree is the test's time
  K7  tree_all_rows, tree_scalar, tree_grid_all (each undoes one lever of
      K7's redesign: the trim, the float4 test, the persistent grid)
  K5  tree_all_pairs pass 1 without the superboxes: every box tested
      tree_rescan    this tree's pass 1, then the parent's pass 2: a block
                     reduction over every cluster before each visit, rows
                     staged by scalar copies, the scalar test
      tree_ring2, tree_ring4
                     the visits' rows through K2's ring of 2 or 4 stages:
                     the next clusters' rows in flight while one is tested
      tree_lb6, tree_lb8
                     __launch_bounds__(128, 6 or 8): at most 80 or 64
                     registers
      tree_scalar    Ray::intersect on the staged rows
  K2  tree_ilp       K2 with tree_ilp's test
  K6  tree_unfolded  "highest" with the ray's packed 1 and 0 multiplied in
      tree_scalar    coefficient rows read as 8 scalar loads (volatile, so
                     that they are not merged) instead of two float4
      tree_chunk16   one chunk of at most 16 groups (the icosphere's 40
                     then run the chunked kernel)
      tree_grid_all  one warp per 32 rays in every round
      tree_fp32_high "high" on the FP32 units (the 20 terms in the plain
                     version's order, read from the B fragments) instead of
                     mma.sync
      tree_div_each  one IEEE division a test, each with its own branch to
                     the slow path, instead of four side by side
      tree_lb3       __launch_bounds__(256, 3): at most 80 registers
      tree_highest_lb3
                     the same for "highest" only
      probe_approx_div, probe_no_test
                     probes, timed only: test4's divisions as __fdividef;
                     the test replaced by a fold of the quantities
  K3-bwd probes      the one-event-a-thread kernel with one suspect taken
                     out: ``contiguous`` (a contiguous read of g for the
                     gather), ``stores`` (nothing read), ``bins_only``
                     (nothing written), ``four`` (4 events a thread)
  K3  tree_scalar    one event a thread, scalar loads and atomics, at every
                     band count and in the hard-binning entry
      tree_one_band_scalar
                     the same at one band only
      tree_quad_items1, tree_quad_items4, tree_row_items4
                     1 or 4 quads of events a thread at one band (not 2),
                     4 events a thread at 4 and 8 bands (not 1)
  (the K3 and K4 designs measured and not kept are in
  benchmarks/torch_hist_init_probes.py)

Times are CUDA-event medians of 7 launches after one warm-up, in two passes
(forward and reverse order of the libraries). Then, alone: the office render
with explicit options (K5 in clusters of 128) in subprocesses of the other
checkout and of this one (other, this, this, other; median of 7 renders
each); K3-bwd against ``index_select`` at 1 band, 4 bands, the posed shape,
E = 4k + 3 and a bins[1:] view, 9 repeats of one-call medians of 20, with
device times of 20 calls back to back and the host's time a call
(``histogram_bwd_phase``); K3, the hard-binning stage and K4 (``hist``,
``init``: ``hist_init_phase`` in a process per checkout, other, this,
this, other, then ``hist_levers`` over the C entries of both checkouts
and the variants of ``hist_variants``, ``init_levers`` over both
checkouts', device times from 20 calls in one CUDA graph); and the
paths a user runs end to end, each in a
process of its own per checkout, three pairs (``e2e_phase``; ``--paths``
picks some). Prints one JSON line (and writes it to ``--out``); exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_cluster_ab import (call_k2, load_build_module,  # noqa: E402
                              median_ms)

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TRI_TEST_OPS = 40
SLAB_TEST_OPS = 23
SR, IR_SECONDS = 16000, 2
ROOM, RECEIVER, ABSORPTION, MAX_BOUNCES = (14.0, 9.0, 11.0), (2.5, 1.5, 2.0), \
    0.3, 100
MULTI_ROOM, MULTI_ABSORPTION, MULTI_BOUNCES = (18.0, 10.0, 14.0), 0.25, 40
MULTI_BUDGETS = (8, 32)
MULTI_EMITTERS = np.array([[-5.0, 0.0, -4.0], [6.0, 1.0, 5.0]], np.float32)
MULTI_LISTENERS = np.stack([np.linspace(-6.0, 6.0, 4), np.zeros(4),
                            np.linspace(4.0, -4.0, 4)],
                           axis=1).astype(np.float32)
MULTI_YAWS = np.linspace(0.0, 270.0, 4).astype(np.float32)
OFFICE_TRIS, OFFICE_BOUNCES, OFFICE_RECEIVER = 20000, 32, (6.0, 1.0, -8.0)

# ---------------------------------------------------------------- variants

_K1_CALL = ("        r.template intersect_f4<kUnroll>(s_rows, n_test, 0, "
            "best_t, best_i);")
_K1_KERNEL = ("template <class L>\n__global__ void __launch_bounds__(kThreads)"
              "\ntrace_rows_kernel(")
_K1_PERSIST = ("  const bool persist = budget > kPersistBudget && resident < "
               "want;")
_K5_KERNEL = ("template <int LB>\n__global__ void __launch_bounds__(kThreads)"
              "\ntrace_traverse_kernel(")
_K2_KERNEL = ("template <int LB>\n__global__ void __launch_bounds__(kThreads)"
              "\ntrace_sched_kernel(")
_K2_CALL = ("      r.template intersect_f4<kUnroll>(s_rows + s * "
            "stage_floats, cs,\n" + " " * 39
            + "list[1 + k] * cs, best_t, best_i);")

# Ray::intersect_f4 with U rows at a time in four passes: the rows'
# divisors, the U divisions, the barycentric tests, the fold in row order.
_ILP = '''template <int U, int LB>
__device__ __forceinline__ void intersect_ilp(const Ray<LB>& r,
                                              const float* rows, int n_rows,
                                              int base, float& best_t,
                                              int& best_i) {
  const float4* row4 = reinterpret_cast<const float4*>(rows);
  for (int t0 = 0; t0 < n_rows; t0 += U) {
    float num[U], den[U], tt[U];
    bool safe[U], ok[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float4 pl = row4[(t0 + j) * (kNR / 4)];
      const float nd = r.vx * pl.x + r.vy * pl.y + r.vz * pl.z;
      const float no = r.px * pl.x + r.py * pl.y + r.pz * pl.z + pl.w;
      safe[j] = fabsf(nd) > kSafeDen;
      num[j] = -no;
      den[j] = safe[j] ? nd : 1.0f;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) tt[j] = num[j] / den[j];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float4 au = row4[(t0 + j) * (kNR / 4) + 1];
      const float4 av = row4[(t0 + j) * (kNR / 4) + 2];
      const float val = row4[(t0 + j) * (kNR / 4) + 3].w;
      const float ou = r.px * au.x + r.py * au.y + r.pz * au.z + au.w;
      const float du = r.vx * au.x + r.vy * au.y + r.vz * au.z;
      const float u = ou + tt[j] * du;
      const float ov = r.px * av.x + r.py * av.y + r.pz * av.z + av.w;
      const float dv = r.vx * av.x + r.vy * av.y + r.vz * av.z;
      const float v = ov + tt[j] * dv;
      ok[j] = safe[j] && tt[j] > kTMin && u >= -kBaryEps &&
              v >= -kBaryEps && u + v <= 1.0f + kBaryEps && val > 0.f;
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (ok[j] && tt[j] < best_t) {
        best_t = tt[j];
        best_i = base + t0 + j;
      }
  }
}

'''

_K5_SUPER = '''        if (!__any_sync(kFull,
                        slab.entry(s_sup[2 * g], s_sup[2 * g + 1]) !=
                            kInfBits))
          continue;
'''
_K5_CALL = ("        r.template intersect_f4<kUnroll>(s_rows, cs, c * cs, "
            "best_t, best_i);")
_K5_PASS2 = "    // Pass 2: the reached clusters' keys"
_K5_VISITS = "    // Visit the sorted list front to back."
_K5_VISITS_END = "    n_visits += k;\n"
_K5_TAIL = "    r.finish_bounce(running, can_cont, best_t, best_i, rows, sc, "
# The visits with the rows of the next `stages` clusters in flight (K2's
# ring); copies the stop test leaves unused are waited for at the end.
_K5_RING = '''    float best_t = CUDART_INF_F;
    int best_i = -1;
    const int first = min(stages, n_reached);
    if (tid == 0)
      for (int k = 0; k < first; ++k) {
        const unsigned q = seq + k;
        bulk_load(s_rows + (q % stages) * stage_floats,
                  rows + (long long)(unsigned)s_key[k] * stage_floats,
                  stage_bytes, &s_ring_full[q % stages]);
      }
    int k = 0;
    for (; k < n_reached; ++k) {
      const unsigned long long key = s_key[k];
      const float tn_k = __uint_as_float((unsigned)(key >> 32));
      if (!__syncthreads_or(alive && tn_k < best_t)) break;
      const int refill = k - 1 + stages;
      if (tid == 0 && k >= 1 && refill < n_reached) {
        const unsigned q = seq + refill;
        bulk_load(s_rows + (q % stages) * stage_floats,
                  rows + (long long)(unsigned)s_key[refill] * stage_floats,
                  stage_bytes, &s_ring_full[q % stages]);
      }
      const unsigned q = seq + k;
      mbar_wait(&s_ring_full[q % stages], (q / stages) & 1u);
      const int c = (int)(unsigned)key;
      if (alive)
        r.template intersect_f4<kUnroll>(s_rows + (q % stages) * stage_floats,
                                         cs, c * cs, best_t, best_i);
    }
    n_visits += k;
    const int issued = k == 0 ? first : min(n_reached, stages + k - 1);
    for (int m = k; m < issued; ++m) {
      const unsigned q = seq + m;
      mbar_wait(&s_ring_full[q % stages], (q / stages) & 1u);
    }
    seq += issued;
'''
# The parent's pass 2 over this tree's keys (entry bits, id) per cluster.
_K5_RESCAN = '''    float best_t = CUDART_INF_F;
    int best_i = -1;
    __shared__ unsigned long long s_wkey[kWarps];
    __shared__ unsigned s_far[kWarps];
    while (true) {
      __syncthreads();
      unsigned long long key = ~0ull;
      for (int c = tid; c < n_clusters; c += kThreads)
        key = s_key[c] < key ? s_key[c] : key;
      for (int off = 16; off; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, key, off);
        key = o < key ? o : key;
      }
      const unsigned far =
          __reduce_max_sync(kFull, alive ? __float_as_uint(best_t) : 0u);
      if (lane == 0) {
        s_wkey[warp] = key;
        s_far[warp] = far;
      }
      __syncthreads();
      unsigned long long kmin = s_wkey[0];
      unsigned fmax = s_far[0];
      for (int w = 1; w < kWarps; ++w) {
        kmin = s_wkey[w] < kmin ? s_wkey[w] : kmin;
        fmax = s_far[w] > fmax ? s_far[w] : fmax;
      }
      const float tn_k = __uint_as_float((unsigned)(kmin >> 32));
      if (!(tn_k < __uint_as_float(fmax))) break;
      const int c = (int)(kmin & 0xffffffffu);
      for (int k = tid; k < cs * kNR; k += kThreads)
        s_rows[k] = rows[(long long)c * cs * kNR + k];
      if (tid == 0) s_key[c] = ((unsigned long long)kInfBits << 32) | c;
      __syncthreads();
      if (alive) r.intersect(s_rows, cs, c * cs, best_t, best_i);
      ++n_visits;
    }
'''


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"variant: {old[:60]!r} not found in the source")
    return src.replace(old, new)


def _with_header(tree: str, header: str) -> str:
    """``tree`` with ``header`` (trace_common.cuh's text, edited) in place of
    its include: a variant of what the header holds, for this source only."""
    return _replace(tree, '#include "trace_common.cuh"\n',
                    _replace(header, "#pragma once\n", ""))


def k1_variants(tree: str, header: str) -> dict[str, str]:
    """Variants of trace_round.cu (and of the ray hand-out it takes from
    trace_common.cuh, ``header``). K7 is the same kernels over its own
    layouts, so each variant changes K7 as it changes K1."""
    twice = "      if (can_cont) {\n" + _K1_CALL + '''
        float bt2 = CUDART_INF_F;
        int bi2 = -1;
        r.template intersect_f4<kUnroll>(s_rows, n_test, 0, bt2, bi2);
        if (bt2 < 0.f) best_i = bi2;  // never: the second result unused
      }'''
    return {
        "tree_scalar": _replace(tree, _K1_CALL,
                                "        r.intersect(s_rows, n_test, 0, "
                                "best_t, best_i);"),
        "tree_unroll1": _replace(tree, "constexpr int kUnroll = 4;",
                                 "constexpr int kUnroll = 1;"),
        "tree_ilp": _replace(_replace(tree, _K1_KERNEL, _ILP + _K1_KERNEL),
                             _K1_CALL, "        intersect_ilp<kUnroll>(r, "
                             "s_rows, n_test, 0, best_t, best_i);"),
        "tree_all_rows": _replace(
            tree, "  const int n_test = padded_rows(s_last + 1);",
            "  const int n_test = padded_rows(lay.n_tris);"),
        "tree_global_tail": _replace(tree, "  const RowAttrs staged{s_rows};",
                                     "  const auto staged = lay.attrs();"),
        "tree_grid_all": _replace(tree, _K1_PERSIST,
                                  "  const bool persist = false && resident "
                                  "< want;"),
        "tree_persist_all": _replace(tree, _K1_PERSIST,
                                     "  const bool persist = resident < "
                                     "want;"),
        "tree_chunk32": _replace(tree, "max_bounces, persist ? 3 : 5);",
                                 "max_bounces, 5);"),
        "tree_refill8": _with_header(tree, _replace(
            header, "      if (need == 0u) break;",
            "      if (need == 0u || (__popc(need) < 8 && need != kAllLanes))"
            " break;")),
        "tree_lb8": _replace(tree, _K1_KERNEL, _K1_KERNEL.replace(
            "(kThreads)", "(kThreads, 8)")),
        "tree_2x": _replace(tree, "      if (can_cont)\n" + _K1_CALL, twice),
    }


def k5_variants(tree: str) -> dict[str, str]:
    start = tree.index(_K5_PASS2)
    end = tree.index(_K5_TAIL)
    bounds = {k: _replace(tree, _K5_KERNEL, _K5_KERNEL.replace(
        "(kThreads)", f"(kThreads, {k})")) for k in (6, 8)}

    def ring(stages: int) -> str:
        src = tree[:tree.index(_K5_VISITS)] + _K5_RING + tree[
            tree.index(_K5_VISITS_END) + len(_K5_VISITS_END):]
        for old, new in (
                ("  __shared__ uint64_t s_full;",
                 f"  __shared__ uint64_t s_ring_full[{stages}];\n"
                 f"  const int stages = {stages};"),
                ("  float4* s_sup = (float4*)(s_rows + stage_floats);",
                 "  float4* s_sup = (float4*)(s_rows + stages * "
                 "stage_floats);"),
                ("    mbar_init(&s_full, 1);",
                 "    for (int s = 0; s < stages; ++s) "
                 "mbar_init(&s_ring_full[s], 1);"),
                ("  uint32_t phase = 0;  // parity of the rows barrier's "
                 "current phase", "  unsigned seq = 0;"),
                ("  return sizeof(float) * kNR * (size_t)cs + 32 * groups +",
                 f"  return {stages} * sizeof(float) * kNR * (size_t)cs + "
                 "32 * groups +")):
            src = _replace(src, old, new)
        return src

    return {
        "tree_all_pairs": _replace(tree, _K5_SUPER, ""),
        "tree_rescan": tree[:start] + _K5_RESCAN + tree[end:],
        "tree_ring2": ring(2),
        "tree_ring4": ring(4),
        "tree_lb6": bounds[6],
        "tree_lb8": bounds[8],
        "tree_scalar": _replace(tree, _K5_CALL,
                                "        r.intersect(s_rows, cs, c * cs, "
                                "best_t, best_i);"),
    }


def k2_variants(tree: str) -> dict[str, str]:
    return {"tree_ilp": _replace(
        _replace(tree, _K2_KERNEL, _ILP + _K2_KERNEL), _K2_CALL,
        "      intersect_ilp<4>(r, s_rows + s * stage_floats, cs, "
        "list[1 + k] * cs, best_t, best_i);")}


_K6_HIGH = """    if (HIGH) {
      if (__any_sync(kFull, can_cont)) {
        float bt[4] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                       CUDART_INF_F};
        int bi[4] = {-1, -1, -1, -1};
        uint32_t a[2][4];
        put_ray(s_a, lane, r, can_cont);
        get_a(s_a, lane, a);
        search_mma(s_tab, s_valid, n_test, 0, a, lane, bt, bi);
        own_hit(bt, bi, lane, best_t, best_i);
      }
    } else if (can_cont) {"""
_K6_KERNEL = "// ---------------------------------------------------------------- kernels"
_K6_KERNEL_BOUNDS = ("__global__ void __launch_bounds__(kBlock, 2)\n"
                     "trace_group_kernel(")
_K6_TEST4 = "  bool safe[4], exact = true;"
_K6_DIV_FAST = ("    tt[j] = div_fast(num[j], den[j]);\n"
                "    exact = exact & div_fast_exact(num[j], den[j]);\n")
_K6_HIGHEST = "// ---------------------------------------------------------------- HIGHEST"
# test4's body replaced by a fold of each candidate's quantities: what the
# search costs without K1's test (a probe: its hits are not the function's)
_K6_NO_TEST = """#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float s = q[0][j] + q[1][j] + q[2][j] + q[3][j] + q[4][j] + q[5][j];
    if (s < bt[r[j]]) {
      bt[r[j]] = s;
      bi[r[j]] = tri[j];
    }
  }
}

"""
# "high" on the FP32 units: the 20 terms in the plain version's order (so
# its bits), the coefficients read from the B fragments (a triangle's 8
# words of a quantity as two uint4).
_K6_FP32_HIGH = """__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float quantity_high(const uint4* f,
                                               const float (&ph)[6],
                                               const float (&pl)[6]) {
  const uint4 x = f[0], y = f[1];
  const float ch[7] = {bf_lo(x.x), bf_hi(x.x), bf_lo(x.z), bf_hi(x.z),
                       bf_lo(y.x), bf_hi(y.x), bf_lo(y.z)};
  const float cl[7] = {bf_lo(x.y), bf_hi(x.y), bf_lo(x.w), bf_hi(x.w),
                       bf_lo(y.y), bf_hi(y.y), bf_lo(y.w)};
  float a = ch[0] * ph[0], b = ch[0] * pl[0], c = cl[0] * ph[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    a = a + ch[k] * ph[k];
    b = b + ch[k] * pl[k];
    c = c + cl[k] * ph[k];
  }
  return (a + ch[6] + b) + (c + cl[6]);
}
template <int LB>
__device__ __forceinline__ void search_f32_high(const Ray<LB>& r,
                                                const uint32_t* s_tab,
                                                const float* s_valid,
                                                int groups, float& best_t,
                                                int& best_i) {
  const float p[6] = {r.px, r.py, r.pz, r.vx, r.vy, r.vz};
  float ph[6], pl[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    ph[k] = bf16_round(p[k]);
    pl[k] = bf16_round(p[k] - ph[k]);
  }
  const uint4* f = reinterpret_cast<const uint4*>(s_tab);
  const int same[4] = {0, 0, 0, 0};
  for (int t0 = 0; t0 < groups * kGroup; t0 += 4) {
    float q[kNQ][4], valid[4];
    int tri[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j;
      const uint4* row = f + (t >> 3) * kNQ * 16 + 2 * (t & 7);
#pragma unroll
      for (int k = 0; k < kNQ; ++k)
        q[k][j] = quantity_high(row + 16 * k, ph, pl);
      valid[j] = s_valid[t];
      tri[j] = t;
    }
    test4(q, valid, tri, same, &best_t, &best_i);
  }
}

"""


def k6_variants(tree: str) -> dict[str, str]:
    """Variants of trace_group.cu, each undoing one lever of K6's
    redesign."""
    return {
        "tree_unfolded": _replace(tree, "  return acc + b.z;\n",
                                  "  acc = acc + b.z * 1.0f;\n"
                                  "  return acc + b.w * 0.0f;\n"),
        "tree_scalar": _replace(
            tree, "  const float4 a = row[0], b = row[1];\n",
            "  const volatile float* f = reinterpret_cast<const float*>(row);"
            "\n  const float4 a = make_float4(f[0], f[1], f[2], f[3]);\n"
            "  const float4 b = make_float4(f[4], f[5], f[6], f[7]);\n"),
        "tree_chunk16": _replace(tree, "constexpr int kMaxGroups = 64;",
                                 "constexpr int kMaxGroups = 16;"),
        "tree_grid_all": _replace(
            tree, "  const bool persist = budget > kPersistBudget && "
            "resident < want;",
            "  const bool persist = false && resident < want;"),
        "tree_div_each": _replace(tree, _K6_DIV_FAST,
                                  "    tt[j] = num[j] / den[j];\n"),
        "tree_highest_lb3": _replace(
            tree, _K6_KERNEL_BOUNDS,
            _K6_KERNEL_BOUNDS.replace("(kBlock, 2)", "(kBlock, HIGH ? 2 : 3)")),
        "tree_lb3": _replace(tree, _K6_KERNEL_BOUNDS, _K6_KERNEL_BOUNDS.replace(
            "(kBlock, 2)", "(kBlock, 3)")),
        # probes: not the kernel's function, timed only
        "probe_approx_div": _replace(
            tree, _K6_DIV_FAST, "    tt[j] = __fdividef(num[j], den[j]);\n"),
        "probe_no_test": tree[:tree.index(_K6_TEST4)] + _K6_NO_TEST
        + tree[tree.index(_K6_HIGHEST):],
        "tree_fp32_high": _replace(_replace(
            tree, _K6_KERNEL, _K6_FP32_HIGH + _K6_KERNEL), _K6_HIGH,
            "    if (HIGH && can_cont) {\n"
            "      search_f32_high(r, s_tab, s_valid, n_test, best_t, "
            "best_i);\n    } else if (!HIGH && can_cont) {"),
    }


def build_variants(build, sources: dict[str, str], csrc: Path,
                   out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile each variant (one source) into its own library, side by
    side; give every C entry point it exports its signature."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-shared",
             "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        (out_dir / f"{name}.log").write_text(log)
        libs[name] = _bind(build, ctypes.CDLL(str(out_dir / f"lib{name}.so")))
    return libs


def _bind(build, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """The ptxas lines (registers, spills) of the kernels named ``kernel``."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("registers" in line or "spill" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return lines


# ------------------------------------------------------------------ timing

def time_libs(libs: dict, call, state: torch.Tensor, plain: torch.Tensor,
              check=True, ray_dim: int = 1) -> dict[str, list[float]]:
    """Every library's output against ``plain`` bit for bit (``check``;
    rays along ``ray_dim``), then its CUDA-event median in a forward and a
    reverse pass."""
    for who, lib in libs.items():
        if check:
            got = call(lib, state.clone())
            torch.cuda.synchronize()
            n_diff = int((got != plain).any(dim=1 - ray_dim).sum())
            assert n_diff == 0, f"{who}: {n_diff} rays differ from plain"
    times: dict[str, list[float]] = {}
    order = list(libs.items())
    for pass_order in (order, order[::-1]):
        for who, lib in pass_order:
            times.setdefault(who, []).append(median_ms(
                lambda s, lib=lib: call(lib, s), 7,
                setup=lambda: (state.clone(),)))
    return times


def bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3


def round_work(before: torch.Tensor, after: torch.Tensor):
    """(ray-bounces that searched the rows, lane use of one ray a thread)."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    b = (after[rc._C_DEPTH] - before[rc._C_DEPTH]).double()
    b += ((after[rc._C_DONE] != 0) & (before[rc._C_DONE] == 0)).double()
    warps = b[: b.numel() // 32 * 32].view(-1, 32)
    use = float(warps.sum() / (32 * warps.amax(dim=1)).sum())
    return int(b.sum()), use


def unit_dirs(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------ phases

def k1_phase(libs, n: int) -> dict:
    from audiorenderingv2_tpu_torch import constants, testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scene = testing.scene_from_arrays(*testing.box_room(ROOM), ABSORPTION)
    rows = rc.pack_tris_rows(tracer.scene_to_arrays(scene, device=dev))
    n_valid = int((rows[:, rc._R_VAL] > 0).sum())
    params = TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                         base_power=3.62, max_bounces=MAX_BOUNCES,
                         hrtf_absorption_rate=0.9)
    emitter = torch.zeros(3, device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(torch.from_numpy(unit_dirs(n, 11)).to(dev),
                          emitter, e0, -(-n // 128) * 128)
    scal = rc.scalars(emitter, torch.tensor(RECEIVER, device=dev), 30.0, e0,
                      params)
    out = {}
    for k, budget in enumerate(tuned.round_budgets_for(MAX_BOUNCES)):
        def call(lib, s, budget=budget):
            err = lib.ar2_trace_round(
                s.data_ptr(), s.shape[1], s.shape[0], rows.data_ptr(),
                rows.shape[0], scal.data_ptr(), 1, s.shape[1], 1, 1, budget,
                params.max_bounces, stream)
            assert err == 0, err
            return s

        plain = rc.trace_round_plain(state.clone(), rows, scal, params,
                                     budget)
        tests, use = round_work(state, plain)
        times = time_libs(libs, call, state, plain)
        row = {"budget": budget,
               "alive_before": int((state[rc._C_DONE] == 0).sum()),
               "tests": tests * n_valid, "valid_rows": n_valid,
               "lane_use_one_ray_a_thread": use,
               "bound_ms": bound_ms(2 * state.numel() * 4
                                    + (rows.numel() + scal.numel()) * 4,
                                    tests * n_valid * TRI_TEST_OPS),
               "ms": times}
        out[f"round{k + 1}"] = row
        print(f"K1 round {k + 1} ({budget} bounces, {row['alive_before']} "
              f"alive): {row['tests']:.4g} tests, bound "
              f"{row['bound_ms']:.4f} ms, lane use {use:.3f}; " + "; ".join(
                  f"{w} {v[0]:.3f}/{v[1]:.3f}" for w, v in times.items()),
              flush=True)
        state = rc._partition_alive_first(plain)
    return out


def k1_pose_phase(libs, n: int) -> dict:
    from audiorenderingv2_tpu_torch import constants, testing
    from audiorenderingv2_tpu_torch.core import sampling, tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    p, n_pad = 8, -(-n // 128) * 128
    scene = testing.scene_from_arrays(*testing.box_room(MULTI_ROOM),
                                      MULTI_ABSORPTION)
    rows = rc.pack_tris_rows(tracer.scene_to_arrays(scene, 128, device=dev))
    n_valid = int((rows[:, rc._R_VAL] > 0).sum())
    params = TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                         base_power=3.62, max_bounces=MULTI_BOUNCES,
                         hrtf_absorption_rate=0.9)
    em = torch.from_numpy(np.repeat(MULTI_EMITTERS, 4, axis=0)).to(dev)
    rcv = torch.from_numpy(np.tile(MULTI_LISTENERS, (2, 1))).to(dev)
    yaw = torch.from_numpy(np.tile(MULTI_YAWS, 2)).to(dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    dirs = torch.stack([sampling.sample_directions(
        n, sampling.pose_generator(0, i, dev), dev) for i in range(p)])
    state = rc.init_state(dirs, em, e0, n_pad)
    scal = rc.scalars(em, rcv, yaw, e0, params)
    out = {}
    for k, budget in enumerate(MULTI_BUDGETS):
        def call(lib, s, budget=budget):
            err = lib.ar2_trace_round(
                s.data_ptr(), s.shape[1], s.shape[0], rows.data_ptr(),
                rows.shape[0], scal.data_ptr(), p, n_pad, 1, 1, budget,
                params.max_bounces, stream)
            assert err == 0, err
            return s

        plain = rc.trace_round_plain(state.clone(), rows, scal, params,
                                     budget, n_pad)
        tests, use = round_work(state, plain)
        times = time_libs(libs, call, state, plain)
        row = {"budget": budget, "tests": tests * n_valid,
               "lane_use_one_ray_a_thread": use,
               "bound_ms": bound_ms(2 * state.numel() * 4
                                    + (rows.numel() + scal.numel()) * 4,
                                    tests * n_valid * TRI_TEST_OPS),
               "ms": times}
        out[f"round{k + 1}"] = row
        print(f"K1-pose round {k + 1} ({budget} bounces, {p} x {n_pad} "
              f"rays): bound {row['bound_ms']:.4f} ms, lane use {use:.3f}; "
              + "; ".join(f"{w} {v[0]:.3f}/{v[1]:.3f}"
                          for w, v in times.items()), flush=True)
        state = rc._partition_alive_first(plain, p)
    return out


def k7_phase(libs, n: int) -> dict:
    """K7 of every library against its plain version, bit for bit, and K1
    (this tree's) on the same state: the box through the version-1
    schedule's rounds (6, 12, 24, 58) with the row partition between them,
    the icosphere of 320 triangles padded to 512 columns (rounds 1-2), and
    the 1,280-triangle icosphere (the multi-chunk branch, round 1, 65,536
    rays)."""
    from audiorenderingv2_tpu_torch import constants, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import v1_cuda

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    params = TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                         base_power=3.62, max_bounces=MAX_BOUNCES,
                         hrtf_absorption_rate=0.9)
    emitter = torch.zeros(3, device=dev)
    ico = testing.icosphere(radius=6.0, subdivisions=2)
    out = {}
    for name, mesh, pad_to, rays, budgets in (
            ("box", testing.box_room(ROOM), None, n,
             rc._round_schedule(MAX_BOUNCES)),
            ("ico512", ico, 512, n, (6, 12)),
            ("ico1280", testing.icosphere(radius=6.0, subdivisions=3), None,
             65536, (6,))):
        sc = tracer.scene_to_arrays(testing.scene_from_arrays(
            *mesh, ABSORPTION), 128, device=dev)
        if pad_to is not None:
            extra = pad_to - sc.valid.shape[0]
            sc = sc._replace(**{
                k: torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
                for k, x in sc._asdict().items() if x is not None})
        tris = rc.pack_tris_v1(sc)
        rows = rc.pack_tris_rows(sc)
        n_valid = int((tris[16] > 0).sum())
        e0 = params.base_power / (rays * constants.SPHERE_VOLUME)
        scal = rc.scalars(emitter, torch.tensor(RECEIVER, device=dev), 30.0,
                          e0, params)
        state = rc.init_state(torch.from_numpy(unit_dirs(rays, 11)).to(dev),
                              emitter, e0, -(-rays // 128) * 128)
        state_rows = state.T.contiguous()
        for k, budget in enumerate(budgets):
            def call(lib, s, budget=budget):
                err = lib.ar2_trace_round_v1(
                    s.data_ptr(), s.shape[0], tris.data_ptr(), tris.shape[1],
                    scal.data_ptr(), budget, params.max_bounces, stream)
                assert err == 0, err
                return s

            plain = v1_cuda.trace_round_v1_plain(state_rows.clone(), tris,
                                                 scal, params, budget)
            tests, use = round_work(state, plain.T)
            times = time_libs(libs, call, state_rows, plain, ray_dim=0)
            k1_ms = median_ms(lambda s: rc.trace_round(s, rows, scal, params,
                                                       budget), 7,
                              setup=lambda: (state.clone(),))
            row = {"columns": tris.shape[1], "valid": n_valid,
                   "budget": budget, "rays": state.shape[1],
                   "alive_before": int((state[rc._C_DONE] == 0).sum()),
                   "tests": tests * n_valid,
                   "lane_use_one_ray_a_thread": use,
                   "branch": v1_cuda.v1_branch(tris.shape[1]),
                   "bound_ms": bound_ms(2 * state.numel() * 4
                                        + (tris.numel() + scal.numel()) * 4,
                                        tests * n_valid * TRI_TEST_OPS),
                   "k1_ms": k1_ms, "ms": times}
            out[f"{name}_round{k + 1}"] = row
            print(f"K7 {name} round {k + 1} ({budget} bounces, "
                  f"{row['alive_before']} alive, {tris.shape[1]} columns, "
                  f"{n_valid} valid): {row['tests']:.4g} tests, bound "
                  f"{row['bound_ms']:.4f} ms, lane use {use:.3f}; K1 "
                  f"{k1_ms:.3f}; " + "; ".join(
                      f"{w} {v[0]:.3f}/{v[1]:.3f}" for w, v in times.items()),
                  flush=True)
            state_rows = rc._partition_alive_first(plain, ray_dim=0)
            state = state_rows.T.contiguous()
    return out


K6_PROBES = ("probe_approx_div", "probe_no_test")
K6_VARIANTS = {"highest": ("tree_unfolded", "tree_scalar", "tree_chunk16",
                           "tree_grid_all", "tree_div_each",
                           "tree_highest_lb3", *K6_PROBES),
               "high": ("tree_chunk16", "tree_grid_all", "tree_div_each",
                        "tree_lb3", "tree_fp32_high", *K6_PROBES)}


def k6_phase(libs, n: int) -> dict:
    """K6 of both checkouts and of the variants at both precisions: the box
    through the group route's rounds (6, 12, 24, 58, the row partition
    between them) at 1 and 4 bands, its 8-bounce round from the start
    state, the 320-triangle icosphere (40 groups, 8 bounces) and the
    multi-pose demo's box (8 poses x 1,000,064 rays, 8 bounces). "highest"
    bit for bit against its plain version; "high" on chip_smoke.py's bar
    (the FP32 variant bit for bit); K1 on the same state beside each."""
    import chip_smoke as cs
    from audiorenderingv2_tpu_torch import constants, testing
    from audiorenderingv2_tpu_torch.core import sampling, tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import group_cuda as gc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    def run(name, state, scal, params, packed, rows, budget, n_poses=1):
        coeffs, attrs = packed
        frags = gc.b_fragments(coeffs)
        rpp = state.shape[1] // n_poses
        n_valid = int((attrs[:, 3 + params.n_bands] > 0).sum())
        row = {"budget": budget, "rays": state.shape[1],
               "alive_before": int((state[rc._C_DONE] == 0).sum())}
        k1 = rc.trace_round(state.clone(), rows, scal, params, budget, rpp)
        row["k1_ms"] = median_ms(lambda s: rc.trace_round(
            s, rows, scal, params, budget, rpp), 7,
            setup=lambda: (state.clone(),))
        searches = cs.round_tests(state, k1)
        row["bound_ms"] = bound_ms(0, searches * n_valid * TRI_TEST_OPS)
        row["high_bound_ms"] = cs._group_bound("high", 0, searches
                                               * n_valid)["bound_ms"]
        for precision, keep in K6_VARIANTS.items():
            high = precision == "high"
            plain = gc.trace_round_group_plain(state.clone(), coeffs, attrs,
                                               scal, params, budget, rpp,
                                               precision)
            these = {w: lib for w, lib in libs.items()
                     if w in ("parent", "tree") or w in keep}

            def call(who, lib, s):
                table = frags if high and who != "parent" else coeffs
                err = lib.ar2_trace_group(
                    s.data_ptr(), s.shape[1], s.shape[0], table.data_ptr(),
                    attrs.data_ptr(), coeffs.shape[0] // 48, attrs.shape[1],
                    scal.data_ptr(), n_poses, rpp, params.n_bands,
                    rc.layout_bands(params.n_bands), budget,
                    params.max_bounces, int(high), stream)
                assert err == 0, err
                return s

            checks = {}
            for who, lib in these.items():
                got = call(who, lib, state.clone())
                torch.cuda.synchronize()
                n_diff = int((got != plain).any(dim=0).sum())
                if who in K6_PROBES:
                    checks[who] = f"probe: {n_diff} rays differ"
                elif high and who != "tree_fp32_high":
                    checks[who] = cs.assert_high_bar(got, plain,
                                                     f"{name} {who}", k1,
                                                     budget)
                else:
                    assert n_diff == 0, f"{name} {precision} {who}: {n_diff}"
                    checks[who] = "bit-identical"
            times: dict[str, list[float]] = {}
            order = list(these.items())
            for pass_order in (order, order[::-1]):
                for who, lib in pass_order:
                    times.setdefault(who, []).append(median_ms(
                        lambda s, who=who, lib=lib: call(who, lib, s), 7,
                        setup=lambda: (state.clone(),)))
            row[precision] = {"ms": times, "checks": checks}
            print(f"K6 {precision} {name} ({budget} bounces, "
                  f"{row['alive_before']} alive): K1 {row['k1_ms']:.3f}, "
                  f"bound {row['bound_ms' if not high else 'high_bound_ms']:.4f}"
                  "; " + "; ".join(f"{w} {v[0]:.3f}/{v[1]:.3f}"
                                   for w, v in times.items()), flush=True)
        out[name] = row
        return k1

    emitter = torch.zeros(3, device=dev)
    receiver = torch.tensor(RECEIVER, device=dev)
    for n_bands in (1, 4):
        params = TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                             base_power=3.62, max_bounces=MAX_BOUNCES,
                             hrtf_absorption_rate=0.9, n_bands=n_bands)
        for mesh_name, mesh in (("box", testing.box_room(ROOM)),
                                ("ico", testing.icosphere(6.0, 2))):
            if mesh_name == "ico" and n_bands > 1:
                continue
            sc = cs._scene_arrays(mesh, n_bands)
            packed = rc.pack_tris_group(sc, n_bands)
            rows = rc.pack_tris_rows(sc, n_bands)
            e0 = params.base_power / (n * constants.SPHERE_VOLUME)
            scal = rc.scalars(emitter, receiver, 30.0, e0, params)
            start = rc.init_state(torch.from_numpy(unit_dirs(n, 11)).to(dev),
                                  emitter, e0, -(-n // 128) * 128, n_bands)
            run(f"{mesh_name}_{n_bands}b_round8", start, scal, params, packed,
                rows, 8)
            if mesh_name == "ico":
                continue
            state = start
            for budget in rc._round_schedule(MAX_BOUNCES):
                k1 = run(f"box_{n_bands}b_budget{budget}", state, scal,
                         params, packed, rows, budget)
                state = rc._partition_alive_first(k1)
    # the multi-pose demo's box, 8 poses
    p, n_pad = 8, -(-n // 128) * 128
    params = TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                         base_power=3.62, max_bounces=MULTI_BOUNCES,
                         hrtf_absorption_rate=0.9)
    sc = tracer.scene_to_arrays(testing.scene_from_arrays(
        *testing.box_room(MULTI_ROOM), MULTI_ABSORPTION), 128, device=dev)
    em = torch.from_numpy(np.repeat(MULTI_EMITTERS, 4, axis=0)).to(dev)
    rcv = torch.from_numpy(np.tile(MULTI_LISTENERS, (2, 1))).to(dev)
    yaw = torch.from_numpy(np.tile(MULTI_YAWS, 2)).to(dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    dirs = torch.stack([sampling.sample_directions(
        n, sampling.pose_generator(0, i, dev), dev) for i in range(p)])
    run("posed_round8", rc.init_state(dirs, em, e0, n_pad),
        rc.scalars(em, rcv, yaw, e0, params), params, rc.pack_tris_group(sc),
        rc.pack_tris_rows(sc), 8, n_poses=p)
    return out


def _office(cs: int, dev):
    from audiorenderingv2_tpu_torch import accel, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    sorted_scene, clusters = accel.prepare_scene(
        testing.office_scene(OFFICE_TRIS), cluster_size=cs)
    return rc.pack_tris_clusters(tracer.scene_to_arrays(
        sorted_scene, 128, device=dev, clusters=clusters))


def _office_params():
    from audiorenderingv2_tpu_torch.core.params import TraceParams

    return TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                       base_power=3.62, max_bounces=OFFICE_BOUNCES,
                       hrtf_absorption_rate=0.9)


def k5_phase(libs, n: int) -> dict:
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    params = _office_params()
    emitter = torch.zeros(3, device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    scal = rc.scalars(emitter, torch.tensor(OFFICE_RECEIVER, device=dev),
                      0.0, e0, params)
    out = {}
    for cs in (32, 128):
        rows, boxes = _office(cs, dev)
        c = boxes.shape[0]
        state = rc.init_state(torch.from_numpy(unit_dirs(n, 18)).to(dev),
                              emitter, e0, -(-n // 128) * 128)
        for name in ("start", "after1"):
            visits = torch.zeros(state.shape[1] // 128, dtype=torch.int32,
                                 device=dev)

            def call(lib, s, v=None):
                err = lib.ar2_trace_traverse(
                    s.data_ptr(), s.shape[1], s.shape[0], rows.data_ptr(), cs,
                    boxes.data_ptr(), c, scal.data_ptr(), 1, s.shape[1], 1,
                    1, 1, params.max_bounces,
                    None if v is None else v.data_ptr(), stream)
                assert err == 0, err
                return s

            plain = tc.trace_traverse_plain(state.clone(), rows, boxes, scal,
                                            params, 1, visits=visits)
            for who, lib in libs.items():
                v = torch.zeros_like(visits)
                call(lib, state.clone(), v)
                torch.cuda.synchronize()
                assert torch.equal(v, visits), f"K5 {who}: visits differ"
            times = time_libs(libs, call, state, plain)
            alive = (state[rc._C_DONE] == 0).view(-1, 128).sum(1).double()
            ops = (float(alive.sum()) * c * SLAB_TEST_OPS
                   + float((alive * visits.double()).sum()) * cs
                   * TRI_TEST_OPS)
            row = {"clusters": c, "visits_mean": float(
                visits.float().mean()), "visits_max": int(visits.max()),
                   "bound_ms": bound_ms(2 * state.numel() * 4
                                        + (rows.numel() + boxes.numel()
                                           + scal.numel()) * 4, ops),
                   "ms": times}
            out[f"cs{cs}_{name}"] = row
            print(f"K5 cs {cs} {name}: visits {row['visits_mean']:.2f} (max "
                  f"{row['visits_max']}), bound {row['bound_ms']:.4f} ms; "
                  + "; ".join(f"{w} {v[0]:.3f}/{v[1]:.3f}"
                              for w, v in times.items()), flush=True)
            state = rc._sort_state_by_keys(plain, rc._compaction_keys(plain))
    return out


def k2_phase(libs, n: int) -> dict:
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    params = _office_params()
    rows, boxes = _office(32, dev)
    emitter = torch.zeros(3, device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    scal = rc.scalars(emitter, torch.tensor(OFFICE_RECEIVER, device=dev),
                      0.0, e0, params)
    state = rc.init_state(torch.from_numpy(unit_dirs(n, 13)).to(dev),
                          emitter, e0, -(-n // 128) * 128)
    states = {"round1": state.clone()}
    for k in range(16):
        state = sc.trace_round_sched(state, rows, boxes,
                                     sc.tile_schedule(state, boxes), scal,
                                     params)
        state = rc._sort_state_by_keys(state, rc._compaction_keys(state))
        if k in (0, 15):
            states[f"after{k + 1}"] = state.clone()
    out = {}
    for name, st in states.items():
        sched = sc.tile_schedule_plain(st, boxes)

        def call(lib, s):
            call_k2(lib, s, rows, 32, boxes, sched, scal, params.max_bounces,
                    stream)
            return s

        plain = sc.trace_round_sched_plain(st.clone(), rows, boxes, sched,
                                           scal, params)
        times = time_libs(libs, call, st, plain)
        out[name] = {"ms": times}
        print(f"K2 {name}: " + "; ".join(
            f"{w} {v[0]:.3f}/{v[1]:.3f}" for w, v in times.items()),
            flush=True)
    return out


_RENDER = r'''
import sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from audiorenderingv2_tpu_torch import testing
from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
r = AudioRenderer(testing.office_scene(20000), 2, 16000, 1_000_000,
                  base_power=3.62, max_bounces=32, hrtf_absorption_rate=0.9,
                  opts=TracerOptions(), device="cuda")
r.set_emitter_pos((0.0, 0.0, 0.0))
r.set_receiver((6.0, 1.0, -8.0), 0.0)
assert r.rows.shape[0] // r.boxes.shape[0] == 128
r.render()
times = []
for _ in range(7):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ir = r.render()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
assert np.isfinite(ir).all() and ir.sum() > 0
print(float(np.median(times)), float(ir.sum()))
'''


def render_phase(parent: Path) -> dict:
    """The office render with explicit options, alone in a process of its
    own: other, this, this, other."""
    out: dict[str, list] = {}
    for who, root in (("parent", parent), ("tree", REPO), ("tree", REPO),
                      ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", _RENDER, str(root)],
                             capture_output=True, text=True, timeout=600,
                             cwd=str(root))
        if res.returncode:
            raise RuntimeError(f"render in {root} failed:\n{res.stderr}")
        ms, energy = map(float, res.stdout.split()[-2:])
        out.setdefault(who, []).append({"ms": ms, "energy": energy})
        print(f"office render, explicit options ({who}): {ms:.3f} ms "
              f"(median of 7, host clock), energy {energy:.6e}", flush=True)
    return out


_E2E = r"""
import contextlib, io, json, re, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from audiorenderingv2_tpu_torch import accel, cli, multi, testing
from audiorenderingv2_tpu_torch.core import tracer
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
from audiorenderingv2_tpu_torch.diff import replay
from audiorenderingv2_tpu_torch.io import wav
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
path, dev, n = sys.argv[2], sys.argv[3], int(sys.argv[4])

def sync():
    if dev == "cuda":
        torch.cuda.synchronize()

def median_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))

def renderer(scene, bounces, receiver, opts):
    r = AudioRenderer(scene, 2, 16000, n, base_power=3.62,
                      max_bounces=bounces, hrtf_absorption_rate=0.9,
                      opts=opts, device=dev)
    r.set_emitter_pos((0.0, 0.0, 0.0))
    r.set_receiver(receiver, 0.0)
    return r

def experimentation(flags):
    # The CLI's experimentation mode on the box config, --rounds 10: its
    # median render (ms) as it prints it.
    side = round(n ** (1 / 3))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        testing.write_box_obj(tmp / "room.obj", (14.0, 9.0, 11.0),
                              material="walls")
        t = np.arange(5 * 16000) / 16000
        wav.write_wav(tmp / "dry.wav", (0.3 * np.sin(2 * np.pi * 300 * t))
                      [None, :].astype(np.float32), 16000)
        cfg = {
            "renderer_parameters": {"ir_length_in_seconds": 2},
            "scene_parameters": {
                "mono": False, "audio_file_path": "dry.wav",
                "scene_file_path": "room.obj",
                "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0},
                "initial_receiver_pos": {"x": 2.5, "y": 1.5, "z": 2.0}},
            "pathtracer_parameters": {
                "base_power": 3.62, "rays": {"x": side, "y": side,
                                             "z": side},
                "ray_energy_threshold": 0.0, "ray_max_bounces": 100,
                "hrtf_absorption_rate": 0.9,
                "materials": [{"name": "walls", "mat_absorption": 0.3}]}}
        (tmp / "config.json").write_text(json.dumps(cfg))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main([str(tmp / "config.json"), "experimentation",
                             "--rounds", "10", "--device", dev, *flags])
    assert code == 0, out.getvalue()
    return float(re.search(r"median render time: ([0-9.]+) ms",
                           out.getvalue()).group(1))

def matrix_2x4():
    demo = testing.scene_from_arrays(*testing.box_room((18.0, 10.0, 14.0)),
                                     0.25)
    sc = tracer.scene_to_arrays(demo, 128, device=dev)
    rows, _ = rc.pack_scene(sc, 1)
    params = TraceParams(sample_rate=16000, ir_length=32000,
                         base_power=3.62, max_bounces=40,
                         hrtf_absorption_rate=0.9)
    em = np.array([[-5.0, 0.0, -4.0], [6.0, 1.0, 5.0]], np.float32)
    li = np.stack([np.linspace(-6.0, 6.0, 4), np.zeros(4),
                   np.linspace(4.0, -4.0, 4)], axis=1).astype(np.float32)
    yaw = np.linspace(0.0, 270.0, 4).astype(np.float32)
    return median_ms(lambda: multi.render_ir_matrix(
        sc, 0, em, li, yaw, n, params, TracerOptions(round_budgets=(8, 32)),
        pair_batch=8, rows=rows), 5)

def record(opts):
    office = testing.office_scene(20000)
    ss, cl = accel.prepare_scene(office, cluster_size=32)
    scc = tracer.scene_to_arrays(ss, 128, device=dev, clusters=cl)
    crows, cboxes = rc.pack_tris_clusters(scc)
    d = np.random.default_rng(0).normal(size=(n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                         .astype(np.float32)).to(dev)
    rparams = TraceParams(sample_rate=16000, ir_length=32000,
                          base_power=3.62, max_bounces=32,
                          energy_threshold=0.0)
    return median_ms(lambda: replay.record_paths_kernels(
        scc, d, (0.0, 0.0, 0.0), (6.0, 1.0, -8.0), 0.0, rparams, opts,
        rows=crows, boxes=cboxes), 3)

def replay_step(grad):
    # The gradient step's replay (chip_smoke.py phase 16): paths recorded
    # once (office, schedule), then the hard-binning replay of them, under
    # no_grad (median of 7) or with the backward of an MSE (median of 5).
    from audiorenderingv2_tpu_torch.diff.inverse import \
        with_material_absorption
    office = testing.office_scene(20000)
    ss, cl = accel.prepare_scene(office, cluster_size=32)
    scc = tracer.scene_to_arrays(ss, 128, device=dev, clusters=cl)
    crows, cboxes = rc.pack_tris_clusters(scc)
    d = np.random.default_rng(0).normal(size=(n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                         .astype(np.float32)).to(dev)
    rparams = TraceParams(sample_rate=16000, ir_length=32000,
                          base_power=3.62, max_bounces=32,
                          energy_threshold=0.0)
    ids, recv = replay.record_paths_kernels(
        scc, d, (0.0, 0.0, 0.0), (6.0, 1.0, -8.0), 0.0, rparams,
        TracerOptions(schedule=True), rows=crows, boxes=cboxes)
    mat_ids = torch.zeros(scc.plane_n.shape[0], dtype=torch.long,
                          device=dev)
    logits = torch.zeros(1, device=dev, requires_grad=True)

    def ir():
        sc_t = with_material_absorption(scc, mat_ids, torch.sigmoid(logits))
        return replay.render_ir_replay(sc_t, ids, recv, d, (0.0, 0.0, 0.0),
                                       (6.0, 1.0, -8.0), 0.0, rparams,
                                       soft_binning=False)
    if not grad:
        with torch.no_grad():
            return median_ms(ir, 7)
    with torch.no_grad():
        target = ir() * 0.9

    def step():
        logits.grad = None
        (torch.mean((ir() - target) ** 2) * 1e12).backward()
    return median_ms(step, 5)

box = lambda: testing.scene_from_arrays(*testing.box_room((14.0, 9.0, 11.0)),
                                        0.3)
office = lambda: testing.office_scene(20000)
paths = {
    "box_render": lambda: median_ms(renderer(box(), 100, (2.5, 1.5, 2.0),
                                             None).render, 7),
    "matrix_2x4": matrix_2x4,
    "office_render": lambda: median_ms(renderer(
        office(), 32, (6.0, 1.0, -8.0), None).render, 5),
    "office_explicit": lambda: median_ms(renderer(
        office(), 32, (6.0, 1.0, -8.0), TracerOptions()).render, 5),
    "record_schedule": lambda: record(TracerOptions(schedule=True)),
    "record_k5": lambda: record(TracerOptions()),
    "exp_default": lambda: experimentation([]),
    "exp_group": lambda: experimentation(["--layout", "group"]),
    "exp_group_high": lambda: experimentation(["--layout", "group",
                                               "--precision", "high"]),
    "exp_v1": lambda: experimentation(["--kernel-version", "1"]),
    "replay": lambda: replay_step(False),
    "replay_grad": lambda: replay_step(True),
}
print(json.dumps({path: paths[path]()}))
"""

E2E_PATHS = ("box_render", "matrix_2x4", "office_render", "office_explicit",
             "record_schedule", "record_k5", "exp_default", "exp_group",
             "exp_group_high", "exp_v1", "replay", "replay_grad")


def e2e_phase(parent: Path, paths=E2E_PATHS, pairs: int = 3,
              device: str = "cuda", n: int = 1_000_000) -> dict:
    """The paths a user runs, each in a process of its own per checkout, in
    pairs that alternate which side runs first (other, this, this, other,
    ...): the box render (1M rays x 100 bounces, median of 7), the 2 x 4 x
    1M-ray matrix, the office render (auto options: the schedule and K2)
    and with explicit options (K5), the path recording of the office (1M x
    32) with the schedule and with K5 (medians of 5, 5, 5, 3, 3; host clock
    around synchronised calls, one warm-up each), and the CLI's
    experimentation mode on the box config (1M rays x 100 bounces, 10
    rounds after a warm-up: the median render it prints) with default
    options, ``--layout group`` (also with ``--precision high``) and
    ``--kernel-version 1``; the gradient step's replay of recorded office
    paths (1M x 32, hard binning) alone (median of 7) and with its
    backward (median of 5)."""
    out: dict[str, dict[str, list]] = {}
    for i in range(pairs):
        order = (("parent", parent), ("tree", REPO))
        for path in paths:
            for who, root in (order if i % 2 == 0 else order[::-1]):
                res = subprocess.run(
                    [sys.executable, "-c", _E2E, str(root), path, device,
                     str(n)],
                    capture_output=True, text=True, timeout=900,
                    cwd=str(root))
                if res.returncode:
                    raise RuntimeError(f"{path} in {root} failed:\n"
                                       f"{res.stderr}")
                ms = json.loads(res.stdout.splitlines()[-1])[path]
                out.setdefault(path, {}).setdefault(who, []).append(ms)
                print(f"end to end, pair {i + 1}, {path} ({who}): {ms:.3f} "
                      f"ms", flush=True)
    return out


# Probes of K3-bwd's limit: its one-event-a-thread kernel (histogram.cu
# before the redesign) with one suspect taken out each. Each
# reads what the kernel reads and writes what it writes, but for the part
# named.
_BWD_PROBES = r"""
#include <climits>
#include <cuda_runtime.h>
namespace {
// The gather replaced by a contiguous read of g: no scattered sectors.
__global__ void contiguous(const int* __restrict__ bins,
                           const float* __restrict__ g, long long n,
                           int n_bins, int nb, float* __restrict__ g_w) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int b = bins[e];
  const bool in_range = b >= 0 && b < n_bins;
  const float* src = g + (e % n_bins) * nb;
  float* dst = g_w + e * nb;
  for (int k = 0; k < nb; ++k) dst[k] = in_range ? src[k] : 0.0f;
}
// Stores only: g_w written, nothing read.
__global__ void stores(const int* __restrict__ bins,
                       const float* __restrict__ g, long long n, int n_bins,
                       int nb, float* __restrict__ g_w) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float* dst = g_w + e * nb;
  for (int k = 0; k < nb; ++k) dst[k] = 0.0f;
}
// The bins read, nothing written (no bin is INT_MIN).
__global__ void bins_only(const int* __restrict__ bins,
                          const float* __restrict__ g, long long n,
                          int n_bins, int nb, float* __restrict__ g_w) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n && bins[e] == INT_MIN) g_w[0] = 1.0f;
}
// The parent's kernel with 4 consecutive events a thread.
__global__ void four(const int* __restrict__ bins,
                     const float* __restrict__ g, long long n, int n_bins,
                     int nb, float* __restrict__ g_w) {
  const long long e0 = 4 * ((long long)blockIdx.x * blockDim.x +
                            threadIdx.x);
  int b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = e0 + j < n ? bins[e0 + j] : -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e0 + j >= n) break;
    const bool in_range = b[j] >= 0 && b[j] < n_bins;
    const float* src = g + (long long)(in_range ? b[j] : 0) * nb;
    float* dst = g_w + (e0 + j) * nb;
    for (int k = 0; k < nb; ++k) dst[k] = in_range ? src[k] : 0.0f;
  }
}
}  // namespace
extern "C" int probe(int which, const int* bins, const float* g,
                     long long n, int n_bins, int nb, float* g_w,
                     void* stream) {
  const int threads = 256;
  const long long per = which == 3 ? 4 : 1;
  const unsigned blocks = (unsigned)((n + per * threads - 1) /
                                     (per * threads));
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) contiguous<<<blocks, threads, 0, s>>>(bins, g, n, n_bins, nb, g_w);
  if (which == 1) stores<<<blocks, threads, 0, s>>>(bins, g, n, n_bins, nb, g_w);
  if (which == 2) bins_only<<<blocks, threads, 0, s>>>(bins, g, n, n_bins, nb, g_w);
  if (which == 3) four<<<blocks, threads, 0, s>>>(bins, g, n, n_bins, nb, g_w);
  return (int)cudaGetLastError();
}
"""
BWD_PROBES = ("contiguous", "stores", "bins_only", "four")


def build_probes(build, out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "bwd_probes.cu"
    cu.write_text(_BWD_PROBES)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                          str(out_dir / "libbwd_probes.so"), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on the probes:\n{res.stdout}"
                           f"{res.stderr}")
    lib = ctypes.CDLL(str(out_dir / "libbwd_probes.so"))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe.argtypes = (I, P, P, LL, I, I, P, P)
    lib.probe.restype = I
    return lib


def stream_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Device time of one call: ``launches`` calls back to back between two
    events, over their count (the host's per-call work overlaps the
    device's), median of ``reps``."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call, enqueue only (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def histogram_bwd_phase(n: int, parent_lib, probes) -> dict:
    """K3-bwd at the gradient path's shapes (1 band, 4 bands, posed), 30%
    of the bins out of range, and at 1 band with E = 4k + 3 and a bins[1:]
    view. Per shape: the wrapper and index_select on the zero-padded
    gradient, one call between two events (what chip_smoke.py times: the
    host's path into the launch included), 9 repeats of medians of 20; then
    device times (``stream_ms``) of this tree's kernel and the parent's
    through their C entry points, of the probes and of ``index_select(...,
    out=)``, and the host's time a call of the wrapper, of the C entry
    point and of index_select. Every output is checked against the plain
    version first."""
    from audiorenderingv2_tpu_torch.ops import _build
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    n_pad = -(-n // 128) * 128
    shapes = {"1 band": (4 * n_pad, 2 * IR_SECONDS * SR, 1, 0),
              "4 bands": (4 * n_pad, 2 * IR_SECONDS * SR, 4, 0),
              "posed": (8 * n_pad, 8 * 2 * IR_SECONDS * SR, 1, 0),
              "1 band, E = 4k + 3": (4 * n_pad + 3, 2 * IR_SECONDS * SR, 1,
                                     0),
              "1 band, bins[1:]": (4 * n_pad + 1, 2 * IR_SECONDS * SR, 1,
                                   1)}
    rng = np.random.default_rng(17)
    out = {}
    for name, (n_all, n_bins, n_bands, skip) in shapes.items():
        bins = rng.integers(-n_bins // 8, n_bins + n_bins // 8,
                            size=n_all).astype(np.int32)
        bins[::97] = n_bins
        b_d = torch.from_numpy(bins).cuda()[skip:]
        n_events = b_d.shape[0]
        g = torch.from_numpy(rng.standard_normal(
            (n_bins, n_bands)).astype(np.float32)).cuda()
        keep = (b_d >= 0) & (b_d < n_bins)
        g_pad = torch.cat([g, torch.zeros((1, n_bands), device="cuda")])
        idx = torch.where(keep, b_d, n_bins).long()
        plain = hc.histogram_bwd_plain(b_d, g)
        assert torch.equal(g_pad.index_select(0, idx), plain)
        assert torch.equal(hc.histogram_bwd(b_d, g), plain)
        buf = torch.empty_like(plain)

        def raw(which_lib):
            def call():
                err = which_lib.ar2_histogram_bwd(
                    b_d.data_ptr(), g.data_ptr(), n_events, n_bins, n_bands,
                    buf.data_ptr(), stream)
                assert err == 0, err
            return call

        for who, which_lib in (("tree", lib), ("parent", parent_lib)):
            buf.fill_(float("nan"))
            raw(which_lib)()
            assert torch.equal(buf, plain), f"K3-bwd {who}, {name}"
        kern, lib_t = [], []
        for _ in range(9):
            kern.append(median_ms(lambda: hc.histogram_bwd(b_d, g), 20))
            lib_t.append(median_ms(lambda: g_pad.index_select(0, idx), 20))
        device = {"tree": stream_ms(raw(lib)),
                  "parent": stream_ms(raw(parent_lib)),
                  "index_select": stream_ms(lambda: torch.index_select(
                      g_pad, 0, idx, out=buf))}
        for k, probe in enumerate(BWD_PROBES):
            def call(k=k):
                err = probes.probe(k, b_d.data_ptr(), g.data_ptr(), n_events,
                                   n_bins, n_bands, buf.data_ptr(), stream)
                assert err == 0, err
            device[f"probe_{probe}"] = stream_ms(call)
        dev = b_d.device
        host = {"wrapper": host_us(lambda: hc.histogram_bwd(b_d, g)),
                "c_entry": host_us(raw(lib)),
                "index_select": host_us(lambda: g_pad.index_select(0, idx)),
                # the wrapper's parts
                "checks": host_us(lambda: (
                    b_d.dtype != torch.int32 or g.dtype != torch.float32,
                    b_d.dim() != 1 or g.dim() != 2, g.device != dev,
                    b_d.is_contiguous() and g.is_contiguous(),
                    dev.type == "cpu")),
                "new_empty": host_us(lambda: g.new_empty(plain.shape)),
                "current_stream": host_us(
                    lambda: torch.cuda.current_stream(dev).cuda_stream),
                "library": host_us(_build.library)}
        if hasattr(torch._C, "_cuda_getCurrentRawStream"):
            host["raw_stream"] = host_us(
                lambda: torch._C._cuda_getCurrentRawStream(dev.index))
        bound = (b_d.numel() * 4 + g.numel() * 4 + plain.numel() * 4) \
            / HBM_BYTES_PER_S * 1e3
        out[name] = {"events": n_events, "bins": n_bins, "bands": n_bands,
                     "bound_ms": bound, "kernel_ms": kern,
                     "index_select_ms": lib_t, "device_ms": device,
                     "host_us": host}
        print(f"K3-bwd {name} ({n_events} x {n_bands} from {n_bins} bins; "
              f"bound {bound:.4f} ms): wrapper, one call, median "
              f"{np.median(kern):.4f} ms (range {min(kern):.4f}-"
              f"{max(kern):.4f}), index_select {np.median(lib_t):.4f} "
              f"({min(lib_t):.4f}-{max(lib_t):.4f}); device ms " + ", ".join(
                  f"{k} {v:.4f}" for k, v in device.items())
              + "; host us a call " + ", ".join(
                  f"{k} {v:.1f}" for k, v in host.items()), flush=True)
    return out


# K3 and K4 as a checkout's own wrappers run them, in a process of its own
# (the hist and init phases). It prints one JSON line; it runs on any
# checkout of the port: the fused hard-binning entry
# (histogram_cuda.histogram_binned) is timed where it exists.
_HIST_INIT = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from audiorenderingv2_tpu_torch import testing
from audiorenderingv2_tpu_torch.core import tracer
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
phase, n = sys.argv[2], int(sys.argv[3])
dev = torch.device("cuda")
SR, NB = 16000, 32000
n_pad = -(-n // 128) * 128

def one_call_ms(fn, reps=20):
    # What chip_smoke.py times: one call between two events, the host's
    # path into the launch included; median of reps after a warm-up.
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))

def graph_ms(fn, calls=20, reps=7):
    # Device time of one call: `calls` calls captured in one CUDA graph,
    # the replay between two events over the count; median of reps.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); g.replay(); b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g
    return float(np.median(times))

def host_us(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6

def wall_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))

def profile_launches(fn):
    # Device-side records (kernels and memsets) of one call under
    # torch.profiler, and their names.
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(names), sorted(set(names))

def timings(call, library=None):
    row = {"ms": one_call_ms(call), "device_ms": graph_ms(call),
           "host_us": host_us(call)}
    if library is not None:
        row["library_ms"] = one_call_ms(library)
        row["library_device_ms"] = graph_ms(library)
    return row

def flat_and_library(bins, w, n_bins):
    keep = (bins >= 0) & (bins < n_bins)
    idx, wk = bins[keep].long(), w[keep].contiguous()
    out = torch.zeros((n_bins, w.shape[1]), device=dev)
    return lambda: out.index_add_(0, idx, wk)

def synthetic(n_events, n_bins, n_bands, seed):
    # chip_smoke.py's phase 3 inputs: uniform bins, 30% out of range.
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, size=n_events)
    out = rng.random(n_events) < 0.3
    bins[out] = np.where(rng.random(out.sum()) < 0.5,
                         -rng.integers(1, 1000, size=out.sum()),
                         n_bins + rng.integers(0, 1000, size=out.sum()))
    w = (rng.random((n_events, n_bands)) * 2e-9).astype(np.float32)
    return (torch.from_numpy(bins.astype(np.int32)).to(dev),
            torch.from_numpy(w).to(dev))

def unit_dirs(k, seed):
    d = np.random.default_rng(seed).normal(size=(k, 3))
    return torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                            .astype(np.float32)).to(dev)

def same_ear_flat(ev_bin_f, ev_w, ev_ear, nb):
    # The flat bins the two-step stage hands K3 (one pose at a time).
    p = ev_bin_f.shape[0]
    active = torch.any(ev_w != 0.0, dim=-1)
    b = torch.round(ev_bin_f).to(torch.int32)
    pose = torch.arange(p, dtype=torch.int32, device=dev)[:, None]
    flat = torch.where(active & (b >= 0) & (b < nb),
                       (pose * 2 + ev_ear.to(torch.int32)) * nb + b,
                       p * 2 * nb)
    return flat.reshape(-1), ev_w.reshape(-1, ev_w.shape[-1]), p * 2 * nb

def box_events(n_bands):
    absorb = 0.3 if n_bands == 1 else np.tile(
        np.asarray((0.1, 0.25, 0.4, 0.6, 0.2, 0.3, 0.5, 0.7)[:n_bands],
                   np.float32), (12, 1))
    scene = testing.scene_from_arrays(*testing.box_room((14.0, 9.0, 11.0)),
                                      absorb)
    sc = tracer.scene_to_arrays(scene, 128, device=dev)
    params = TraceParams(sample_rate=SR, ir_length=NB, base_power=3.62,
                         max_bounces=100, hrtf_absorption_rate=0.9,
                         n_bands=n_bands)
    rows, _ = rc.pack_scene(sc, n_bands)
    ev = rc.trace_events(rows, unit_dirs(n, 5), torch.zeros(3, device=dev),
                         torch.tensor((2.5, 1.5, 2.0), device=dev), 0.0,
                         params)
    return tuple(x[None] for x in ev), params

def matrix_events():
    demo = testing.scene_from_arrays(*testing.box_room((18.0, 10.0, 14.0)),
                                     0.25)
    sc = tracer.scene_to_arrays(demo, 128, device=dev)
    rows, _ = rc.pack_scene(sc, 1)
    params = TraceParams(sample_rate=SR, ir_length=NB, base_power=3.62,
                         max_bounces=40, hrtf_absorption_rate=0.9)
    em = np.array([[-5.0, 0.0, -4.0], [6.0, 1.0, 5.0]], np.float32)
    li = np.stack([np.linspace(-6.0, 6.0, 4), np.zeros(4),
                   np.linspace(4.0, -4.0, 4)], axis=1).astype(np.float32)
    yaw = np.linspace(0.0, 270.0, 4).astype(np.float32)
    dirs = torch.stack([unit_dirs(n, 40 + i) for i in range(8)])
    ev = rc.trace_events_pose_batch(
        rows, dirs, torch.from_numpy(np.repeat(em, 4, axis=0)).to(dev),
        torch.from_numpy(np.tile(li, (2, 1))).to(dev),
        torch.from_numpy(np.tile(yaw, 2)).to(dev), params,
        round_budgets=(8, 32))
    return ev, params

out = {"phase": phase}
if phase == "hist":
    res = {}
    for name, (e, nbins, nbands, seed) in {
            "1 band": (n_pad, 2 * NB, 1, 3), "4 bands": (n_pad, 2 * NB, 4, 4),
            "8 bands": (n_pad, 2 * NB, 8, 8),
            "posed": (8 * n_pad, 16 * NB, 1, 6)}.items():
        bins, w = synthetic(e, nbins, nbands, seed)
        res[name] = timings(
            lambda: hc.histogram_sum_banded(bins, w, nbins),
            flat_and_library(bins, w, nbins))
        res[name]["bound_ms"] = (bins.numel() * 4 + w.numel() * 4
                                 + nbins * nbands * 4) / 3.35e12 * 1e3
    # K3 on the box render's own events (1,000,064 rays x 100 bounces).
    for nbands in (1, 4, 8):
        ev, params = box_events(nbands)
        flat, w, nbins = same_ear_flat(*ev, NB)
        key = "box events" if nbands == 1 else f"box events, {nbands} bands"
        res[key] = timings(lambda: hc.histogram_sum_banded(flat, w, nbins),
                           flat_and_library(flat, w, nbins))
        kept = flat[flat < nbins]
        counts = torch.bincount(kept, minlength=nbins)
        res[key].update(
            events_in_range=int(kept.numel()),
            busiest_32=int(counts.topk(32).values.sum()),
            busiest_bin=int(counts.max()), occupied=int((counts > 0).sum()),
            bound_ms=(flat.numel() * 4 + w.numel() * 4 + nbins * nbands * 4)
            / 3.35e12 * 1e3)
        stage = lambda: tracer._histogram_from_events_posed(*ev, params)
        launches, names = profile_launches(stage)
        res[key]["stage"] = {"ms": one_call_ms(stage), "launches": launches,
                             "kernels": names}
        if hasattr(hc, "histogram_binned"):
            res[key]["binned"] = timings(lambda: hc.histogram_binned(
                *ev, NB, False, params.cross_ear_delay,
                params.hrtf_absorption_rate))
    ev, params = matrix_events()
    stage = lambda: tracer._histogram_from_events_posed(*ev, params)
    launches, names = profile_launches(stage)
    flat, w, nbins = same_ear_flat(*ev, NB)
    res["matrix events"] = timings(
        lambda: hc.histogram_sum_banded(flat, w, nbins),
        flat_and_library(flat, w, nbins))
    res["matrix events"]["stage"] = {"ms": one_call_ms(stage),
                                     "launches": launches, "kernels": names}
    if hasattr(hc, "histogram_binned"):
        res["matrix events"]["binned"] = timings(lambda: hc.histogram_binned(
            *ev, NB, False, params.cross_ear_delay,
            params.hrtf_absorption_rate))
    from audiorenderingv2_tpu_torch import multi
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer
    demo = testing.scene_from_arrays(*testing.box_room((18.0, 10.0, 14.0)),
                                     0.25)
    sc = tracer.scene_to_arrays(demo, 128, device=dev)
    rows, _ = rc.pack_scene(sc, 1)
    em = np.array([[-5.0, 0.0, -4.0], [6.0, 1.0, 5.0]], np.float32)
    li = np.stack([np.linspace(-6.0, 6.0, 4), np.zeros(4),
                   np.linspace(4.0, -4.0, 4)], axis=1).astype(np.float32)
    yaw = np.linspace(0.0, 270.0, 4).astype(np.float32)
    res["matrix events"]["matrix_ms"] = wall_ms(
        lambda: multi.render_ir_matrix(
            sc, 0, em, li, yaw, n, params,
            tracer.TracerOptions(round_budgets=(8, 32)), pair_batch=8,
            rows=rows), 5)
    r = AudioRenderer(testing.scene_from_arrays(
        *testing.box_room((14.0, 9.0, 11.0)), 0.3), 2, SR, n,
        base_power=3.62, max_bounces=100, hrtf_absorption_rate=0.9,
        device=dev)
    r.set_emitter_pos((0.0, 0.0, 0.0))
    r.set_receiver((2.5, 1.5, 2.0), 0.0)
    res["box events"]["render_ms"] = wall_ms(r.render, 7)
    out["hist"] = res
else:
    res = {}
    params = TraceParams(sample_rate=SR, ir_length=NB, base_power=3.62,
                         max_bounces=100)
    for nbands in (1, 4):
        scal = rc.scalars(torch.zeros(3, device=dev),
                          torch.tensor((2.5, 1.5, 2.0), device=dev), 0.0,
                          1e-6, params).clone()
        scal[14] = 1234.0
        call = lambda: rc.init_state_native(scal, n_pad, n, nbands)
        res[f"{nbands} band(s)"] = timings(call)
        res[f"{nbands} band(s)"]["bound_ms"] = (
            rc.state_ncols(nbands) * n_pad * 4 / 3.35e12 * 1e3)
    # The host's time a call of the wrappers that take the stream handle.
    from audiorenderingv2_tpu_torch import accel
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc_
    from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc
    host = {}
    box = tracer.scene_to_arrays(testing.scene_from_arrays(
        *testing.box_room((14.0, 9.0, 11.0)), 0.3), 128, device=dev)
    brows, _ = rc.pack_scene(box, 1)
    k = 65536
    em = torch.zeros(3, device=dev)
    scal = rc.scalars(em, torch.tensor((2.5, 1.5, 2.0), device=dev), 0.0,
                      1e-6, params)
    done = rc.init_state(unit_dirs(k, 1), em, 1e-6, k)
    done[rc._C_DONE] = 1.0
    host["K1"] = host_us(lambda: rc.trace_round(done, brows, scal, params, 8))
    seeded = scal.clone()
    seeded[14] = 7.0
    host["K4"] = host_us(lambda: rc.init_state_native(seeded, k, k))
    ss, cl = accel.prepare_scene(testing.office_scene(20000), cluster_size=32)
    orows, oboxes = rc.pack_tris_clusters(tracer.scene_to_arrays(
        ss, 128, device=dev, clusters=cl))
    oparams = TraceParams(sample_rate=SR, ir_length=NB, base_power=3.62,
                          max_bounces=32)
    oscal = rc.scalars(em, torch.tensor((6.0, 1.0, -8.0), device=dev), 0.0,
                       1e-6, oparams)
    ost = rc.init_state(unit_dirs(k, 2), em, 1e-6, k)
    sched = sc_.tile_schedule(ost, oboxes)
    host["schedule"] = host_us(lambda: sc_.tile_schedule(ost, oboxes))
    host["K2"] = host_us(lambda: sc_.trace_round_sched(
        ost, orows, oboxes, sched, oscal, oparams))
    host["K5"] = host_us(lambda: tc.trace_traverse(
        ost, orows, oboxes, oscal, oparams))
    host["current_stream"] = host_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream)
    host["raw_stream"] = host_us(
        lambda: torch._C._cuda_getCurrentRawStream(dev.index or 0))
    res["host_us"] = host
    out["init"] = res
print(json.dumps(out))
"""


def graph_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Device time of one ``fn()``: ``calls`` calls in one CUDA graph, the
    replay between two events over ``calls``, median of ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _raw_stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    tiny = float(np.finfo(np.float32).tiny)
    bad = int(((got - want).abs() > 1e-4 * want.abs() + tiny).sum())
    assert bad == 0 and not got[want == 0].any(), f"{what}: {bad} bins off"


def hist_levers(libs: dict, n: int) -> dict:
    """K3's C entries of every library (this tree, the parent, the
    variants of ``hist_variants``), device time of 20 calls in a CUDA graph
    (``graph_ms``; the parent's flat-bin entry after a zero fill of its
    output, as its wrapper did), forward and reverse order: the flat-bin
    entry at 1, 4 and 8 bands and at the posed shape (8 x 1,000,064 events
    into 512,000 bins) on uniform bins, and at the box render's own flat
    bins; the hard-binning entry on the box render's events (1 and 4
    bands, stereo) and on the 2 x 4 matrix's. Each output is checked
    against the plain version first."""
    from audiorenderingv2_tpu_torch import testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    nb = IR_SECONDS * SR
    n_pad = -(-n // 128) * 128
    rng = np.random.default_rng(3)
    cases = {}
    for bands, poses in ((1, 1), (4, 1), (8, 1), (1, 8)):
        n_bins = 2 * nb * poses
        bins = rng.integers(-n_bins // 8, n_bins + n_bins // 8,
                            size=n_pad * poses).astype(np.int32)
        w = (rng.random((n_pad * poses, bands)) * 2e-9).astype(np.float32)
        name = f"flat {bands}" if poses == 1 else "flat posed"
        cases[name] = ("flat", torch.from_numpy(bins).to(dev),
                       torch.from_numpy(w).to(dev), n_bins)
    scene = testing.scene_from_arrays(*testing.box_room((14.0, 9.0, 11.0)),
                                      0.3)
    sc = tracer.scene_to_arrays(scene, 128, device=dev)
    for bands in (1, 4):
        params = TraceParams(sample_rate=SR, ir_length=nb, base_power=3.62,
                             max_bounces=100, hrtf_absorption_rate=0.9,
                             n_bands=bands)
        rows, _ = rc.pack_scene(sc, bands)
        ev = tuple(x[None] for x in rc.trace_events(
            rows, torch.from_numpy(unit_dirs(n, 5)).to(dev),
            torch.zeros(3, device=dev),
            torch.tensor((2.5, 1.5, 2.0), device=dev), 0.0, params,
            round_budgets=tuned.round_budgets_for(100)))
        cases[f"box binned {bands}"] = ("binned", ev, params)
        if bands == 1:
            b = torch.round(ev[0]).to(torch.int32)
            active = (ev[1] != 0).any(dim=-1)
            flat = torch.where(active & (b >= 0) & (b < nb),
                               ev[2] * nb + b, 2 * nb).reshape(-1)
            cases["box flat 1"] = ("flat", flat, ev[1].reshape(-1, 1),
                                   2 * nb)
    demo = testing.scene_from_arrays(*testing.box_room((18.0, 10.0, 14.0)),
                                     0.25)
    msc = tracer.scene_to_arrays(demo, 128, device=dev)
    mparams = TraceParams(sample_rate=SR, ir_length=nb, base_power=3.62,
                          max_bounces=40, hrtf_absorption_rate=0.9)
    mev = rc.trace_events_pose_batch(
        rc.pack_scene(msc, 1)[0],
        torch.stack([torch.from_numpy(unit_dirs(n, 40 + i)).to(dev)
                     for i in range(8)]),
        torch.from_numpy(np.repeat(MULTI_EMITTERS, 4, axis=0)).to(dev),
        torch.from_numpy(np.tile(MULTI_LISTENERS, (2, 1))).to(dev),
        torch.from_numpy(np.tile(MULTI_YAWS, 2)).to(dev), mparams,
        round_budgets=MULTI_BUDGETS)
    cases["matrix binned 1"] = ("binned", mev, mparams)

    def call_of(lib, who, case, out):
        # One output buffer for every library of a case: on an H100 two
        # libraries with the same one-band kernel differed by 11% with a
        # buffer each, by 1% with one.
        if case[0] == "flat":
            _, bins, w, n_bins = case

            def call():
                if who == "parent":
                    out.zero_()
                err = lib.ar2_histogram(bins.data_ptr(), w.data_ptr(),
                                        bins.shape[0], n_bins, w.shape[1],
                                        out.data_ptr(), _raw_stream())
                assert err == 0, err
                return out
            return call
        if not hasattr(lib, "ar2_histogram_binned"):
            return None
        _, (bf, w, ear), params = case

        def call():
            err = lib.ar2_histogram_binned(
                bf.data_ptr(), w.data_ptr(), ear.data_ptr(), bf.shape[0],
                bf.shape[1], w.shape[2], nb, 0, params.cross_ear_delay,
                1.0 - params.hrtf_absorption_rate, out.data_ptr(),
                _raw_stream())
            assert err == 0, err
            return out
        return call

    out = {}
    for name, case in cases.items():
        if case[0] == "flat":
            want = hc.histogram_plain(case[1], case[2], case[3])
        else:
            _, ev, params = case
            want = hc.histogram_binned_plain(
                *ev, nb, False, params.cross_ear_delay,
                params.hrtf_absorption_rate)
        out_buf = torch.empty_like(want)
        calls = {who: call_of(lib, who, case, out_buf)
                 for who, lib in libs.items()}
        calls = {who: c for who, c in calls.items() if c is not None}
        for who, call in calls.items():
            got = call().clone()
            torch.cuda.synchronize()
            _close(got.reshape(want.shape), want, f"{name}, {who}")
        times: dict[str, list[float]] = {}
        order = list(calls.items())
        for pass_order in (order, order[::-1]):
            for who, call in pass_order:
                times.setdefault(who, []).append(graph_ms(call))
        out[name] = times
        print(f"K3 levers, {name} (device ms, forward / reverse): " + "; ".join(
            f"{w} {v[0]:.4f}/{v[1]:.4f}" for w, v in times.items()),
            flush=True)
    return out


def init_levers(libs: dict, n: int) -> dict:
    """K4's C entry of every library in ``libs`` at 1, 4 and 8 bands,
    device time as ``hist_levers``; each output checked against the plain
    version first (exactly rounded columns bit for bit, VX / VY within
    2e-7)."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    n_pad = -(-n // 128) * 128
    scal = torch.zeros(16, device=dev)
    scal[0:3] = torch.tensor([0.5, -1.0, 2.0])
    scal[rc._S_E0] = 1e-6
    scal[rc._S_PAD14] = 4242421.0
    out = {}
    for bands in (1, 4, 8):
        ncols = rc.state_ncols(bands)
        plain = rc.init_state_native_plain(scal, n_pad, n, bands)
        state = torch.empty((ncols, n_pad), device=dev)
        calls = {}
        for who, lib in libs.items():
            def call(lib=lib):
                err = lib.ar2_init_state(state.data_ptr(), n_pad, ncols, n,
                                         scal.data_ptr(), bands,
                                         rc.layout_bands(bands),
                                         _raw_stream())
                assert err == 0, err
                return state
            got = call().clone()
            torch.cuda.synchronize()
            exact = [c for c in range(ncols) if c not in (3, 4)]
            assert torch.equal(got[exact], plain[exact]), who
            assert float((got - plain).abs().max()) <= 2e-7, who
            calls[who] = call
        times: dict[str, list[float]] = {}
        order = list(calls.items())
        for pass_order in (order, order[::-1]):
            for who, call in pass_order:
                times.setdefault(who, []).append(graph_ms(call))
        out[f"{bands} band(s)"] = times
        print(f"K4 levers, {bands} band(s) (device ms, forward / reverse): "
              + "; ".join(f"{w} {v[0]:.4f}/{v[1]:.4f}"
                          for w, v in times.items()), flush=True)
    return out


def hist_init_phase(parent: Path, phase: str, n: int) -> dict:
    """K3 (``hist``) or K4 (``init``) as each checkout's wrappers run them,
    in a process of its own per checkout: other, this, this, other. K3 at
    1, 4 and 8 bands and posed on chip_smoke.py's synthetic bins and at
    the box render's own events (1, 4, 8 bands; with the count of events
    in the 32 busiest bins), beside ``index_add_`` alone over the in-range
    events (the filtering outside the timed window); the hard-binning stage
    of one box render and of the 2 x 4 x 1M matrix (its launches under
    torch.profiler, its time, the render's and the matrix's time); the
    fused entry where the checkout has it. K4 at 1 and 4 bands, and the
    host's time a call of the wrappers that take the stream handle. Each
    row: ``ms`` one call between two events (median of 20), ``device_ms``
    20 calls in one CUDA graph over 20 (median of 7 replays), ``host_us``
    the host's time a call."""
    out: dict[str, list] = {}
    for who, root in (("parent", parent), ("tree", REPO), ("tree", REPO),
                      ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", _HIST_INIT, str(root),
                              phase, str(n)], capture_output=True, text=True,
                             timeout=900, cwd=str(root))
        if res.returncode:
            raise RuntimeError(f"{phase} in {root} failed:\n{res.stderr}")
        got = json.loads(res.stdout.splitlines()[-1])[phase]
        out.setdefault(who, []).append(got)
        print(f"{phase} ({who}): {json.dumps(got)}", flush=True)
    return out


def hist_variants(tree: str) -> dict[str, str]:
    """Copies of csrc/histogram.cu, each undoing one lever of K3's forward
    redesign, or trying one: ``tree_scalar`` one event a thread with scalar
    loads and atomics at every band count (no vector loads or reductions),
    also in the hard-binning stage; ``tree_one_band_scalar`` the same at
    one band only (4 and 8 bands keep their vector path);
    ``tree_quad_items1``, ``tree_quad_items4`` one or 4 quads of events a
    thread at one band instead of 2; ``tree_row_items4`` 4 events a
    thread at 4 and 8 bands instead of 1."""
    out = {
        "tree_scalar": _replace(_replace(
            tree, "  const bool aligned = aligned16(bins, weights, out);",
            "  const bool aligned = false;"),
            "  const bool aligned = aligned16(bin_f, w, ear, h.out);",
            "  const bool aligned = false;"),
        "tree_quad_items1": _replace(
            tree, "constexpr int kQuadItems = 2;",
            "constexpr int kQuadItems = 1;"),
        "tree_quad_items4": _replace(
            tree, "constexpr int kQuadItems = 2;",
            "constexpr int kQuadItems = 4;"),
        "tree_row_items4": _replace(
            tree, "constexpr int kRowItems = 1;",
            "constexpr int kRowItems = 4;"),
        "tree_one_band_scalar": _replace(_replace(
            tree, "  if (aligned && n_bands == 1) {",
            "  if (false) {"),
            "  if (aligned && n_bands == 1 && per_pose % 4 == 0) {",
            "  if (false) {"),
    }
    return out


# The variants each phase compares (beside the two checkouts).
K7_VARIANTS = ("tree_all_rows", "tree_scalar", "tree_grid_all")
POSE_VARIANTS = ("tree_ilp", "tree_lb8", "tree_persist_all", "tree_refill8")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="another checkout of the repository")
    ap.add_argument("--rays", type=int, default=1_000_000)
    ap.add_argument("--out", type=Path,
                    help="also write the JSON line to this file")
    ap.add_argument("--phases",
                    default="k1,k1_pose,k7,k5,k2,k6,render,bwd,hist,init,e2e",
                    help="comma-separated subset of the phases to run")
    ap.add_argument("--paths", default=",".join(E2E_PATHS),
                    help="comma-separated subset of the e2e phase's paths")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    paths = args.paths.split(",")
    if not set(paths) <= set(E2E_PATHS):
        ap.error(f"--paths: not among {E2E_PATHS}: {args.paths}")
    if not torch.cuda.is_available():
        print("torch_trace_ab: no CUDA device", file=sys.stderr)
        return 2
    from audiorenderingv2_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    parent_dir = args.parent.resolve()
    parent_build = load_build_module(parent_dir, "parent_build")
    base = {"parent": parent_build.library(), "tree": _build.library()}

    def src(name: str) -> str:
        return (_build.CSRC / name).read_text()

    out_dir = _build.BUILD_ROOT / "trace_ab_variants"
    sources = {}
    if phases & {"k1", "k1_pose", "k7"}:
        sources.update({f"k1_{k}": v for k, v in
                        k1_variants(src("trace_round.cu"),
                                    src("trace_common.cuh")).items()})
    if "k5" in phases:
        sources.update({f"k5_{k}": v for k, v in
                        k5_variants(src("trace_traverse.cu")).items()})
    if "k2" in phases:
        sources.update({f"k2_{k}": v for k, v in
                        k2_variants(src("trace_sched.cu")).items()})
    if "k6" in phases:
        sources.update({f"k6_{k}": v for k, v in
                        k6_variants(src("trace_group.cu")).items()})
    if "hist" in phases:
        sources.update({f"k3_{k}": v for k, v in
                        hist_variants(src("histogram.cu")).items()})
    variants = build_variants(_build, sources, _build.CSRC, out_dir)
    probes = build_probes(_build, out_dir) if "bwd" in phases else None
    print(f"built {len(variants)} variants and both checkouts in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kernel_of = {"k1": "trace_r", "k5": "trace_traverse",
                 "k2": "trace_sched", "k6": "trace_group", "k3": "histogram"}
    regs = {name: ptxas_lines((out_dir / f"{name}.log").read_text(),
                              kernel_of[name[:2]])
            for name in variants}
    tree_log = (_build.build_dir() / "build.log").read_text()
    regs["tree"] = ptxas_lines(tree_log, "trace_r") + ptxas_lines(
        tree_log, "trace_traverse") + ptxas_lines(
        tree_log, "histogram") + ptxas_lines(tree_log, "binned") \
        + ptxas_lines(tree_log, "init_state") + ptxas_lines(
        tree_log, "trace_group")
    for name, lines in regs.items():
        print(f"ptxas {name}: " + " | ".join(lines), flush=True)

    def libs_of(prefix: str, keep=None) -> dict:
        return {**base, **{k[3:]: v for k, v in variants.items()
                           if k.startswith(prefix)
                           and (keep is None or k[3:] in keep)}}

    result = {"device": card, "rays": args.rays, "ptxas": regs}
    runs = {"k1": lambda: k1_phase(libs_of("k1_"), args.rays),
            "k1_pose": lambda: k1_pose_phase(libs_of("k1_", POSE_VARIANTS),
                                             args.rays),
            "k7": lambda: k7_phase(libs_of("k1_", K7_VARIANTS), args.rays),
            "k5": lambda: k5_phase(libs_of("k5_"), args.rays),
            "k2": lambda: k2_phase(libs_of("k2_"), args.rays),
            "k6": lambda: k6_phase(libs_of("k6_"), args.rays),
            "render": lambda: render_phase(parent_dir),
            "bwd": lambda: histogram_bwd_phase(args.rays, base["parent"],
                                               probes),
            "hist": lambda: {
                "checkouts": hist_init_phase(parent_dir, "hist", args.rays),
                "levers": hist_levers(libs_of("k3_"), args.rays)},
            "init": lambda: {
                "checkouts": hist_init_phase(parent_dir, "init", args.rays),
                "levers": init_levers(base, args.rays)},
            "e2e": lambda: e2e_phase(parent_dir, paths)}
    for name, run in runs.items():
        if name in phases:
            result[name] = run()
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
