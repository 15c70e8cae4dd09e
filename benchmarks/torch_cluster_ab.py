"""A/B of the PyTorch port's clustered-route kernels on one NVIDIA GPU.

The schedule kernel (csrc/tile_schedule.cu) and K2 (csrc/trace_sched.cu)
of this checkout against those of another checkout of the repository (for
example the parent commit, unpacked with ``git archive``), and against
variants of K2 compiled from copies of the two sources, on three states of
the office render (benchmarks/large_scene.py's scene, 19,852 triangles in
621 clusters of 32, 1M rays): round 1 (the start state, unsorted), after
one bounce and the sort, after 16 bounces.

    python3 benchmarks/torch_cluster_ab.py --parent DIR [--rays N]
                                           [--out FILE]

K2 variants (each its own library, built under the package's ``_build/``
from a copy of a ``trace_sched.cu``; the committed sources are not
touched):

  parent        the other checkout's K2
  tree          this checkout's K2
  parent_f4     the other checkout's kernel with this tree's test function
                (rows read as float4, 16 rows unrolled)
  ring_scalar   this tree's ring of bulk copies, rows read by
                Ray::intersect (17 scalar loads a row)
  ring_f4       this tree's ring and float4 rows, not unrolled
  ring_pretest  ring_f4 with two exact pre-tests as per-lane branches: the
                sign of the quotient before the division, the running
                minimum and the valid flag before the barycentric terms
  ring_wskip    ring_f4, a row skipped when no lane of the warp passes the
                sign pre-test
  ring_wcull    this tree's K2, a row skipped when no lane of the warp can
                improve its running minimum (the sign pre-test, or |no|
                above best_t * |nd| with a margin of 1e-6: exact, since the
                quotient of the same no and nd is then >= best_t)
  ring_2ray     ring_f4 with two rays a thread (64 threads a tile)
  tree_noint, parent_noint
                the two kernels with the intersection left out: staging,
                the loop and the bounce tail alone

Every variant but the two noint ones is held bit for bit against K2's plain
version, and both schedules' rows against the plain rows, on every state.
Times are CUDA-event medians of 7 launches after one warm-up, in two
passes (forward and reverse order). Prints one JSON line (and writes it
to ``--out`` when given); exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OFFICE_TRIS = 20000
EMITTER = (0.0, 0.0, 0.0)
RECEIVER = (6.0, 1.0, -8.0)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TRI_TEST_OPS = 40
SLAB_TEST_OPS = 23

_CALL_TREE = ("if (alive)\n      intersect_staged(r, s_rows + s * "
              "stage_floats, cs, list[1 + k] * cs,\n"
              "                       best_t, best_i);")
_CALL_PARENT = "if (alive) r.intersect(s_rows, cs, c * cs, best_t, best_i);"
_LOOP_UNROLLED = ("  for (int t0 = 0; t0 < n_rows; t0 += kUnroll)\n#pragma "
                  "unroll\n  for (int t = t0; t < t0 + kUnroll; ++t) {")
_LOOP_PLAIN = "  for (int t = 0; t < n_rows; ++t) {"
_KERNEL = "template <int LB>\n__global__"
_LAUNCH = ("trace_sched_kernel<LB><<<(unsigned)blocks, kThreads, smem, "
           "stream>>>(")

# The test of Ray::intersect with a row's float4 loads as arguments.
_TEST1 = '''
template <int LB>
__device__ __forceinline__ void test1(const Ray<LB>& r, bool alive, float4 pl,
                                      float4 au, float4 av, float val,
                                      int idx, float& best_t, int& best_i) {
  const float nd = r.vx * pl.x + r.vy * pl.y + r.vz * pl.z;
  const float no = r.px * pl.x + r.py * pl.y + r.pz * pl.z + pl.w;
  const bool safe = fabsf(nd) > kSafeDen;
  const float tt = -no / (safe ? nd : 1.0f);
  const float ou = r.px * au.x + r.py * au.y + r.pz * au.z + au.w;
  const float du = r.vx * au.x + r.vy * au.y + r.vz * au.z;
  const float u = ou + tt * du;
  const float ov = r.px * av.x + r.py * av.y + r.pz * av.z + av.w;
  const float dv = r.vx * av.x + r.vy * av.y + r.vz * av.z;
  const float v = ov + tt * dv;
  const bool ok = alive && safe && tt > kTMin && u >= -kBaryEps &&
                  v >= -kBaryEps && u + v <= 1.0f + kBaryEps && val > 0.f;
  if (ok && tt < best_t) {
    best_t = tt;
    best_i = idx;
  }
}
'''

_PRETEST = '''
template <int LB>
__device__ __forceinline__ void intersect_pretest(
    const Ray<LB>& r, const float* rows, int n_rows, int base, float& best_t,
    int& best_i) {
  const float4* row4 = reinterpret_cast<const float4*>(rows);
  for (int t = 0; t < n_rows; ++t) {
    const float4 pl = row4[t * 6];
    const float nd = r.vx * pl.x + r.vy * pl.y + r.vz * pl.z;
    const float no = r.px * pl.x + r.py * pl.y + r.pz * pl.z + pl.w;
    const bool ahead = no < 0.f ? nd > 0.f : (no > 0.f && nd < 0.f);
    if (!(fabsf(nd) > kSafeDen && ahead)) continue;
    const float tt = -no / nd;
    if (!(tt > kTMin && tt < best_t && row4[t * 6 + 3].w > 0.f)) continue;
    const float4 au = row4[t * 6 + 1], av = row4[t * 6 + 2];
    const float ou = r.px * au.x + r.py * au.y + r.pz * au.z + au.w;
    const float du = r.vx * au.x + r.vy * au.y + r.vz * au.z;
    const float u = ou + tt * du;
    const float ov = r.px * av.x + r.py * av.y + r.pz * av.z + av.w;
    const float dv = r.vx * av.x + r.vy * av.y + r.vz * av.z;
    const float v = ov + tt * dv;
    if (u >= -kBaryEps && v >= -kBaryEps && u + v <= 1.0f + kBaryEps) {
      best_t = tt;
      best_i = base + t;
    }
  }
}
'''

_WSKIP = _TEST1 + '''
template <int LB>
__device__ __forceinline__ void intersect_wskip(
    const Ray<LB>& r, bool alive, const float* rows, int n_rows, int base,
    float& best_t, int& best_i) {
  const float4* row4 = reinterpret_cast<const float4*>(rows);
  for (int t = 0; t < n_rows; ++t) {
    const float4 pl = row4[t * 6];
    const float nd = r.vx * pl.x + r.vy * pl.y + r.vz * pl.z;
    const float no = r.px * pl.x + r.py * pl.y + r.pz * pl.z + pl.w;
    const bool ahead = no < 0.f ? nd > 0.f : (no > 0.f && nd < 0.f);
    if (!__any_sync(0xffffffffu, alive && fabsf(nd) > kSafeDen && ahead))
      continue;
    test1(r, alive, pl, row4[t * 6 + 1], row4[t * 6 + 2], row4[t * 6 + 3].w,
          base + t, best_t, best_i);
  }
}
'''

_WCULL = _TEST1 + '''
template <int LB>
__device__ __forceinline__ void intersect_wcull(
    const Ray<LB>& r, bool alive, const float* rows, int n_rows, int base,
    float& best_t, int& best_i) {
  const float4* row4 = reinterpret_cast<const float4*>(rows);
  for (int t0 = 0; t0 < n_rows; t0 += 16)
#pragma unroll
  for (int t = t0; t < t0 + 16; ++t) {
    const float4 pl = row4[t * 6];
    const float nd = r.vx * pl.x + r.vy * pl.y + r.vz * pl.z;
    const float no = r.px * pl.x + r.py * pl.y + r.pz * pl.z + pl.w;
    const bool ahead = no < 0.f ? nd > 0.f : (no > 0.f && nd < 0.f);
    const bool beyond = fabsf(no) > (best_t * fabsf(nd)) * 1.000001f;
    if (!__any_sync(0xffffffffu,
                    alive && fabsf(nd) > kSafeDen && ahead && !beyond))
      continue;
    test1(r, alive, pl, row4[t * 6 + 1], row4[t * 6 + 2], row4[t * 6 + 3].w,
          base + t, best_t, best_i);
  }
}
'''

_TWO_RAY = _TEST1 + '''
template <int LB>
__global__ void __launch_bounds__(64)
trace_sched2_kernel(float* __restrict__ st, long long n,
                    const float* __restrict__ rows, int cs,
                    const int* __restrict__ sched, int width,
                    const float* __restrict__ scal, int tiles_per_pose,
                    int n_bands, int max_bounces) {
  extern __shared__ __align__(128) float s_rows[];
  __shared__ uint64_t s_full[kMaxStages], s_empty[kMaxStages];
  const int tid = threadIdx.x;
  const long long ray0 = (long long)blockIdx.x * kThreads + tid;
  const long long ray1 = ray0 + 64;
  const Scalars sc(scal + (long long)(blockIdx.x / tiles_per_pose) * kNScal);
  Ray<LB> r0, r1;
  r0.load(st, n, ray0, true, n_bands);
  r1.load(st, n, ray1, true, n_bands);
  const bool run0 = r0.done == 0.f, run1 = r1.done == 0.f;
  const bool cc0 = r0.can_continue(sc, n_bands, (float)max_bounces);
  const bool cc1 = r1.can_continue(sc, n_bands, (float)max_bounces);
  const bool al0 = run0 && cc0, al1 = run1 && cc1;
  const int* list = sched + (long long)blockIdx.x * width;
  const int count = list[0];
  const int stage_floats = cs * kNR;
  const uint32_t stage_bytes = (uint32_t)stage_floats * sizeof(float);
  const int stages = ring_stages((int)stage_bytes);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&s_full[s], 1);
      mbar_init(&s_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < min(stages, count); ++k)
      bulk_load(s_rows + k * stage_floats,
                rows + (long long)list[1 + k] * stage_floats, stage_bytes,
                &s_full[k]);
  float bt0 = CUDART_INF_F, bt1 = CUDART_INF_F;
  int bi0 = -1, bi1 = -1;
  for (int k = 0; k < count; ++k) {
    const int j = k - 1, next = j + stages;
    if (tid == 0 && j >= 0 && next < count) {
      const int s = j % stages;
      mbar_wait(&s_empty[s], (uint32_t)(j / stages) & 1u);
      bulk_load(s_rows + s * stage_floats,
                rows + (long long)list[1 + next] * stage_floats, stage_bytes,
                &s_full[s]);
    }
    const int s = k % stages;
    mbar_wait(&s_full[s], (uint32_t)(k / stages) & 1u);
    if (__any_sync(0xffffffffu, al0 || al1)) {
      const float4* row4 =
          reinterpret_cast<const float4*>(s_rows + s * stage_floats);
      const int base = list[1 + k] * cs;
      for (int t = 0; t < cs; ++t) {
        const float4 pl = row4[t * 6], au = row4[t * 6 + 1];
        const float4 av = row4[t * 6 + 2];
        const float val = row4[t * 6 + 3].w;
        test1(r0, al0, pl, au, av, val, base + t, bt0, bi0);
        test1(r1, al1, pl, au, av, val, base + t, bt1, bi1);
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&s_empty[s]);
  }
  r0.finish_bounce(run0, cc0, bt0, bi0, rows, sc, n_bands);
  r1.finish_bounce(run1, cc1, bt1, bi1, rows, sc, n_bands);
  r0.store(st, n, ray0, n_bands);
  r1.store(st, n, ray1, n_bands);
}
'''


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"variant: {old[:60]!r} not found in the source")
    return src.replace(old, new)


def variant_sources(tree: str, parent: str) -> dict[str, str]:
    """The K2 variants' sources, from this tree's and the other checkout's
    trace_sched.cu."""
    fn = tree[tree.index("// Ray::intersect over one staged cluster"):
              tree.index(_KERNEL)]
    ring_f4 = _replace(tree, _LOOP_UNROLLED, _LOOP_PLAIN)

    def call(fn: str, *first: str) -> str:
        return (f"{fn}({', '.join(('r', *first))}, s_rows + s * "
                f"stage_floats, cs, list[1 + k] * cs, best_t, best_i);")

    return {
        "parent_f4": _replace(
            _replace(parent, _KERNEL,
                     "constexpr int kUnroll = 16;\n" + fn + _KERNEL),
            _CALL_PARENT,
            "if (alive) intersect_staged(r, s_rows, cs, c * cs, best_t, "
            "best_i);"),
        "ring_scalar": _replace(
            tree, _CALL_TREE,
            "if (alive) r.intersect(s_rows + s * stage_floats, cs, "
            "list[1 + k] * cs, best_t, best_i);"),
        "ring_f4": ring_f4,
        "ring_pretest": _replace(
            _replace(ring_f4, _KERNEL, _PRETEST + _KERNEL), _CALL_TREE,
            "if (alive) " + call("intersect_pretest")),
        "ring_wskip": _replace(
            _replace(ring_f4, _KERNEL, _WSKIP + _KERNEL), _CALL_TREE,
            call("intersect_wskip", "alive")),
        "ring_wcull": _replace(
            _replace(tree, _KERNEL, _WCULL + _KERNEL), _CALL_TREE,
            call("intersect_wcull", "alive")),
        "ring_2ray": _replace(
            _replace(ring_f4, "template <int LB>\nint launch(",
                     _TWO_RAY + "template <int LB>\nint launch("),
            _LAUNCH, "trace_sched2_kernel<LB><<<(unsigned)blocks, 64, smem, "
            "stream>>>("),
        "tree_noint": _replace(tree, _CALL_TREE, "best_t += 0.f;"),
        "parent_noint": _replace(parent, _CALL_PARENT, "best_t += 0.f;"),
    }


def load_build_module(checkout: Path, name: str):
    """A checkout's ops/_build.py as its own module: it builds that
    checkout's csrc/ into that checkout's _build/."""
    path = checkout / "audiorenderingv2_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(build, sources: dict[str, str], csrc: Path,
                   out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile each variant into its own library, side by side."""
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
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.ar2_trace_sched.argtypes = build._SIGNATURES["ar2_trace_sched"]
        lib.ar2_trace_sched.restype = ctypes.c_int
        libs[name] = lib
    return libs


def median_ms(fn, reps: int, setup=lambda: ()) -> float:
    times = []
    for r in range(reps + 1):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="another checkout of the repository")
    ap.add_argument("--rays", type=int, default=1_000_000)
    ap.add_argument("--out", type=Path,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cluster_ab: no CUDA device", file=sys.stderr)
        return 2
    from audiorenderingv2_tpu_torch import accel, constants, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import _build
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    parent_dir = args.parent.resolve()
    parent_build = load_build_module(parent_dir, "parent_build")
    libs = {"parent": parent_build.library(), "tree": _build.library()}
    tree_src = (_build.CSRC / "trace_sched.cu").read_text()
    parent_src = (parent_dir / "audiorenderingv2_tpu_torch" / "csrc" /
                  "trace_sched.cu").read_text()
    libs.update(build_variants(
        _build, variant_sources(tree_src, parent_src), _build.CSRC,
        _build.BUILD_ROOT / "ab_variants"))

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    params = TraceParams(sample_rate=16000, ir_length=32000, base_power=3.62,
                         max_bounces=32, hrtf_absorption_rate=0.9)
    sorted_scene, clusters = accel.prepare_scene(
        testing.office_scene(OFFICE_TRIS), cluster_size=32)
    rows, boxes = rc.pack_tris_clusters(tracer.scene_to_arrays(
        sorted_scene, 128, device=dev, clusters=clusters))
    cs = rows.shape[0] // boxes.shape[0]

    def k2(lib, state, sched, scal):
        err = lib.ar2_trace_sched(
            state.data_ptr(), state.shape[1], state.shape[0],
            rows.data_ptr(), cs, sched.data_ptr(), sched.shape[1],
            scal.data_ptr(), 1, state.shape[1], 1, 1, params.max_bounces,
            stream)
        assert err == 0, err
        return state

    def schedule(lib, state):
        out = torch.empty((state.shape[1] // 128,
                           sc.schedule_width(boxes.shape[0])),
                          dtype=torch.int32, device=dev)
        err = lib.ar2_tile_schedule(state.data_ptr(), state.shape[1],
                                    boxes.data_ptr(), boxes.shape[0],
                                    out.data_ptr(), out.shape[1], stream)
        assert err == 0, err
        return out

    n = args.rays
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    d = np.random.default_rng(13).normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    emitter = torch.tensor(EMITTER, device=dev)
    state = rc.init_state(torch.from_numpy(d).to(dev), emitter, e0,
                          -(-n // 128) * 128)
    scal = rc.scalars(emitter, torch.tensor(RECEIVER, device=dev), 0.0, e0,
                      params)
    states = {"round1": state.clone()}
    for k in range(16):
        state = sc.trace_round_sched(state, rows, boxes,
                                     sc.tile_schedule(state, boxes), scal,
                                     params)
        state = rc._sort_state_by_keys(state, rc._compaction_keys(state))
        if k in (0, 15):
            states[f"after{k + 1}"] = state.clone()

    result = {"device": card, "rays": n, "states": {}}
    for name, st in states.items():
        plain_rows = sc.tile_schedule_plain(st, boxes)
        for who in ("parent", "tree"):
            assert torch.equal(schedule(libs[who], st), plain_rows), \
                f"{who} schedule rows differ on {name}"
        plain = sc.trace_round_sched_plain(st.clone(), rows, boxes,
                                           plain_rows, scal, params)
        for who, lib in libs.items():
            if "noint" not in who:
                got = k2(lib, st.clone(), plain_rows, scal)
                assert torch.equal(got, plain), f"{who} K2 differs on {name}"
        live = (st[rc._C_DONE] == 0)
        counts = plain_rows[:, 0].double()
        tests = int((live.view(-1, 128).sum(1).double() * counts).sum()) * cs
        times: dict[str, list[float]] = {}
        order = list(libs.items())
        for pass_order in (order, order[::-1]):
            for who in ("parent", "tree"):
                times.setdefault(f"schedule_{who}", []).append(median_ms(
                    lambda lib=libs[who]: schedule(lib, st), 7))
            for who, lib in pass_order:
                times.setdefault(who, []).append(median_ms(
                    lambda s, lib=lib: k2(lib, s, plain_rows, scal), 7,
                    setup=lambda: (st.clone(),)))
        row = {
            "candidates_per_live_tile": float(counts[counts > 0].mean()),
            "tests": tests,
            "k2_bound_ms": tests * TRI_TEST_OPS / FP32_OPS_PER_S * 1e3,
            "schedule_bytes_bound_ms": (7 * 4 * st.shape[1]
                                        + boxes.numel() * 4
                                        + plain_rows.numel() * 4)
            / HBM_BYTES_PER_S * 1e3,
            "schedule_all_pairs_ms": int(live.sum()) * boxes.shape[0]
            * SLAB_TEST_OPS / FP32_OPS_PER_S * 1e3,
            "ms": times}
        result["states"][name] = row
        print(f"{name}: {row['candidates_per_live_tile']:.2f} candidates per "
              f"live tile, K2 bound {row['k2_bound_ms']:.4f} ms; " + "; ".join(
                  f"{k} {v[0]:.3f}/{v[1]:.3f}" for k, v in times.items()),
              flush=True)
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
