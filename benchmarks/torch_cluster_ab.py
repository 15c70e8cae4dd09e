"""A/B of the PyTorch port's clustered-route kernels on one NVIDIA GPU.

The schedule kernel (csrc/tile_schedule.cu) and K2 (csrc/trace_sched.cu)
of this checkout against those of another checkout of the repository (for
example the parent commit, unpacked with ``git archive``), on three states
of the office render (benchmarks/large_scene.py's scene, 19,852 triangles in
621 clusters of 32, 1M rays): round 1 (the start state, unsorted), after
one bounce and the sort, after 16 bounces.

    python3 benchmarks/torch_cluster_ab.py --parent DIR [--rays N]
                                           [--out FILE]

This checkout's K2 is held bit for bit against K2's plain version, and
both schedules' rows against the plain rows, on every state; the rays on
which the other checkout's K2 differs from the plain version are counted. Each state also
gives K2's test count both ways: the tile union (every live ray of a tile
tests every candidate) and under the per-warp cull (a warp's live rays
test the candidates one of them reaches nearer than its hit so far), each
with its bound. (The K2 lever
variants that PERF.md section 6 cites live in the history of this script,
at the commit that redesigned K2.)

Times are CUDA-event medians of 7 launches after one warm-up, in two
passes (forward and reverse order). Prints one JSON line (and writes it
to ``--out`` when given); exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
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

def load_build_module(checkout: Path, name: str):
    """A checkout's ops/_build.py as its own module: it builds that
    checkout's csrc/ into that checkout's _build/."""
    path = checkout / "audiorenderingv2_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call_k2(lib, state, rows, cs: int, boxes, sched, scal,
            max_bounces: int, stream) -> None:
    """One single-pose, one-band launch of a library's K2 C entry, in the
    form that library takes: since the per-warp cull it also takes the
    boxes and a visits pointer (null here)."""
    culled = len(lib.ar2_trace_sched.argtypes) == 16
    err = lib.ar2_trace_sched(
        state.data_ptr(), state.shape[1], state.shape[0], rows.data_ptr(),
        cs, *((boxes.data_ptr(),) if culled else ()), sched.data_ptr(),
        sched.shape[1], scal.data_ptr(), 1, state.shape[1], 1, 1,
        max_bounces, *((None,) if culled else ()), stream)
    assert err == 0, err


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
        call_k2(lib, state, rows, cs, boxes, sched, scal, params.max_bounces,
                stream)
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
        differ = {}
        for who, lib in libs.items():
            got = k2(lib, st.clone(), plain_rows, scal)
            differ[who] = int((got != plain).any(dim=0).sum())
        # The other checkout's K2 may differ by design; this tree's may not.
        assert differ["tree"] == 0, f"tree K2 differs on {name}: {differ}"
        live = (st[rc._C_DONE] == 0)
        counts = plain_rows[:, 0].double()
        tests = int((live.view(-1, 128).sum(1).double() * counts).sum()) * cs
        # Under the per-warp cull a warp's live rays test only the
        # candidates one of them reaches nearer than its hit so far.
        tested = sc.k2_search(st, rows, boxes, plain_rows, scal,
                              params)[3].double()
        warp_tests = int((live.view(-1, 32).sum(1).double()
                          * tested).sum()) * cs
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
            "rays_differing_from_plain": differ,
            "warp_pairs": int(tested.sum()),
            "union_pairs": 4 * int(counts.sum()),
            "warp_tests": warp_tests,
            "k2_warp_bound_ms": warp_tests * TRI_TEST_OPS / FP32_OPS_PER_S
            * 1e3,
            "schedule_bytes_bound_ms": (7 * 4 * st.shape[1]
                                        + boxes.numel() * 4
                                        + plain_rows.numel() * 4)
            / HBM_BYTES_PER_S * 1e3,
            "schedule_all_pairs_ms": int(live.sum()) * boxes.shape[0]
            * SLAB_TEST_OPS / FP32_OPS_PER_S * 1e3,
            "ms": times}
        result["states"][name] = row
        print(f"{name}: {row['candidates_per_live_tile']:.2f} candidates per "
              f"live tile, K2 bound {row['k2_bound_ms']:.4f} ms (warp-culled "
              f"{row['k2_warp_bound_ms']:.4f}: {warp_tests} of {tests} "
              f"tests); rays differing from the plain K2 {differ}; "
              + "; ".join(
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
