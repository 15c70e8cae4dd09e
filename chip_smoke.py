#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (audiorenderingv2_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu with nvcc (timed);
3. K3, the histogram kernel, against its plain version (index_add_) and a
   float64 reference, on 1M seeded events (30% out of range) at 1 and 4
   bands; times of both;
4. K1, the bounce-round kernel, against its plain version on the card: all
   state columns after an 8-bounce round, and the IR after 100 bounces, at
   64k rays; then at the export path's 1M rays through its round budgets
   (8, 24, 68) with the alive-first partition between rounds, all columns
   after rounds 1 and 2 and the IR after round 3; times of both;
5. the export path as a user runs it (config.json -> load_context ->
   export_audio) at 1M rays, 100 bounces, a 2 s IR at 16 kHz, with both
   kernels' launch counts read around it; its IR is checked against the CPU
   plain path on 64k shared directions; render and convolve times;
6. the clustered route's kernels on the office scene of
   benchmarks/large_scene.py (19,852 triangles, 621 clusters of 32, 32
   bounces): K1's multi-chunk branch (39 chunks of 512 rows) against its
   plain version after an 8-bounce round at 64k rays; the schedule kernel
   against its plain version at 1M rays, integer for integer, on the state
   after one bounce; K2 against its plain version over two clustered
   rounds (schedule, K2, coherent sort) at 1M rays, the chains run apart,
   every column after each round; the clustered IR against K1's over all
   rows on 64k shared directions; times of both kernels and their plain
   versions, and of the sort;
7. the office export as a user runs it (config.json -> load_context ->
   export_audio, 1M rays, 32 bounces) with the launch counts read around
   it: the schedule kernel and K2 run, K1 does not; render times, median of
   3, of the clustered route and of K1 over all rows on the same scene.

Then one JSON line per the kernels (name, route, source, the TPU kernel it
replaces, launches in the export of phase 5 or, for the clustered route's
kernels, of phase 7, max abs error, ms, plain ms) and, last, the result
line. With no CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N_RAYS = 1_000_000
SR = 16000
IR_SECONDS = 2
MAX_BOUNCES = 100
ROOM = (14.0, 9.0, 11.0)      # the bench's procedural box, centred at 0
EMITTER = (0.0, 0.0, 0.0)
RECEIVER = (2.5, 1.5, 2.0)    # inside the room
ABSORPTION = 0.3
# The JAX package's large-scene workload (benchmarks/large_scene.py:61-82).
OFFICE_TRIS = 20000
OFFICE_BOUNCES = 32
OFFICE_RECEIVER = (6.0, 1.0, -8.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, setup=lambda: ()) -> float:
    """Median CUDA-event time of ``fn(*setup())`` over ``reps`` runs after
    one warm-up; ``setup`` runs outside the timed window."""
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


def unit_dirs(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def assert_columns_close(kern: torch.Tensor, plain: torch.Tensor,
                         what: str) -> None:
    """Every state column of ``kern`` within rtol 1e-5 of ``plain`` (atol
    1e-5 of the column's scale)."""
    for c in range(kern.shape[0]):
        scale = float(plain[c].abs().max()) or 1.0
        assert torch.allclose(kern[c], plain[c], rtol=1e-5,
                              atol=1e-5 * scale), f"{what}, column {c} differs"


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    log(smi)
    return name


def phase_build() -> None:
    from audiorenderingv2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{lib_path.relative_to(REPO)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "ptxas info" in line or "spill" in line or line.startswith("#"):
            log(f"  {line.strip()}")


def phase_histogram() -> dict:
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc

    n_bins = 2 * IR_SECONDS * SR
    n_events = -(-N_RAYS // 128) * 128  # the export path's n_pad
    rng = np.random.default_rng(3)
    bins = rng.integers(0, n_bins, size=n_events)
    out = rng.random(n_events) < 0.3
    bins[out] = np.where(rng.random(out.sum()) < 0.5,
                         -rng.integers(1, 1000, size=out.sum()),
                         n_bins + rng.integers(0, 1000, size=out.sum()))
    bins = bins.astype(np.int32)
    result = {}
    for n_bands in (1, 4):
        w = (rng.random((n_events, n_bands)) * 2e-9).astype(np.float32)
        b_d = torch.from_numpy(bins).cuda()
        w_d = torch.from_numpy(w).cuda()
        kern = hc.histogram_sum_banded(b_d, w_d, n_bins)
        plain = hc.histogram_plain(b_d, w_d, n_bins)
        torch.cuda.synchronize()
        keep = (bins >= 0) & (bins < n_bins)
        ref = np.stack([np.bincount(bins[keep], weights=w[keep, k]
                                    .astype(np.float64), minlength=n_bins)
                        for k in range(n_bands)], axis=1)
        k_np, p_np = kern.cpu().numpy(), plain.cpu().numpy()
        occ = ref > 0
        rel_k = np.abs(k_np[occ] - ref[occ]) / ref[occ]
        rel_p = np.abs(p_np[occ] - ref[occ]) / ref[occ]
        rel_kp = np.abs(k_np[occ] - p_np[occ]) / np.abs(p_np[occ])
        err = float(np.abs(k_np - p_np).max())
        # atomics add in a run-dependent order: a few ulp over ~11 terms
        assert rel_kp.max() < 1e-5, ("K3 vs plain", rel_kp.max())
        assert np.median(rel_k) < 1e-6 and np.median(rel_p) < 1e-6, \
            ("K3 vs float64", np.median(rel_k), np.median(rel_p))
        assert not np.any(k_np[~occ]), "K3 wrote a bin no event maps to"
        ms = median_ms(lambda: hc.histogram_sum_banded(b_d, w_d, n_bins), 20)
        plain_ms = median_ms(lambda: hc.histogram_plain(b_d, w_d, n_bins),
                             20)
        log(f"K3 histogram, {n_events} events x {n_bands} band(s) -> "
            f"{n_bins} bins: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"max abs err vs plain {err:.3e}, median rel err vs float64 "
            f"{np.median(rel_k):.3e}")
        result[n_bands] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result[1]


def _box_scene():
    from audiorenderingv2_tpu_torch import testing

    return testing.scene_from_arrays(*testing.box_room(ROOM), ABSORPTION)


def phase_trace() -> dict:
    from audiorenderingv2_tpu_torch import constants, testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    sc = tracer.scene_to_arrays(_box_scene(), device=dev)
    rows = rc.pack_tris_rows(sc)
    params = TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                         base_power=3.62, max_bounces=MAX_BOUNCES,
                         hrtf_absorption_rate=0.9)
    emitter = torch.tensor(EMITTER, device=dev)
    receiver = torch.tensor(RECEIVER, device=dev)

    def start_state(n):
        e0 = params.base_power / (n * constants.SPHERE_VOLUME)
        d = torch.from_numpy(unit_dirs(n, 11)).to(dev)
        n_pad = -(-n // 128) * 128
        return (rc.init_state(d, emitter, e0, n_pad),
                rc.scalars(emitter, receiver, 30.0, e0, params))

    # All state columns after one 8-bounce round, 64k rays.
    state, scal = start_state(65536)
    kern = rc.trace_round(state.clone(), rows, scal, params, 8)
    plain = rc.trace_round_plain(state.clone(), rows, scal, params, 8)
    torch.cuda.synchronize()
    assert torch.isfinite(kern).all()
    err = float((kern - plain).abs().max())
    assert_columns_close(kern, plain, "K1")
    n_eq = int((kern == plain).all(dim=0).sum())
    log(f"K1 8-bounce round, 65536 rays: every column within rtol 1e-5; "
        f"max abs err {err:.3e}; {n_eq} of {kern.shape[1]} rays "
        f"bit-identical")

    # The IR after 100 bounces (one round each, the same histogram step).
    kern = rc.trace_round(state.clone(), rows, scal, params, MAX_BOUNCES)
    plain = rc.trace_round_plain(state.clone(), rows, scal, params,
                                 MAX_BOUNCES)

    def ir_of(st):
        return tracer._histogram_from_events(
            st[rc._C_EVB], st[rc._C_EVW][:, None].contiguous(),
            st[rc._C_EVE].to(torch.int32), params, False).cpu()

    ir_k, ir_p = ir_of(kern), ir_of(plain)
    testing.assert_ir_close(ir_k.numpy(), ir_p.numpy(), exact=False)
    ms100 = median_ms(lambda s: rc.trace_round(s, rows, scal, params,
                                               MAX_BOUNCES), 5,
                      setup=lambda: (state.clone(),))
    plain100 = median_ms(
        lambda s: rc.trace_round_plain(s, rows, scal, params, MAX_BOUNCES),
        3,
        setup=lambda: (state.clone(),))
    log(f"K1 100 bounces in one round, 65536 rays: IR passes "
        f"assert_ir_close(exact=False); energy kernel "
        f"{float(ir_k.sum()):.6e} plain {float(ir_p.sum()):.6e}; per-ear "
        f"nonzero bins {(ir_k > 0).sum(dim=1).tolist()}; kernel "
        f"{ms100:.3f} ms, plain {plain100:.3f} ms")

    # The export path's shape and schedule: 1M rays through its round
    # budgets with the alive-first partition between rounds, the kernel's
    # chain and the plain chain run apart. Every column must agree after
    # each of the first two rounds; after the last, the IR.
    state, scal = start_state(N_RAYS)
    budgets = tuned.round_budgets_for(MAX_BOUNCES)
    kern, plain = state.clone(), state.clone()
    err = 0.0
    for k, budget in enumerate(budgets):
        if k:
            kern = rc._partition_alive_first(kern)
            plain = rc._partition_alive_first(plain)
        kern = rc.trace_round(kern, rows, scal, params, budget)
        plain = rc.trace_round_plain(plain, rows, scal, params, budget)
        torch.cuda.synchronize()
        assert torch.isfinite(kern).all(), f"K1 round {k + 1} not finite"
        n_eq = int((kern == plain).all(dim=0).sum())
        alive = int((kern[rc._C_DONE] == 0.0).sum())
        if k + 1 < len(budgets):
            err = max(err, float((kern - plain).abs().max()))
            assert_columns_close(kern, plain,
                                 f"K1 round {k + 1} (budget {budget})")
            verdict = "every column within rtol 1e-5"
        else:
            ir_k, ir_p = ir_of(kern), ir_of(plain)
            testing.assert_ir_close(ir_k.numpy(), ir_p.numpy(), exact=False)
            verdict = (f"IR passes assert_ir_close(exact=False), energy "
                       f"kernel {float(ir_k.sum()):.6e} plain "
                       f"{float(ir_p.sum()):.6e}")
        log(f"K1 round {k + 1} (budget {budget}), {kern.shape[1]} rays: "
            f"{verdict}; {n_eq} rays bit-identical; {alive} alive after")

    # Times at that shape: its first round (8).
    ms = median_ms(lambda s: rc.trace_round(s, rows, scal, params,
                                            budgets[0]), 5,
                   setup=lambda: (state.clone(),))
    plain_ms = median_ms(
        lambda s: rc.trace_round_plain(s, rows, scal, params, budgets[0]), 3,
        setup=lambda: (state.clone(),))
    log(f"K1 first round ({budgets[0]} bounces), {state.shape[1]} rays, "
        f"{rows.shape[0]} triangle rows: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; max abs err over the column-checked rounds "
        f"{err:.3e}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _write_inputs(tmp: Path, scene_file: str = "room.obj",
                  receiver=RECEIVER, max_bounces: int = MAX_BOUNCES) -> Path:
    """The dry signal and config.json in ``tmp`` for the scene file that
    the caller wrote there."""
    from audiorenderingv2_tpu_torch.io import wav

    rng = np.random.default_rng(7)
    t = np.arange(5 * SR) / SR
    dry = 0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    dry += 0.2 * rng.standard_normal(t.size) * (np.sin(2 * np.pi * t) > 0.7)
    wav.write_wav(tmp / "dry.wav", dry[None, :].astype(np.float32), SR)
    cfg = {
        "renderer_parameters": {"ir_length_in_seconds": IR_SECONDS},
        "scene_parameters": {
            "mono": False, "audio_file_path": "dry.wav",
            "scene_file_path": scene_file,
            "initial_emitter_pos": dict(zip("xyz", EMITTER)),
            "initial_receiver_pos": dict(zip("xyz", receiver))},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": {"x": 100, "y": 100, "z": 100},
            "ray_energy_threshold": 0.0, "ray_max_bounces": max_bounces,
            "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls", "mat_absorption": ABSORPTION}]},
    }
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path


def phase_export() -> dict:
    from audiorenderingv2_tpu_torch import context, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.io import wav
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    with tempfile.TemporaryDirectory() as tmp:
        testing.write_box_obj(Path(tmp) / "room.obj", ROOM, material="walls")
        cfg = _write_inputs(Path(tmp))
        out_path = Path(tmp) / "export.wav"
        rc.launches = 0
        hc.launches = 0
        t0 = time.perf_counter()
        ctx = context.load_context(cfg, device="cuda")
        context.export_audio(ctx, out_path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"trace_round": rc.launches, "histogram": hc.launches}
        log(f"export: {wall:.2f} s wall (first call, scene load included); "
            f"launches {launches}")
        assert launches["trace_round"] > 0 and launches["histogram"] > 0, \
            launches

        audio = wav.read_wav(out_path)
        assert audio.n_channels == 2 and audio.sample_rate == SR, \
            (audio.n_channels, audio.sample_rate)
        assert audio.n_frames == 5 * SR and np.isfinite(audio.samples).all()
        peaks = np.abs(audio.samples).max(axis=1)
        assert np.all(np.abs(peaks - 1.0) < 1e-3), peaks
        r = ctx.renderer
        ir = r.ir
        assert ir.shape == (2, IR_SECONDS * SR) and np.isfinite(ir).all()
        nz = (ir > 0).sum(axis=1)
        assert np.all(nz >= 200), nz
        log(f"export: WAV stereo {SR} Hz, {audio.n_frames} frames, peaks "
            f"{peaks.tolist()}; IR nonzero bins per ear {nz.tolist()}, "
            f"energy {ir.sum(axis=1).tolist()}")

        # The slice on the card against the CPU plain path, 64k directions.
        d = unit_dirs(65536, 5)
        args = (r.emitter_pos, r.receiver_pos, r.receiver_yaw_deg, r.params,
                r.opts)
        ir_gpu = tracer.trace_ir(r.sc, torch.from_numpy(d).cuda(), *args)
        ir_cpu = tracer.trace_ir(tracer.scene_to_arrays(ctx.scene),
                                 torch.from_numpy(d), *args)
        testing.assert_ir_close(ir_gpu.cpu().numpy(), ir_cpu.numpy(),
                                exact=False)
        log("export path, 65536 shared directions: CUDA IR passes "
            "assert_ir_close(exact=False) against the CPU plain path")

        render_ms = median_ms(r.render, 5)
        samples = torch.from_numpy(ctx.audio.mono()).cuda()
        conv_ms = median_ms(lambda: r.convolve_audio_file_device(samples), 5)
        log(f"export path timings ({N_RAYS} rays, {MAX_BOUNCES} bounces, "
            f"{IR_SECONDS} s IR at {SR} Hz, 5 s signal): render "
            f"{render_ms:.3f} ms (median of 5), convolve {conv_ms:.3f} ms")
    return launches


def _office_params():
    from audiorenderingv2_tpu_torch.core.params import TraceParams

    return TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                       base_power=3.62, max_bounces=OFFICE_BOUNCES,
                       hrtf_absorption_rate=0.9)


def phase_cluster_kernels(n_rays: int = N_RAYS) -> dict:
    """K1's multi-chunk branch, the schedule kernel and K2 against their
    plain versions on the office scene, and the clustered IR against K1's;
    returns the JSON entries' numbers of the two new kernels."""
    from audiorenderingv2_tpu_torch import accel, constants, testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    dev = torch.device("cuda")
    params = _office_params()
    emitter = torch.tensor(EMITTER, device=dev)
    receiver = torch.tensor(OFFICE_RECEIVER, device=dev)
    scene = testing.office_scene(OFFICE_TRIS)

    def start_state(n, seed):
        e0 = params.base_power / (n * constants.SPHERE_VOLUME)
        d = torch.from_numpy(unit_dirs(n, seed)).to(dev)
        return (rc.init_state(d, emitter, e0, -(-n // 128) * 128),
                rc.scalars(emitter, receiver, 0.0, e0, params))

    # K1 over every row of the unsorted scene: its multi-chunk branch.
    flat = tracer.scene_to_arrays(scene, 128, device=dev)
    rows_flat = rc.pack_tris_rows(flat)
    state, scal = start_state(65536, 12)
    kern = rc.trace_round(state.clone(), rows_flat, scal, params, 8)
    plain = rc.trace_round_plain(state.clone(), rows_flat, scal, params, 8)
    torch.cuda.synchronize()
    assert torch.isfinite(kern).all(), "K1 multi-chunk not finite"
    assert_columns_close(kern, plain, "K1 multi-chunk round")
    n_eq = int((kern == plain).all(dim=0).sum())
    k1_ms = median_ms(lambda s: rc.trace_round(s, rows_flat, scal, params,
                                               8), 3,
                      setup=lambda: (state.clone(),))
    log(f"K1 multi-chunk, office scene ({scene.n_triangles} triangles, "
        f"{rows_flat.shape[0]} rows = {-(-rows_flat.shape[0] // 512)} "
        f"chunks of 512), 8-bounce round, 65536 rays: every column within "
        f"rtol 1e-5; max abs err {float((kern - plain).abs().max()):.3e}; "
        f"{n_eq} of {kern.shape[1]} rays bit-identical; kernel "
        f"{k1_ms:.3f} ms")

    sorted_scene, clusters = accel.prepare_scene(scene, cluster_size=32)
    scc = tracer.scene_to_arrays(sorted_scene, 128, device=dev,
                                 clusters=clusters)
    rows, boxes = rc.pack_tris_clusters(scc)
    log(f"office clustered: {rows.shape[0]} rows, {boxes.shape[0]} "
        f"clusters of {rows.shape[0] // boxes.shape[0]}, schedule width "
        f"{sc.schedule_width(boxes.shape[0])}")

    # The schedule kernel on the state after one bounce (some rays done).
    state, scal = start_state(n_rays, 13)
    st1 = sc.trace_round_sched(state.clone(), rows, boxes,
                               sc.tile_schedule(state, boxes), scal, params)
    st1 = rc._sort_state_by_keys(st1, rc._compaction_keys(st1))
    sched_k = sc.tile_schedule(st1, boxes)
    sched_p = sc.tile_schedule_plain(st1, boxes)
    torch.cuda.synchronize()
    assert torch.equal(sched_k, sched_p), "schedule kernel rows differ"
    counts = sched_k[:, 0].double()
    n_done = int((st1[rc._C_DONE] != 0).sum())
    live = counts > 0
    sched_ms = median_ms(lambda: sc.tile_schedule(st1, boxes), 10)
    sched_plain_ms = median_ms(lambda: sc.tile_schedule_plain(st1, boxes),
                               2)
    sort_ms = median_ms(
        lambda: rc._sort_state_by_keys(st1, rc._compaction_keys(st1)), 10)
    log(f"schedule after one bounce and the sort, {st1.shape[1]} rays "
        f"({n_done} done), {sched_k.shape[0]} tiles: kernel rows equal the "
        f"plain rows; candidates per live tile mean "
        f"{float(counts[live].mean()):.2f}, max {int(counts.max())}; "
        f"triangle tests per ray {float(counts[live].mean()) * 32:.1f}; "
        f"kernel {sched_ms:.3f} ms, plain {sched_plain_ms:.3f} ms; keys + "
        f"sort + gather {sort_ms:.3f} ms")

    # K2 and its plain version, two clustered rounds, the chains apart.
    kern, plain = state.clone(), state.clone()
    k2_err = 0.0
    for k in range(2):
        sk = sc.tile_schedule(kern, boxes)
        sp = sc.tile_schedule_plain(plain, boxes)
        kern = sc.trace_round_sched(kern, rows, boxes, sk, scal, params)
        plain = sc.trace_round_sched_plain(plain, rows, boxes, sp, scal,
                                           params)
        torch.cuda.synchronize()
        assert torch.isfinite(kern).all(), f"K2 round {k + 1} not finite"
        assert_columns_close(kern, plain, f"K2 round {k + 1}")
        k2_err = max(k2_err, float((kern - plain).abs().max()))
        n_eq = int((kern == plain).all(dim=0).sum())
        perm_k = torch.sort(rc._compaction_keys(kern), stable=True).indices
        perm_p = torch.sort(rc._compaction_keys(plain), stable=True).indices
        same = torch.equal(perm_k, perm_p)
        # Both chains take the plain chain's order, so that the columns of
        # the next round compare ray for ray.
        kern = kern.index_select(1, perm_p)
        plain = plain.index_select(1, perm_p)
        log(f"K2 round {k + 1}, {kern.shape[1]} rays: every column within "
            f"rtol 1e-5; {n_eq} rays bit-identical; "
            f"{int((kern[rc._C_DONE] == 0).sum())} alive after; the chains' "
            f"sort orders {'agree' if same else 'DIFFER'}")
    k2_ms = median_ms(lambda s: sc.trace_round_sched(s, rows, boxes, sched_k,
                                                     scal, params), 5,
                      setup=lambda: (st1.clone(),))
    k2_plain_ms = median_ms(
        lambda s: sc.trace_round_sched_plain(s, rows, boxes, sched_k, scal,
                                             params), 2,
        setup=lambda: (st1.clone(),))
    log(f"K2 one round on the state after one bounce, {st1.shape[1]} rays: "
        f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms; max abs err "
        f"over the two rounds {k2_err:.3e}")

    # The clustered IR against K1 over every row, 64k shared directions.
    d = torch.from_numpy(unit_dirs(65536, 14)).to(dev)
    args = (EMITTER, OFFICE_RECEIVER, 0.0, params)
    ir_c = tracer.trace_ir(scc, d, *args).cpu().numpy()
    ir_r = tracer.trace_ir(flat, d, *args, tracer.TracerOptions(
        round_budgets=tuned.round_budgets_for(OFFICE_BOUNCES))).cpu().numpy()
    testing.assert_ir_close(ir_c, ir_r, exact=False)
    log(f"office IR, 65536 shared directions, {OFFICE_BOUNCES} bounces: the "
        f"clustered route passes assert_ir_close(exact=False) against K1 "
        f"over every row; energy {float(ir_c.sum()):.6e} / "
        f"{float(ir_r.sum()):.6e}; relative L1 "
        f"{float(np.abs(ir_c - ir_r).sum() / np.abs(ir_r).sum()):.3e}")
    return {
        "trace_round_sched": {"max_abs_err": k2_err, "ms": k2_ms,
                              "plain_ms": k2_plain_ms},
        "tile_schedule": {
            "max_abs_err": float((sched_k - sched_p).abs().max()),
            "ms": sched_ms, "plain_ms": sched_plain_ms},
    }


def phase_office_export() -> dict:
    """The office export on the clustered route, and render times of both
    routes on the same scene; returns the clustered export's launches."""
    from audiorenderingv2_tpu_torch import context, testing, tuned
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.io import wav
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        testing.write_obj(Path(tmp) / "office.obj",
                          *testing.office_mesh(OFFICE_TRIS))
        cfg = _write_inputs(Path(tmp), "office.obj", OFFICE_RECEIVER,
                            OFFICE_BOUNCES)
        rc.launches = hc.launches = 0
        sc.tile_schedule_launches = sc.trace_round_sched_launches = 0
        ctx = context.load_context(cfg, device="cuda")
        context.export_audio(ctx, Path(tmp) / "office.wav")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = ctx.renderer
        r_clusters = None if r.boxes is None else r.boxes.shape[0]
        launches = {"trace_round": rc.launches, "histogram": hc.launches,
                    "tile_schedule": sc.tile_schedule_launches,
                    "trace_round_sched": sc.trace_round_sched_launches}
        log(f"office export: {wall:.2f} s wall (obj written and loaded, "
            f"scene sorted and clustered, first call); {r_clusters} "
            f"clusters; launches {launches}")
        assert launches["trace_round"] == 0, launches
        assert launches["tile_schedule"] == OFFICE_BOUNCES, launches
        assert launches["trace_round_sched"] == OFFICE_BOUNCES, launches
        assert launches["histogram"] > 0, launches
        assert r.boxes is not None
        audio = wav.read_wav(Path(tmp) / "office.wav")
        assert audio.n_channels == 2 and audio.sample_rate == SR
        assert np.isfinite(audio.samples).all()
        peaks = np.abs(audio.samples).max(axis=1)
        assert np.all(np.abs(peaks - 1.0) < 1e-3), peaks
        ir = r.ir
        assert ir.shape == (2, IR_SECONDS * SR) and np.isfinite(ir).all()
        nz = (ir > 0).sum(axis=1)
        assert np.all(nz >= 200), nz
        log(f"office export: WAV stereo {SR} Hz, peaks {peaks.tolist()}; IR "
            f"nonzero bins per ear {nz.tolist()}, energy "
            f"{ir.sum(axis=1).tolist()}")

        rows_r = AudioRenderer(
            ctx.scene, IR_SECONDS, SR, r.n_rays, base_power=3.62,
            max_bounces=OFFICE_BOUNCES, hrtf_absorption_rate=0.9,
            opts=TracerOptions(
                round_budgets=tuned.round_budgets_for(OFFICE_BOUNCES)),
            device="cuda")
        rows_r.set_emitter_pos(r.emitter_pos)
        rows_r.set_receiver(r.receiver_pos, r.receiver_yaw_deg)
        assert rows_r.boxes is None
        clustered_ms = median_ms(r.render, 3)
        rows_ms = median_ms(rows_r.render, 3)
        log(f"office render ({r.n_rays} rays, {OFFICE_BOUNCES} bounces, "
            f"{IR_SECONDS} s IR at {SR} Hz), median of 3: clustered "
            f"{clustered_ms:.3f} ms, K1 over all {rows_r.rows.shape[0]} rows "
            f"{rows_ms:.3f} ms; rows / clustered "
            f"{rows_ms / clustered_ms:.2f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # Geometry must not run in TF32 anywhere (trouble spot: matmul bits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    import audiorenderingv2_tpu_torch  # noqa: F401  (fails outside the repo)

    kind = phase_device()
    phase_build()
    k3 = phase_histogram()
    k1 = phase_trace()
    launches = phase_export()
    cluster = phase_cluster_kernels()
    office = phase_office_export()
    kernels = [
        {"name": "trace_round", "route": "cuda",
         "source": "audiorenderingv2_tpu_torch/csrc/trace_round.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:799",
         "launches": launches["trace_round"], **k1},
        {"name": "histogram", "route": "cuda",
         "source": "audiorenderingv2_tpu_torch/csrc/histogram.cu",
         "replaces": "audiorenderingv2_tpu/ops/histogram_pallas.py:59",
         "launches": launches["histogram"], **k3},
        {"name": "trace_round_sched", "route": "cuda",
         "source": "audiorenderingv2_tpu_torch/csrc/trace_sched.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:501",
         "launches": office["trace_round_sched"],
         **cluster["trace_round_sched"]},
        {"name": "tile_schedule", "route": "cuda",
         "source": "audiorenderingv2_tpu_torch/csrc/tile_schedule.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:1103",
         "launches": office["tile_schedule"], **cluster["tile_schedule"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
