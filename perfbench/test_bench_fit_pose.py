"""The source localization's cell (``office_locate.fit_pose``) and the box's
fit (``box.fit``) rehearsed on the CPU at test size, the localization's
check against the precision control and its planted faults, the readers of
its two per-layer metrics on hand-made traces, the pose replay's byte count
against a hand count, and the manifest's new entries.

    python -m pytest perfbench/test_bench_fit_pose.py -q
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import (calibrate_pose, devtrace, harness, replay_bytes,
                       replay_pose_bytes, yardstick)
from perfbench.run import run_cell

torch.set_num_threads(2)

CELL = "office_locate.fit_pose"
SEED = 2**31 + 2909


POSE_CHECKS = ("loss_gap", "grad_gap", "change_gap", "emitter_grad_gap",
               "emitter_arrival_gap", "emitter_chord_gap")
# The numbers each planted fault has to fail: the tangent faults those of
# the tangents they break.
FAILS = {"jacobian": ("emitter_arrival_gap", "emitter_chord_gap"),
         "chord": ("emitter_chord_gap",), "entry": ("emitter_arrival_gap",),
         "half": ("grad_gap",)}


def tiny(name: str = CELL) -> "harness.Cell":
    cell = harness.cell_from_manifest(harness.load_manifest(), name)
    cell.config["rays"] = 1024 if name == CELL else 4096
    cell.config["max_bounces"] = 16
    if "n_triangles_target" in cell.config["scene"]:
        cell.config["scene"]["n_triangles_target"] = 700
    return cell


def quiet(_line):
    pass


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace):
    cell = tiny()
    out, checks = run_cell(cell, SEED, 0.5, bool(trace), "cpu", log=quiet)
    assert out["correct"], checks
    assert set(checks) == set(POSE_CHECKS)
    assert out["attempted"] >= 3 and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {"step_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"replay_pose_ms.fit_pose", "replay_pose_roofline.fit_pose",
            "launches_per_step.fit", "device_idle_pct.fit",
            "program_idle_ms.fit", "replay_launches_per_step.fit",
            "record_ms.fit"} == names


def test_box_fit_rehearsal():
    """``box.fit``: the accepted ``fit`` traffic and driver on the box."""
    cell = tiny("box.fit")
    assert cell.traffic["driver"] == "fit"
    out, checks = run_cell(cell, SEED, 0.3, False, "cpu", log=quiet)
    assert out["correct"], checks
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap"}
    assert set(out["metrics"]) == {"step_ms", "setup_s"}


def test_start_emitter_and_targets():
    """The start lies 0.5-1.0 m from the true source, clear of the mesh,
    the same for a seed; each receiver's target starts at its distance
    over the speed of sound, at the first receiver's level scaled by the
    squared ratio of distances."""
    cell = tiny()
    d = cell.driver.Driver(cell, "cpu", log=quiet)
    for seed in (SEED, SEED + 1, 3):
        _, target = d._inputs(seed)
        off = np.linalg.norm(d.start - d.true_emitter)
        assert 0.5 <= off <= 1.0 and min(d.clearance(d.start)) >= 0.25
        first = d.start.copy()
        d._inputs(seed)
        assert np.array_equal(first, d.start)
        dist = np.linalg.norm(d.receivers - d.true_emitter, axis=1)
        onset = (target.sum(1) > 0).float().argmax(-1).numpy()
        assert np.all(np.abs(onset - dist / 343.0 * 16000) <= 1.0)
        assert target.shape == (3, 2, 32000)


def test_control_fails():
    """The localization's reference in bfloat16 in the program's place."""
    cell = tiny()
    d = cell.driver.Driver(cell, "cpu", log=quiet)
    d.setup(SEED)
    d.begin(SEED)
    harness.run_window(d, 0.2)
    got = d.check(control=torch.bfloat16)
    assert any(v > cell.limits[n] for n, v in got.items()), got


@pytest.mark.parametrize("fault", calibrate_pose.FAULTS)
def test_faults_are_caught(fault):
    """``calibrate_pose``'s planted faults at test size, planted through
    the window and the check: each fails the limits of the numbers it
    breaks (half the rays the logit's gradient; each tangent fault the
    tangents it breaks, and no other tangent)."""
    cell = tiny()
    d = cell.driver.Driver(cell, "cpu", log=quiet)
    d.setup(SEED)
    d.begin(SEED)
    with calibrate_pose.planted(d, fault):
        harness.run_window(d, 0.2)
        got = d.check()
    failed = {n for n, v in got.items() if v > cell.limits[n]}
    assert set(FAILS[fault]) <= failed, (fault, got)
    if fault in ("chord", "entry"):
        assert failed.isdisjoint({"emitter_arrival_gap", "emitter_chord_gap"}
                                 - set(FAILS[fault])), (fault, got)


def test_tangents_are_compared_on_the_paths_recorded_alike():
    """At 16 bounces the program records the reference's paths: its
    triangle ids, taken back to the mesh's, equal the reference's on every
    deposit, and the deposits kept for the tangents are those whose half
    chord is at least ``S_FLOOR``."""
    from perfbench.drivers import fit_pose

    cell = tiny()
    d = cell.driver.Driver(cell, "cpu", log=quiet)
    d.setup(SEED)
    d.begin(SEED)
    harness.run_window(d, 0.2)
    d.check()
    assert len(d.tangent_diag) == 3
    for r in d.tangent_diag:
        assert r["deposits"] > 20 and r["alike"] == r["deposits"], r
        assert r["reference_only"] == r["other_only"] == 0, r
        assert 0 < r["kept"] < r["alike"], r
    assert fit_pose.S_FLOOR == 0.3


def test_judge():
    from perfbench.drivers import fit_pose

    start = np.array([1.0, 0.0, 0.0])
    ref = [(2.0, 0.5, -0.03, torch.tensor([3.0, 4.0, 0.0]),
            torch.tensor([1.03, -0.03, 0.0]))]
    got = [(2.0, 0.5, -0.03, torch.tensor([3.0, 4.0, 0.0]),
            torch.tensor([1.03, -0.03, 0.0]))]
    d = fit_pose.Driver.judge(got, ref, 0.5, start)
    assert all(v == pytest.approx(0.0, abs=1e-12) for v in d.values()), d
    got[0] = (2.0, 0.5, -0.03, torch.tensor([3.0, 4.0, 5.0]),
              torch.tensor([1.03, 0.03, 0.0]))
    d = fit_pose.Driver.judge(got, ref, 0.5, start)
    assert d["emitter_grad_gap"] == pytest.approx(1.0)
    assert d["emitter_change_gap"] == pytest.approx(
        0.06 / (2 * 0.03 ** 2) ** 0.5)


# ------------------------------------------------------------- readers

RECORD = {"event": "fit_record", "step": 0, "replay_deposits": 3000,
          "replay_steps": 15000, "replay_receivers": 3, "replay_pose": 1}
SCENE = {"n_bands": 1, "n_triangles": 100}
# The hand count of test_byte_count_by_hand, forward plus backward.
POSE_BYTES = 4 * (3000 * (3 + 1 + 2 + 1 + 6) + 15000 + 100 * 5 + 3) + 4 * (
    3000 * (1 + 1 + 1 + 1 + 6) + 15000 + 2 * 100 + 3)


def test_byte_count_by_hand():
    # forward: a depositing ray reads its direction (3) and recv_step (1)
    # and writes its bin, ear, weight (3) and 6 tangents; a step reads its
    # triangle's id; each of the 100 rows once (normal and offset, 4, and
    # its absorption); the emitter (3).
    assert replay_pose_bytes.forward_bytes(1, 100, 3000, 15000) == 4 * (
        3000 * 13 + 15000 + 100 * 5 + 3)
    # backward: recv_step, the weight's gradient, the chord, the arrival's
    # gradient and the 6 tangents a ray; the id a step; the table read and
    # its gradient written; the emitter's gradient (3).
    assert replay_pose_bytes.backward_bytes(1, 100, 3000, 15000) == 4 * (
        3000 * 10 + 15000 + 2 * 100 + 3)
    assert replay_pose_bytes.pair_bound_s(1, 100, 3000, 15000) == \
        pytest.approx(POSE_BYTES / 3.35e12)
    assert replay_pose_bytes.pair_bound_s(1, 100, 3000, 15000) > \
        replay_bytes.pair_bound_s(1, 100, 3000, 15000)


def _trace(pose: bool, with_records: bool) -> "harness.Run":
    """Two fit steps, each with three receivers' forward (the pose kernel,
    10 us, or the absorption kernel) and backward (20 us), and K3 (5 us)."""
    ev = []
    fwd = ("void (anonymous namespace)::replay_pose_kernel<1>(int)" if pose
           else "void (anonymous namespace)::replay_kernel<1>(int)")
    bwd = ("void (anonymous namespace)::replay_pose_bwd_kernel<1, true>"
           "(int)" if pose else
           "void (anonymous namespace)::replay_bwd_kernel<1, true>(int)")
    for u in range(2):
        t = 1000.0 * u
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": devtrace.UNIT, "ts": t, "dur": 900, "tid": 1})
        for r in range(3):
            for name, ts, dur in ((fwd, t + 10 + 100 * r, 10),
                                  ("k3_kernel", t + 30 + 100 * r, 5),
                                  (bwd, t + 50 + 100 * r, 20)):
                ev.append({"ph": "X", "cat": "kernel", "name": name,
                           "ts": ts, "dur": dur, "tid": 7})
    run = harness.Run(cell=None, seed=0)
    run.trace = devtrace.Summary(ev)
    if with_records:
        run.records = [dict(RECORD, replay_pose=int(pose))]
        run.reference = dict(SCENE, ray_steps=123)
    return run


def test_readers_on_a_trace():
    run = _trace(pose=True, with_records=True)
    assert run.trace.n_units == 2
    assert harness.read_metric("replay_pose_ms.fit_pose", run) == \
        pytest.approx(0.090)
    bound = POSE_BYTES / yardstick.HBM_BYTES_PER_S
    assert harness.read_metric("replay_pose_roofline.fit_pose", run) == \
        pytest.approx(100.0 * bound / 90e-6)


def test_readers_read_nothing_without_the_counters_or_the_pose():
    """A program without the counters (the parent's, whose replay is the
    eager chain) reads nothing; nor one whose counters say the replay is
    the absorption pair; nor a trace without the pose kernels."""
    for pose, records in ((True, False), (False, True)):
        run = _trace(pose=pose, with_records=records)
        assert harness.read_metric("replay_pose_ms.fit_pose", run) is None
        assert harness.read_metric("replay_pose_roofline.fit_pose",
                                   run) is None
    run = _trace(pose=False, with_records=True)
    run.records = [dict(RECORD)]
    assert harness.read_metric("replay_pose_ms.fit_pose", run) is None
    assert harness.read_metric("replay_pose_roofline.fit_pose", run) is None
    run.trace = None
    assert harness.read_metric("replay_pose_ms.fit_pose", run) is None


def test_manifest_entries():
    """The configuration, the two cells on one chip, the two metrics at
    the end of ``per_layer``, and the new cells appended to the fit's
    lists; every cell has its limits."""
    m = harness.load_manifest()
    assert m["configs"][-1]["name"] == "office_locate"
    assert m["configs"][-1]["reduced"] == []
    assert [w["name"] for w in m["workloads"][-2:]] == [CELL, "box.fit"]
    assert all(w["chips"] == 1 for w in m["workloads"][-2:])
    assert [x["name"] for x in m["per_layer"][-2:]] == [
        "replay_pose_ms.fit_pose", "replay_pose_roofline.fit_pose"]
    lists = {x["name"]: x.get("workloads", []) for x in
             m["end_to_end"] + m["per_layer"]}
    for name in ("step_ms", "launches_per_step.fit", "device_idle_pct.fit",
                 "program_idle_ms.fit", "replay_launches_per_step.fit",
                 "record_ms.fit"):
        assert lists[name][-2:] == [CELL, "box.fit"], name
    for w in m["workloads"]:
        assert harness.load_json("limits", w["name"])
    cfg = harness.load_json("configs", "office_locate")
    office = harness.load_json("configs", "office")
    for key, value in office.items():
        if key not in ("name", "source", "assumed"):
            assert cfg[key] == value, key
    rec = np.asarray(cfg["receivers"])
    assert rec.shape == (3, 3) and np.array_equal(rec[0], office["receiver"])
    dist = np.linalg.norm(rec - np.asarray(cfg["emitter"]), axis=1)
    assert np.all((dist >= 8.0) & (dist <= 16.0))
    assert abs(np.linalg.det(rec - np.asarray(cfg["emitter"]))) > 1.0
