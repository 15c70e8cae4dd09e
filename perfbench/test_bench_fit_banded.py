"""The octave office's banded calibration cell (``office_octave.fit_banded``)
rehearsed on the CPU at test size, its check against the precision control
and the planted faults, the readers of its two per-layer metrics and of
``office.matrix``'s ``k2_sched_ms.matrix`` on hand-made traces, and the
replay's byte count against a hand count.

    python -m pytest perfbench/test_bench_fit_banded.py -q
"""
from __future__ import annotations

import pytest
import torch

from perfbench import devtrace, harness, replay_bytes, yardstick
from perfbench.run import run_cell

CELL = "office_octave.fit_banded"
SEED = 2**31 + 2621


def tiny() -> "harness.Cell":
    cell = harness.cell_from_manifest(harness.load_manifest(), CELL)
    cell.config["rays"] = 1024
    cell.config["scene"]["n_triangles_target"] = 700
    return cell


def quiet(_line):
    pass


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace):
    cell = tiny()
    out, checks = run_cell(cell, SEED, 0.5, bool(trace), "cpu", log=quiet)
    assert out["correct"], checks
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap"}
    assert out["attempted"] >= 3 and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {"step_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"replay_roofline.fit_banded", "replay_bwd_ms.fit_banded",
            "launches_per_step.fit", "record_ms.fit"} <= names


def test_control_fails():
    """The banded reference fit in bfloat16 in the program's place."""
    cell = tiny()
    d = cell.driver.Driver(cell, "cpu", log=quiet)
    d.setup(SEED)
    d.begin(SEED)
    harness.run_window(d, 0.2)
    got = d.check(control=torch.bfloat16)
    assert any(v > cell.limits[n] for n, v in got.items()), got


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "band_scaled"])
def test_faults_are_caught(kind, monkeypatch):
    """A step that leaves the table unchanged, half of the rays with the
    energy spread over them, the replayed IR altered where it is produced,
    one band of the replayed IR scaled by 1.5."""
    from audiorenderingv2_tpu_torch.diff import replay

    from perfbench.drivers import fit_banded

    if kind == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif kind == "half":
        orig = fit_banded.Driver._fit
        monkeypatch.setattr(
            fit_banded.Driver, "_fit", lambda self, dirs, *a, **k: orig(
                self, dirs[:dirs.shape[0] // 2], *a, **k))
    else:
        render = replay.render_ir_replay

        def altered(*a, **k):
            ir = render(*a, **k)
            if kind == "altered":
                return ir * 1.5
            scale = torch.ones(ir.shape[1])
            scale[5] = 1.5
            return ir * scale[:, None]
        monkeypatch.setattr(replay, "render_ir_replay", altered)
    out, checks = run_cell(tiny(), SEED, 0.3, False, "cpu", log=quiet)
    assert not out["correct"], checks


def test_judge_leaves_out_the_no_material_slot():
    from perfbench.drivers import fit_banded

    g = torch.tensor([[1.0, 2.0], [3.0, 4.0], [9.0, 9.0]])
    p = torch.zeros((3, 2))
    ref = [(2.0, g.double(), p.double() - 0.5)]
    got = [(2.0, g.clone(), p - 0.5)]
    got[0][1][2] = 100.0   # the last slot differs
    got[0][2][2] = 7.0
    d = fit_banded.Driver.judge(got, ref, 0.5, n_materials=2)
    assert d == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    got[0][1][0, 1] = 2.0 * 1.5
    d = fit_banded.Driver.judge(got, ref, 0.5, n_materials=2)
    assert d["grad_gap"] == pytest.approx(1.0 / (2.0**2 + 4.0**2) ** 0.5)


# ------------------------------------------------------------- readers

RECORD = {"event": "fit_record", "step": 0, "replay_deposits": 1000,
          "replay_steps": 5000}
SCENE = {"n_bands": 8, "n_triangles": 100}
# The hand count of test_byte_count_by_hand, forward plus backward.
PAIR_BYTES = 4 * (1000 * 14 + 5000 + 100 * 12) + 4 * (
    1000 * 10 + 5000 + 2 * 800)


def test_byte_count_by_hand():
    # forward: a depositing ray reads its direction (3) and recv_step (1)
    # and writes its bin, ear and 8 weights (10); a step reads its
    # triangle's id (1); each of the 100 rows is read once: its normal and
    # offset (4) and 8 absorptions.
    assert replay_bytes.forward_bytes(8, 100, 1000, 5000) == 4 * (
        1000 * 14 + 5000 + 100 * 12)
    # backward: recv_step, 8 gradients and the chord a ray; the id a step;
    # the table's 100 x 8 absorptions read once and its gradient written
    # once.
    assert replay_bytes.backward_bytes(8, 100, 1000, 5000) == 4 * (
        1000 * 10 + 5000 + 2 * 800)
    assert replay_bytes.pair_bound_s(8, 100, 1000, 5000) == pytest.approx(
        PAIR_BYTES / 3.35e12)
    assert replay_bytes.forward_bytes(1, 0, 1, 0) == 4 * 7


def _trace(with_kernels: bool, with_records: bool) -> "harness.Run":
    """Two fit steps: each a unit holding a forward that launches the
    replay kernel (20 us) and a binning kernel (5 us), and a backward
    that runs, from autograd's thread, K3-bwd (10 us) and the replay's
    backward kernel (40 us)."""
    ev = []
    corr = 0

    def span(name, ts, dur, tid=1):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": ts, "dur": dur, "tid": tid})

    def kernel(name, ts_launch, ts, dur, tid=1):
        nonlocal corr
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts_launch, "dur": 1,
                   "tid": tid, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": 7, "args": {"correlation": corr}})

    for u in range(2):
        t = 1000.0 * u
        span(devtrace.UNIT, t, 900)
        span("ar2.fit.step", t + 1, 898)
        span("ar2.fit.forward", t + 10, 200)
        if with_kernels:
            kernel("void (anonymous namespace)::replay_kernel<8>(int)",
                   t + 20, t + 30, 20)
        kernel("k3_kernel", t + 60, t + 70, 5)
        span("ar2.fit.backward", t + 300, 400)
        kernel("k3_bwd_kernel", t + 320, t + 330, 10, tid=2)
        if with_kernels:
            kernel("void (anonymous namespace)::replay_bwd_kernel<8, false>"
                   "(int)", t + 410, t + 420, 40, tid=2)
    run = harness.Run(cell=None, seed=0)
    run.trace = devtrace.Summary(ev)
    if with_records:
        run.records = [dict(RECORD)]
        run.reference = dict(SCENE, ray_steps=123)
    return run


def test_readers_on_a_trace():
    run = _trace(with_kernels=True, with_records=True)
    assert run.trace.n_units == 2
    read = harness.read_metric
    assert read("replay_bwd_ms.fit_banded", run) == pytest.approx(0.040)
    bound = PAIR_BYTES / yardstick.HBM_BYTES_PER_S
    assert read("replay_roofline.fit_banded", run) == pytest.approx(
        100.0 * bound / 60e-6)


def test_readers_read_nothing_without_the_span_or_the_counters():
    """Without the counters (a program that writes no ``fit_record``, as
    the parent's) the roofline reads nothing, and the backward's time
    still reads; without the scene's size the roofline reads nothing;
    without the replay's kernels neither reads."""
    run = _trace(with_kernels=True, with_records=False)
    assert harness.read_metric("replay_bwd_ms.fit_banded", run) == \
        pytest.approx(0.040)
    assert harness.read_metric("replay_roofline.fit_banded", run) is None
    run = _trace(with_kernels=True, with_records=True)
    run.reference = {"ray_steps": 123}
    assert harness.read_metric("replay_roofline.fit_banded", run) is None
    run = _trace(with_kernels=False, with_records=True)
    assert harness.read_metric("replay_bwd_ms.fit_banded", run) is None
    assert harness.read_metric("replay_roofline.fit_banded", run) is None
    run.trace = None
    assert harness.read_metric("replay_bwd_ms.fit_banded", run) is None
    assert harness.read_metric("replay_roofline.fit_banded", run) is None


def test_k2_sched_reader_on_a_matrix_trace():
    """``k2_sched_ms.matrix``: the posed schedule and K2 of two matrix
    calls (3 + 11 us and 4 + 12 us), the sort beside them left out; a
    trace without them reads nothing."""
    ev = []
    for u, (a, b) in enumerate([(3, 11), (4, 12)]):
        t = 1000.0 * u
        ev.append({"ph": "X", "cat": "user_annotation", "name":
                   devtrace.UNIT, "ts": t, "dur": 900, "tid": 1})
        for name, ts, dur in [("tile_schedule_kernel", t + 10, a),
                              ("void trace_sched_kernel<8>(float*)",
                               t + 20, b),
                              ("cub::DeviceRadixSortOnesweepKernel",
                               t + 40, 7)]:
            ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                       "dur": dur, "tid": 7})
    run = harness.Run(cell=None, seed=0)
    run.trace = devtrace.Summary(ev)
    assert run.trace.n_units == 2
    assert harness.read_metric("k2_sched_ms.matrix", run) == \
        pytest.approx(0.015)
    run.trace = devtrace.Summary([e for e in ev if "sched" not in e["name"]])
    assert harness.read_metric("k2_sched_ms.matrix", run) is None
    cell = harness.cell_from_manifest(harness.load_manifest(),
                                      "office.matrix")
    assert "k2_sched_ms.matrix" in {m["name"] for m in cell.per_layer}
