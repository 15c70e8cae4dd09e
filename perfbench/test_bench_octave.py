"""The octave-band office's cell rehearsed on the CPU at test size, its
precision control, and the readers of its two per-layer metrics on a
hand-made trace.

    python -m pytest perfbench/test_bench_octave.py -q
"""
from __future__ import annotations

import pytest
import torch

from perfbench import devtrace, harness
from perfbench.run import run_cell

CELL = "office_octave.walk_banded"
SEED = 2**31 + 2203


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
    assert set(checks) == {"ir_l1", "band_l1_max", "out_rel_l2"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {"cycle_ms", "cycle_ms_p95", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"filterbank_ms.walk_banded", "split_host_ms.walk_banded",
            "k2_sched_ms.walk", "render_ms.walk"} <= names


def test_control_fails_every_limit():
    """The banded reference in bfloat16 in the program's place."""
    cell = tiny()
    d = cell.driver.Driver(cell, "cpu", log=quiet)
    d.setup(SEED)
    d.begin(SEED)
    harness.run_window(d, 0.2)
    got = d.check(control=torch.bfloat16)
    assert all(v > cell.limits[n] for n, v in got.items()), got


def _trace(with_spans: bool) -> "harness.Run":
    """Two cycles: each a unit holding a convolution whose split launches
    one kernel of 3 us and whose bands launch two of 5 us, beside a
    trace kernel of 100 us launched outside them."""
    ev = []
    corr = 0

    def span(name, ts, dur, cat="user_annotation"):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "tid": 1})

    def kernel(ts_launch, ts, dur):
        nonlocal corr
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts_launch, "dur": 1,
                   "tid": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
                   "dur": dur, "tid": 7, "args": {"correlation": corr}})

    for u in range(2):
        t = 1000.0 * u
        span(devtrace.UNIT, t, 900)
        span("ar2.cycle", t + 1, 898)
        kernel(t + 10, t + 20, 100)
        span("ar2.convolve", t + 400, 400)
        if with_spans:
            span("ar2.convolve.split", t + 410, 40)
            span("ar2.convolve.bands", t + 460, 300)
        kernel(t + 420, t + 500, 3)
        kernel(t + 470, t + 510, 5)
        kernel(t + 480, t + 520, 5)
    run = harness.Run(cell=None, seed=0)
    run.trace = devtrace.Summary(ev)
    return run


def test_readers_on_a_trace():
    run = _trace(with_spans=True)
    assert run.trace.n_units == 2
    read = harness.read_metric
    assert read("filterbank_ms.walk_banded", run) == pytest.approx(0.013)
    assert read("split_host_ms.walk_banded", run) == pytest.approx(0.040)


def test_readers_read_nothing_without_the_spans():
    """A program without the spans (the parent's) reads nothing."""
    run = _trace(with_spans=False)
    assert harness.read_metric("filterbank_ms.walk_banded", run) is None
    assert harness.read_metric("split_host_ms.walk_banded", run) is None
    run.trace = None
    assert harness.read_metric("filterbank_ms.walk_banded", run) is None
    assert harness.read_metric("split_host_ms.walk_banded", run) is None
