"""The harness's parts: the check that nothing of JAX is loaded, the trace
reduction, and a run from a directory that holds only the benchmark."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from perfbench import devtrace, harness


@pytest.mark.parametrize("mod,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("audiorenderingv2_tpu", True),
    ("audiorenderingv2_tpu.core.tracer", True),
    ("audiorenderingv2_tpu_torch", False),
    ("audiorenderingv2_tpu_torch.core", False), ("jaxtyping", False),
    ("flaxen", False),
])
def test_forbidden_names_are_compared_whole(mod, flagged, monkeypatch):
    monkeypatch.setitem(sys.modules, mod, types.ModuleType(mod))
    top = mod.split(".")[0]
    assert (top in harness.forbidden_loaded()) == flagged


def test_a_run_loads_nothing_of_jax():
    """Everything a run imports, in a fresh process: the harness, every
    driver and reader, the reference and the program's entry points."""
    code = (
        "import importlib, pathlib, torch\n"
        "from perfbench import harness, run, devtrace, reference, yardstick\n"
        "from perfbench import calibrate\n"
        "from perfbench.drivers import walk, matrix\n"
        "from audiorenderingv2_tpu_torch import renderer, multi, tuned, "
        "accel, testing\n"
        "from audiorenderingv2_tpu_torch.utils import logging\n"
        "for p in sorted((harness.ROOT / 'metrics').glob('*.py')):\n"
        "    harness.read_metric(p.stem, harness.Run(None, 0))\n"
        "print(harness.forbidden_loaded())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_runs", "_cache",
                                                  "__pycache__"))
    code = ("import sys\n"
            "from perfbench import harness\n"
            "from perfbench.run import run_cell\n"
            "m = harness.load_manifest()\n"
            "c = harness.cell_from_manifest(m, m['workloads'][0]['name'])\n"
            "run_cell(c, 1, 0.1, False, 'cpu')\n"
            "print('{}')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "audiorenderingv2_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary():
    ev = [
        _ev("user_annotation", devtrace.UNIT, 0.0, 100.0),
        _ev("user_annotation", devtrace.UNIT, 100.0, 100.0),
        _ev("cpu_op", "aten::copy_", 150.0, 40.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 10.0, 5.0),
        _ev("kernel", "void trace_rows_kernel<X>(int)", 20.0, 30.0),
        _ev("kernel", "other", 40.0, 20.0),           # overlaps: union
        _ev("gpu_memcpy", "Memcpy DtoH", 120.0, 10.0),
        _ev("kernel", "late", 300.0, 10.0),            # outside the window
    ]
    s = devtrace.Summary(ev)
    assert s.n_units == 2
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(50e-6)
    assert len(s.kernels()) == 2
    assert s.kernel_s(lambda n: "trace_rows" in n) == pytest.approx(30e-6)
    assert s.top_ops(1) == [["void trace_rows_kernel<X>(int)",
                             pytest.approx(30e-6)]]
    gaps = dict(s.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(150e-6)
    assert gaps["aten::copy_"] == pytest.approx(70e-6)  # 130-200


def test_metric_path_falls_back_to_the_shared_reader():
    metrics = harness.ROOT / "metrics"
    assert (harness.metric_path("render_ms.walk")
            == metrics / "render_ms.walk.py")
    assert (harness.metric_path("device_idle_pct.walk")
            == metrics / "device_idle_pct.py")
    assert (harness.metric_path("k1_roofline.matrix")
            == metrics / "k1_roofline.py")


def test_quiet_cores_avoid_a_busy_one():
    """A run that starts beside another one keeps off its cores."""
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) < 4:
        pytest.skip("needs four cores to choose from")
    busy = allowed[-1]
    spin = subprocess.Popen([sys.executable, "-c",
                             f"import os, time\n"
                             f"os.sched_setaffinity(0, [{busy}])\n"
                             f"t = time.time()\n"
                             f"while time.time() - t < 3: pass\n"])
    try:
        time.sleep(0.5)
        cores = harness.quiet_cores(2)
    finally:
        spin.wait()
    assert len(cores) == 2 and set(cores) <= set(allowed)
    assert busy not in cores
