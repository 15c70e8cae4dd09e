"""The benchmark's harness: the manifest, the run's loop and its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own and is found here by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment (scene, tracing, poses);
* ``traffic/<traffic>.json``: the traffic's parameters; its ``driver``
  names the module of ``drivers/`` that generates and drives it;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(run) -> float | None``;
* ``limits/<cell>.json``: the limit of each number that decides the cell's
  ``correct``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
RUNS = ROOT / "_runs"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "audiorenderingv2_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's clock (so the
    interpreter's own start counts too)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def pin_caches() -> None:
    """Keep every build and kernel cache the run may fill at a fixed path
    inside the checkout, so that only a checkout's first run builds."""
    cache = ROOT / "_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def quiet_cores(n: int) -> list[int]:
    """``n`` cores of those this process may run on, for the run to keep
    to: the highest-numbered of the cores that were idle over 0.2 s (busy
    under 5% of the time), or, where fewer are idle, the least busy. A
    second run on the same machine at the same time finds the first one's
    cores busy and takes others."""
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) <= n:
        return allowed

    def busy() -> dict:
        out = {}
        with open("/proc/stat") as f:
            for line in f:
                head, *vals = line.split()
                if head.startswith("cpu") and head != "cpu":
                    v = [int(x) for x in vals]
                    out[int(head[3:])] = (sum(v) - v[3] - v[4], sum(v))
        return out

    a = busy()
    time.sleep(0.2)
    b = busy()
    share = {}
    for c in allowed:
        if c in a and c in b and b[c][1] > a[c][1]:
            share[c] = (b[c][0] - a[c][0]) / (b[c][1] - a[c][1])
        else:
            share[c] = 1.0
    idle = sorted((c for c in allowed if share[c] < 0.05),
                  reverse=True)
    busy_ones = sorted((c for c in allowed if share[c] >= 0.05),
                       key=share.get)
    return sorted((idle + busy_ones)[:n])


def load_manifest(path: Path | None = None) -> dict:
    return json.loads((path or CHECKOUT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


@dataclass
class Cell:
    """One workload of the manifest with everything its name leads to."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self):
        return importlib.import_module(
            f"perfbench.drivers.{self.traffic['driver']}")


def cell_from_manifest(manifest: dict, name: str) -> Cell:
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(work)}")
    w = work[name]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return Cell(name=name, config=load_json("configs", w["config"]),
                traffic=load_json("traffic", w["traffic"]),
                limits=load_json("limits", name), end_to_end=e2e,
                per_layer=layer)


def metric_path(name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    where there is none, the reader its cells share, ``metrics/<base>.py``
    for the part of the name before the first dot."""
    path = ROOT / "metrics" / f"{name}.py"
    if path.is_file():
        return path
    return ROOT / "metrics" / f"{name.split('.', 1)[0]}.py"


def read_metric(name: str, run) -> float | None:
    """The value of per-layer metric ``name`` from its reader's file."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


@dataclass
class Run:
    """What a run measured, handed to the metric readers."""

    cell: Cell
    seed: int
    unit_s: list = field(default_factory=list)  # host time of each unit
    window_s: float = 0.0
    work: float = 0.0                 # the unit's work summed: rays, steps
    trace: object = None              # devtrace.Summary of the traced span
    traced_units: range = range(0)
    records: list = field(default_factory=list)  # program log records
    reference: dict = field(default_factory=dict)  # the check's side data


def run_window(driver, seconds: float, tracer=None) -> Run:
    """Drive units of work until ``seconds`` have passed; the window ends
    with the last unit. ``tracer`` (``devtrace.Tracer``) profiles a steady
    span inside it."""
    import torch

    if hasattr(driver, "window"):  # a driver whose entry runs its own loop
        return driver.window(seconds, tracer)
    run = driver.run
    start = time.perf_counter()
    i = 0
    while True:
        if tracer is not None:
            tracer.before(i, time.perf_counter() - start)
        t0 = time.perf_counter()
        if tracer is not None and tracer.active:
            with torch.profiler.record_function("perfbench.unit"):
                driver.unit(i)
        else:
            driver.unit(i)
        t1 = time.perf_counter()
        run.unit_s.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            break
    if tracer is not None:
        tracer.finish(i)
        run.traced_units = tracer.units
    run.window_s = time.perf_counter() - start
    return run


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
