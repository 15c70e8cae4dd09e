"""Build what a process's first render pays for, and time the shipped
configurations cold and warm.

The counterpart of ``audiorenderingv2_tpu/warmup.py``. On the GPU the
first-call cost is not a JIT: it is the ``nvcc`` build of ``csrc/*.cu``
(``ops/_build.build``), the native engine's ``g++`` build
(``native.build``), the CUDA context and cuFFT's plans. Both builds are
kept on disk, keyed by the sources' hash, so after

    python -m audiorenderingv2_tpu_torch.warmup [--configs NAMES]
        [--out PATH] [--device cuda|cpu]

every later process of the same checkout (the CLI, the benchmarks) finds
its libraries built. Then each configuration is set up and rendered once
(``first_s``: the CUDA context, the allocator, cuFFT) and ``WARM_REPEATS``
more times (``warm_s``: their median, each fenced). The JSON goes to
``--out`` (default ``audiorenderingv2_tpu_torch/_build/warmup.json``). A
configuration that fails raises: a failed build must not pass for a warm
start.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import accel, native, testing, tuned
from .core.params import TraceParams
from .core.tracer import packed_scene, render_ir, scene_to_arrays
from .ops import _build
from .renderer import AudioRenderer
from .utils.profiling import timed_median

DEFAULT_OUT = Path(__file__).resolve().parent / "_build" / "warmup.json"
CONFIGS = ("small_bench", "large_bench", "renderer_default")
WARM_REPEATS = 3
SMALL_RAYS = 1_000_000
SMALL_BOUNCES = 100
LARGE_RAYS = 1_000_000
LARGE_BOUNCES = 32
LARGE_TRIS = 20_000
ROOM = (14.0, 9.0, 11.0)
# Inside the box. The JAX module's receiver, (2.5, 9.9, 0.0), lies past the
# box's y extent (-4.5..4.5), so its render sees an empty IR.
RECEIVER = np.array([2.5, 1.5, 2.0], np.float32)
OFFICE_RECEIVER = np.array([6.0, 1.0, -8.0], np.float32)


def _params(max_bounces: int) -> TraceParams:
    return TraceParams(sample_rate=16000, ir_length=32000, base_power=3.62,
                       max_bounces=max_bounces, energy_threshold=0.0,
                       hrtf_absorption_rate=0.9)


def _render_fn(scene, n_rays: int, receiver, params: TraceParams, device,
               opts, cluster_size: int | None):
    """A render of ``scene`` under ``opts``, sorted into clusters of
    ``cluster_size`` first unless it is None, with its bounce counts
    (``with_stats``)."""
    clusters = None
    if cluster_size is not None:
        scene, clusters = accel.prepare_scene(scene,
                                              cluster_size=cluster_size)
    sc = scene_to_arrays(scene, 128, device=device, clusters=clusters)
    rows, boxes = packed_scene(sc, params, None, None, opts)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return lambda: render_ir(sc, gen, n_rays, np.zeros(3, np.float32),
                             receiver, 0.0, params, opts, rows=rows,
                             boxes=boxes, with_stats=True)


def shipped_configs(device: torch.device | str = "cuda"):
    """``[(name, build)]``: ``build()`` sets a configuration up on
    ``device`` and returns its render, a callable of no argument.

    ``small_bench``: the 14 x 9 x 11 m box (absorption 0.3), 1M rays x 100
    bounces under ``tuned.bench_small_options()``; ``large_bench``:
    ``testing.office_scene(20000)``, 1M rays x 32 bounces under
    ``tuned.bench_large_options()`` in clusters of
    ``tuned.bench_large_cluster_size()`` (the clustered route); the
    ``AR2_BENCH_*`` overrides apply as in a benchmark run, and with none
    set both are ``tuned.auto_options``' routes. ``renderer_default``:
    ``AudioRenderer`` on the box at the reference's defaults (1M rays, 100
    bounces, a 2 s IR at 16 kHz)."""
    device = torch.device(device)

    def box():
        v, t = testing.box_room(ROOM)
        return testing.scene_from_arrays(v, t, 0.3)

    def small():
        return _render_fn(box(), SMALL_RAYS, RECEIVER,
                          _params(SMALL_BOUNCES), device,
                          tuned.bench_small_options(), None)

    def large():
        return _render_fn(testing.office_scene(LARGE_TRIS), LARGE_RAYS,
                          OFFICE_RECEIVER, _params(LARGE_BOUNCES), device,
                          tuned.bench_large_options(),
                          tuned.bench_large_cluster_size())

    def renderer_default():
        r = AudioRenderer(box(), ir_seconds=2, sample_rate=16000,
                          n_rays=SMALL_RAYS, base_power=3.62,
                          max_bounces=SMALL_BOUNCES, device=device)
        r.set_receiver(RECEIVER, 0.0)
        return r.render

    return [("small_bench", small), ("large_bench", large),
            ("renderer_default", renderer_default)]


def _timed_build(build, lib: Path) -> dict:
    """Run ``build``; its seconds, 0 when ``lib`` was there already."""
    already = lib.exists()
    t0 = time.perf_counter()
    build()
    return {"build_s": 0.0 if already else time.perf_counter() - t0,
            "already_built": already, "library": str(lib)}


def _device_report(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.strip().splitlines()[device.index or 0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated subset to warm")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    wanted = [c.strip() for c in args.configs.split(",") if c.strip()]
    unknown = set(wanted) - set(CONFIGS)
    if unknown:
        raise SystemExit(f"unknown configs {sorted(unknown)}; known: "
                         f"{', '.join(CONFIGS)}")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    report = {"device": _device_report(device), "build": {}, "configs": {}}
    if device.type == "cuda":
        report["build"]["kernels"] = _timed_build(
            _build.build, _build.build_dir() / _build.LIB_NAME)
    else:
        report["build"]["kernels"] = "none: the CPU runs the plain versions"
    report["build"]["native"] = _timed_build(
        native.build, native.build_dir() / native.LIB_NAME)
    print(f"build: {report['build']}", flush=True)
    for name, build in shipped_configs(device):
        if name not in wanted:
            continue
        t0 = time.perf_counter()
        fn = build()
        setup_s = time.perf_counter() - t0
        warm_ms, first_s, _ = timed_median(lambda i: fn(), n=WARM_REPEATS,
                                           device=device)
        report["configs"][name] = {"setup_s": setup_s, "first_s": first_s,
                                   "warm_s": warm_ms / 1e3}
        print(f"  {name}: setup {setup_s:.2f} s, first {first_s:.3f} s, "
              f"warm {warm_ms:.2f} ms (median of {WARM_REPEATS})",
              flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
