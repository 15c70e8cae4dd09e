"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload box.walk --seed 7 --seconds 40 \
        --trace 0

Sets up the program (``audiorenderingv2_tpu_torch``) for the cell, warms up
its shapes, drives it for ``--seconds`` and checks what the window produced
against the plain reference. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read from
a device trace of a steady span of the window), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
its limit. The same numbers close standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from perfbench import harness


def run_cell(cell: "harness.Cell", seed: int, seconds: float, trace: bool,
             device, log=None) -> tuple[dict, dict]:
    """Set up, drive and check one run of ``cell`` on ``device``; returns
    (the result's fields, the checks)."""
    import torch

    from perfbench import devtrace

    torch.set_num_threads(2)
    on_card = torch.device(device).type == "cuda"
    driver = cell.driver.Driver(cell, device, trace=trace, log=log)
    driver.mark("imported")
    driver.setup(seed)
    driver.begin(seed)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = harness.process_age_s()
    tracer = None
    if trace:
        spec = cell.traffic["trace"]
        tracer = devtrace.Tracer(harness.RUNS / cell.name / "trace.json",
                                 spec["start_s"], spec["span_s"],
                                 spec["min_units"])
        tracer.warm()
    run = harness.run_window(driver, seconds, tracer)
    e2e = driver.end_to_end()
    e2e["setup_s"] = setup_s
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))
    driver.free()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    got = driver.check()
    check_s = time.perf_counter() - t_check
    checks = {n: {"value": v, "limit": cell.limits[n]}
              for n, v in got.items()}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": len(run.unit_s),
           "failed": failed, "device": dev, "units": driver.unit_name,
           "end_to_end": e2e, "check_s": check_s, "marks": driver.marks,
           "fifths_ms": [1e3 * sum(f) / len(f) for f in
                         (run.unit_s[k * len(run.unit_s) // 5:
                                     (k + 1) * len(run.unit_s) // 5]
                          for k in range(5)) if f]}
    if trace:
        run.trace = tracer.summary()
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        metrics = {}
        for m in cell.per_layer:
            v = harness.read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    return out, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # One process with few threads kept to two idle cores of those it was
    # given: host-bound cells spread less when the scheduler does not move
    # them.
    cores = harness.quiet_cores(2)
    os.sched_setaffinity(0, cores)
    manifest = harness.load_manifest()
    cell = harness.cell_from_manifest(manifest, a.workload)
    chips = next(w["chips"] for w in manifest["workloads"]
                 if w["name"] == a.workload)
    harness.pin_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}. No CPU fallback.",
              file=sys.stderr)
        return 2
    out, checks = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda")
    bad = harness.forbidden_loaded()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    e2e = out["end_to_end"]
    print(f"{out['attempted']} {out['units']}s in the window on cores "
          f"{cores}; "
          + ", ".join(f"{k} {v!r}" for k, v in e2e.items())
          + f"; the check took {out['check_s']:.1f} s; set-up (s into the "
          f"process): {out['marks']}; mean ms a {out['units']} in each fifth "
          f"of the window: {out['fifths_ms']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(harness.result_line(
        correct=out["correct"], attempted=out["attempted"],
        failed=out["failed"], metrics=out["metrics"], device=out["device"],
        breakdown=out.get("breakdown"), checks=checks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
