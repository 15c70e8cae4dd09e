"""Readings that the limits of a cell's check are set from.

    python3 -m perfbench.calibrate --workload box.walk \
        --seeds 101,102,... --control-seeds 201,202,203 --seconds 3

In one process on the card: the cell is set up once; then for each seed a
short window at the cell's own load and its check (the program's readings,
whose largest is a limit's lower reading), and for each control seed a
short window and the check with the reference computed in bfloat16 in the
program's place (the precision control, whose smallest reading is the upper
one). With ``--fault half`` or ``--fault altered`` the seeds run the
program with that fault planted instead (the fit's fault readings): half
of the directions handed to the fit, the energy spread over them; or the
replayed IR scaled by 1.5 where it is produced. Prints one JSON line a seed
and a summary line. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from perfbench import harness


@contextlib.contextmanager
def planted(driver, fault: str | None):
    """The fit's program with ``fault`` planted for the block."""
    if fault is None:
        yield
        return
    from audiorenderingv2_tpu_torch.diff import replay

    fit, render = driver._fit, replay.render_ir_replay
    if fault == "half":
        driver._fit = lambda dirs, *a, **k: fit(dirs[:dirs.shape[0] // 2],
                                                *a, **k)
    elif fault == "altered":
        replay.render_ir_replay = lambda *a, **k: render(*a, **k) * 1.5
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        driver._fit, replay.render_ir_replay = fit, render


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=("half", "altered"))
    a = p.parse_args(argv)
    cell = harness.cell_from_manifest(harness.load_manifest(), a.workload)
    harness.pin_caches()
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    driver = cell.driver.Driver(cell, "cuda")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    driver.setup(seeds[0] if seeds else controls[0])
    lower, upper = {}, {}
    for seed, control in ([(s, None) for s in seeds]
                          + [(s, torch.bfloat16) for s in controls]):
        driver.begin(seed)
        with planted(driver, a.fault if control is None else None):
            harness.run_window(driver, a.seconds)
        got = driver.check(control=control)
        kind = ("control" if control is not None
                else f"fault {a.fault}" if a.fault else "program")
        print(json.dumps({"seed": seed, "kind": kind, **got}), flush=True)
        for n, v in got.items():
            if kind == "program":
                lower[n] = max(lower.get(n, 0.0), v)
            else:
                upper[n] = min(upper.get(n, float("inf")), v)
    print(json.dumps({"workload": a.workload, "lower": lower,
                      "upper": upper, "limits_now": cell.limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
