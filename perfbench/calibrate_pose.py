"""Readings that the limits of a source localization's check are set from.

    python3 -m perfbench.calibrate_pose --workload office_locate.fit_pose \
        --seeds 101,102,... --control-seeds 201,202,203 --seconds 3
    python3 -m perfbench.calibrate_pose --workload office_locate.fit_pose \
        --seeds 301,302,303 --faults jacobian,chord,entry,half

``perfbench.calibrate`` for a cell whose program fits the emitter, with
the faults of that fit, and the numbers that the cell logs and holds to no
limit printed beside the checked ones (the summary line takes the checked
ones): in one process on the card the cell is set up once; then for each
seed a short window at the cell's own load and its check (the program's
readings), for each control seed the check with the reference computed in
bfloat16 in the program's place, and with ``--faults`` the seeds run the
program with each fault planted in turn instead, through the window and
the check:

* ``jacobian``: each plane hit's map of the tangents taken as the
  identity: the ray line's displacement against the emitter carried
  through every hit as it came, not mirrored;
* ``chord``: the chord's tangent dropped (d chord / d e = 0);
* ``entry``: the receiver entry's tangent dropped (the arrival's tangent
  is the path's own, -v0, alone);
* ``half``: half of the directions handed to the fit, the energy spread
  over them.

The first three run the pose pair's plain version
(``ops/replay_cuda.replay_plain`` with the tangents) with the fault in its
tangent step, in the kernel's place. Prints one JSON line a seed and a
summary line. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from perfbench import harness

FAULTS = ("jacobian", "chord", "entry", "half")


@contextlib.contextmanager
def planted(driver, fault: str | None):
    """The localization's program with ``fault`` planted for the block."""
    if fault is None:
        yield
        return
    from audiorenderingv2_tpu_torch.ops import replay_cuda as rc

    saved = (driver._fit, rc.replay, rc._surface_tangent, rc._entry_tangent)
    replay, entry = rc.replay, rc._entry_tangent
    if fault == "half":
        fit = driver._fit
        driver._fit = lambda dirs, *a, **k: fit(dirs[:dirs.shape[0] // 2],
                                                *a, **k)
    else:
        def plain_pose(*a, pose=False, **k):
            if pose:
                return rc.replay_plain(*a, **k, tangents=True)
            return replay(*a, **k)
        rc.replay = plain_pose
        if fault == "jacobian":
            rc._surface_tangent = lambda perp, nrm: perp
        elif fault == "chord":
            def no_chord(*a):
                t = entry(*a)
                return torch.cat([t[:, :3], torch.zeros_like(t[:, 3:])], 1)
            rc._entry_tangent = no_chord
        elif fault == "entry":
            def no_entry(perp, dir0, pos, dirn, center, bin_rate):
                t = entry(perp, dir0, pos, dirn, center, bin_rate)
                return torch.cat([-dir0 * bin_rate, t[:, 3:]], 1)
            rc._entry_tangent = no_entry
        else:
            raise ValueError(fault)
    try:
        yield
    finally:
        (driver._fit, rc.replay, rc._surface_tangent,
         rc._entry_tangent) = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", default="",
                   help="comma-separated, of " + ", ".join(FAULTS))
    a = p.parse_args(argv)
    faults = [f for f in a.faults.split(",") if f]
    if set(faults) - set(FAULTS):
        p.error(f"unknown faults {sorted(set(faults) - set(FAULTS))}")
    cell = harness.cell_from_manifest(harness.load_manifest(), a.workload)
    harness.pin_caches()
    if not torch.cuda.is_available():
        print("perfbench.calibrate_pose: no CUDA device", file=sys.stderr)
        return 2
    driver = cell.driver.Driver(cell, "cuda")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    driver.setup(seeds[0] if seeds else controls[0])
    runs = ([(s, None, None) for s in seeds] if not faults else
            [(s, None, f) for f in faults for s in seeds])
    runs += [(s, torch.bfloat16, None) for s in controls]
    lower, upper = {}, {}
    for seed, control, fault in runs:
        driver.begin(seed)
        with planted(driver, fault):
            harness.run_window(driver, a.seconds)
            got = driver.check(control=control)
        kind = ("control" if control is not None
                else f"fault {fault}" if fault else "program")
        print(json.dumps({"seed": seed, "kind": kind, **got,
                          **driver.logged}), flush=True)
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
