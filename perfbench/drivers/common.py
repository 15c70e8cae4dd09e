"""What every driver shares: the configuration's scene and trace
parameters, the seeded draws, the reservoir of units kept for the check,
and the clearance rule of receiver poses."""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import harness, reference

TRACE_KEYS = ("sample_rate", "ir_seconds", "base_power", "energy_threshold",
              "max_bounces", "hrtf_absorption_rate")


class Driver:
    unit_name = "unit"

    def __init__(self, cell: "harness.Cell", device, trace: bool = False,
                 ref_device=None, log=None):
        self.cell = cell
        self.device = device
        self.ref_device = ref_device or device
        self.trace = bool(trace)
        self.log = log or (lambda line: print(line, file=sys.stderr))
        c = cell.config
        self.trace_params = {k: c[k] for k in TRACE_KEYS}
        self.mesh = reference.scene_mesh(c["scene"])
        v = self.mesh[0].astype(np.float64)
        self._lo, self._hi, self._verts = v.min(0), v.max(0), v
        self.marks: dict = {}

    def mark(self, name: str) -> None:
        """Note how far into the process's life set-up has come."""
        self.marks[name] = harness.process_age_s()

    # ------------------------------------------------------------ program
    def program_scene(self):
        """The configuration's mesh handed to the program as raw arrays."""
        from audiorenderingv2_tpu_torch import testing

        return testing.scene_from_arrays(*self.mesh,
                                         float(self.cell.config["absorption"]))

    @staticmethod
    def program_seed(seed: int) -> int:
        return int(np.random.default_rng([seed, 3]).integers(1 << 62))

    # -------------------------------------------------------------- a run
    def begin(self, seed: int) -> None:
        """Start the seeded part of a run: a fresh record and reservoir."""
        self.run = harness.Run(self.cell, seed)
        self.kept = {}
        self._res_rng = np.random.default_rng([seed, 4])
        self._n_keep = int(self.cell.traffic.get("check_units", 0))

    def keep(self, i: int) -> int | None:
        """Reservoir sampling of the units checked: the slot unit ``i``
        takes, or None."""
        if i < self._n_keep:
            return i
        j = int(self._res_rng.integers(0, i + 1))
        return j if j < self._n_keep else None

    def clear(self, pos, others=()) -> bool:
        """Whether the receiver sphere at ``pos`` keeps ``clearance_m`` from
        the room's walls, from every vertex of the mesh and from ``others``
        (and the configuration's emitter)."""
        r = reference.RECEIVER_RADIUS + float(
            self.cell.traffic["clearance_m"])
        pos = np.asarray(pos, np.float64)
        if np.any(pos - r < self._lo) or np.any(pos + r > self._hi):
            return False
        if np.min(np.linalg.norm(self._verts - pos, axis=1)) < r:
            return False
        pts = list(others)
        if "emitter" in self.cell.config:
            pts.append(self.cell.config["emitter"])
        return all(np.linalg.norm(pos - np.asarray(p, np.float64)) >= r
                   for p in pts)


def ir_l1(ir, ir_ref) -> float:
    """Relative L1 distance of an IR (an array) from the reference's (a
    tensor): sum |ir - ref| / sum |ref| over every ear and bin."""
    ir_ref = ir_ref.double().cpu()
    ir = torch.as_tensor(np.asarray(ir, np.float64))
    return float((ir - ir_ref).abs().sum() / ir_ref.abs().sum())


def read_records(path, event: str) -> list:
    """The program's JSONL log records of ``event``."""
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") == event:
                out.append(rec)
    return out
