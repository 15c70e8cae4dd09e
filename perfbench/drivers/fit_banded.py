"""The ``fit_banded`` driver: a calibration of each material's octave-band
absorption to a measured banded IR.

The window is one ``diff.fit_scene_parameters(method="replay")`` call, as
the ``fit`` driver's, on the banded scene of the configuration: its mesh
with the configuration's materials (``reference_banded.material_table``
over ``materials``, each triangle tagged with its material), at its rays,
bounces, rate and bands. The fit takes the ``[M + 1, B]`` absorption table
(M materials and the no-material slot) from ``init_absorption`` in every
entry, with Adam at ``learning_rate``, the log loss and a new recording
every ``replay_refresh`` steps. The benchmark hands in the directions
(drawn on the card from the seed, float32) and the target; neither side
renders it.

The target, drawn from the seed: in band b a decaying noise envelope,
``peaks[b] * exp(-(t - onset) / tau_b)`` from an onset drawn from
``onset_s``, times noise uniform in [0, 1) per ear, band and bin. Its
energy decay ``tau_b = T60_b / (6 ln 10)`` follows Sabine's formula,
``T60_b = 0.161 V / sum_i S_i alpha[i, b]``, over the room's volume and
each triangle's area and coefficient in the configuration's table. Each
band's peak is a constant of the traffic (``band_peaks`` read it from the
float64 reference's banded IR at the configuration's start pose).

The check follows the window's first ``check_steps`` steps, against the
float64 reference of ``reference_fit_banded`` on the same directions and
target. Compared: ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, the worst band's relative L2 gap, over the materials, of the
first gradient (read from the logits' ``grad`` after the step, as the
optimizer got it); ``change_gap``, the worst band's relative L2 gap, over
the materials, of the logits' change after the steps. The no-material
slot is left out: no triangle has it, so its gradient is 0 on both sides.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import harness, reference
from .. import reference_banded as banded
from .. import reference_fit_banded as rfb
from . import common, fit

SABINE = 0.161  # s / m: Sabine's constant at 20 C


def sabine_tau(vertices, triangles, table, volume: float) -> np.ndarray:
    """Each band's energy decay time [B] (s) by Sabine's formula over the
    mesh's triangle areas and their coefficients ``table`` [T, B]:
    ``T60 / (6 ln 10)``, the time of a decay of 1/e in energy."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    area = 0.5 * np.linalg.norm(np.cross(v[t[:, 1]] - v[t[:, 0]],
                                         v[t[:, 2]] - v[t[:, 0]]), axis=1)
    t60 = SABINE * volume / (area @ np.asarray(table, np.float64))
    return t60 / (6.0 * math.log(10.0))


def band_peaks(cell: "harness.Cell", seed: int, device) -> list:
    """The traffic's ``peaks``: each band's mean energy over the first
    ``peak_window_s`` of the float64 reference's banded IR at the
    configuration's start pose, from the first arrival on, both ears."""
    c, tr = cell.config, {k: cell.config[k] for k in common.TRACE_KEYS}
    mesh = reference.scene_mesh(c["scene"])
    table = banded.material_table(*mesh, c["materials"])
    geo = banded.BandedGeometry(*mesh, table, device)
    dirs = reference.directions(int(c["rays"]), reference.generator_from_seed(
        seed, device), device)
    with rfb.no_tf32():
        ir, _ = banded.trace_ir(geo, dirs, c["emitter"], c["receiver"],
                                float(c.get("yaw_deg", 0.0)), tr)
    first = int(torch.nonzero(ir.sum(dim=(0, 1)) > 0)[0])
    span = int(round(float(cell.traffic["target"]["peak_window_s"])
                     * int(tr["sample_rate"])))
    return ir[:, :, first:first + span].mean(dim=(0, 2)).tolist()


class Driver(fit.Driver):

    def __init__(self, cell, device, trace=False, ref_device=None, log=None):
        super().__init__(cell, device, trace=trace, ref_device=ref_device,
                         log=log)
        materials = cell.config["materials"]
        self.table = banded.material_table(*self.mesh, materials)
        self.mat_ids = rfb.material_ids(*self.mesh, materials)
        self.n_slots = len(materials) + 1
        room = cell.config["scene"]["room"]
        self.tau = sabine_tau(*self.mesh, self.table, float(np.prod(room)))

    def program_scene(self):
        """The mesh, each triangle tagged with its material, and its
        absorption table, handed to the program as raw arrays."""
        from audiorenderingv2_tpu_torch import testing
        from audiorenderingv2_tpu_torch.scene import build_scene

        mesh = testing.mesh_from_arrays(
            *self.mesh, tri_material=self.mat_ids.astype(np.int32),
            material_names=list(self.cell.config["materials"]))
        return build_scene(mesh, self.table)

    def setup(self, seed: int) -> None:
        from audiorenderingv2_tpu_torch.core.params import TraceParams

        tr = self.trace_params
        self.scene = self.program_scene()
        self.params = TraceParams(
            sample_rate=int(tr["sample_rate"]),
            ir_length=int(tr["ir_seconds"]) * int(tr["sample_rate"]),
            base_power=float(tr["base_power"]),
            energy_threshold=float(tr["energy_threshold"]),
            max_bounces=int(tr["max_bounces"]),
            hrtf_absorption_rate=float(tr["hrtf_absorption_rate"]),
            n_bands=self.table.shape[1])
        self.mark("program_built")
        if self.trace:
            from audiorenderingv2_tpu_torch.utils import logging as plog

            self.log_path = harness.RUNS / self.cell.name / "events.jsonl"
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            self.log_path.write_text("")
            self._plog = plog
        dirs, target = self._inputs(0)
        self._fit(dirs, target, int(self.cell.traffic["warmup_units"]))

    def begin(self, seed: int) -> None:
        super().begin(seed)
        if self.trace:
            self._plog.configure(path=str(self.log_path))

    def _inputs(self, seed: int):
        n = int(self.cell.config["rays"])
        gen = reference.generator_from_seed(self.program_seed(seed),
                                            self.device)
        dirs = reference.directions(n, gen, self.device, torch.float32)
        t = self.cell.traffic["target"]
        rng = np.random.default_rng([seed, 6])
        sr = int(self.trace_params["sample_rate"])
        nb = int(self.trace_params["ir_seconds"]) * sr
        time_s = np.arange(nb) / sr
        onset = rng.uniform(*t["onset_s"])
        env = np.where(time_s >= onset, np.exp(
            -np.maximum(time_s - onset, 0.0)[None, :] / self.tau[:, None]),
            0.0)
        peaks = np.asarray(t["peaks"], np.float64)
        target = (peaks[None, :, None] * env[None]
                  * rng.uniform(0.0, 1.0, size=(2, len(peaks), nb)))
        return dirs, torch.as_tensor(target.astype(np.float32))

    def free(self) -> None:
        if self.trace:
            self._plog.configure()  # closes the file
            self.run.records = common.read_records(self.log_path,
                                                   "fit_record")
        self.scene = None

    def check(self, control=None) -> dict:
        """The gaps of the window's first steps from the reference's; with
        ``control`` (a dtype) the reference in that precision stands in the
        program's place."""
        c, tr, dev = self.cell.config, self.trace_params, self.ref_device
        t = self.cell.traffic
        n = int(c["rays"])
        n_check = int(t["check_steps"])
        target = self.target.to(dev)

        def reference_fit(dtype):
            deps, steps = rfb.trace_deposits(
                *self.mesh, self.mat_ids, self.dirs.to(dev, dtype),
                c["emitter"], c["receiver"], float(c.get("yaw_deg", 0.0)),
                tr, self.n_slots)
            return rfb.fit_steps(
                deps, target.to(dtype), tr, n, float(t["init_absorption"]),
                float(t["learning_rate"]), n_check, self.n_slots), steps

        ref, steps = reference_fit(torch.float64)
        got = (reference_fit(control)[0] if control is not None
               else self.seen[:n_check])
        out = self.judge(got, ref, float(t["init_absorption"]),
                         self.n_slots - 1)
        self.log("losses: program " + repr([g[0] for g in got])
                 + " reference " + repr([r[0] for r in ref]))
        self.log("first gradient: program " + repr(got[0][1].tolist())
                 + " reference " + repr(ref[0][1].tolist()))
        # The scene's size, for the replay's least bytes.
        self.run.reference = {"ray_steps": steps,
                              "n_triangles": self.table.shape[0],
                              "n_bands": self.table.shape[1]}
        return out

    @staticmethod
    def judge(got, ref, init_absorption: float, n_materials: int) -> dict:
        """The numbers compared, from the program's and the reference's
        [(loss, gradient [M + 1, B], logits after the step [M + 1, B])] a
        step; the first ``n_materials`` rows are compared."""
        theta0 = math.log(init_absorption / (1.0 - init_absorption))

        def worst_band(x, y):
            x = torch.as_tensor(x, dtype=torch.float64)[:n_materials]
            y = torch.as_tensor(y, dtype=torch.float64)[:n_materials]
            return float(((x - y).norm(dim=0) / y.norm(dim=0)).max())

        return {
            "loss_gap": max(abs(abs(g[0]) - abs(r[0])) / abs(r[0])
                            for g, r in zip(got, ref)),
            "grad_gap": worst_band(got[0][1], ref[0][1]),
            "change_gap": worst_band(got[-1][2] - theta0,
                                     ref[-1][2] - theta0)}
