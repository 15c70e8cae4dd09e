"""The ``walk_banded`` driver: the ``walk`` traffic on a scene whose
materials absorb by frequency band.

Everything is the ``walk`` driver's (the seeded pose stream and signal,
one ``AudioRenderer.full_render_cycle`` a unit, the reservoir of checked
cycles) but three things. The scene carries the configuration's ``[T, B]``
absorption table (``reference_banded.material_table``), so the program
renders a banded IR [2, B, ir_length] and auralizes through its
filterbank; the renderer takes the configuration's ``band_edges``; and the
check holds every band to the banded float64 reference
(``reference_banded``). Compared, each the worst over the kept cycles:
``ir_l1``, the relative L1 distance of the IR over ears, bands and bins;
``band_l1_max``, the worst band's relative L1 distance over ears and bins
(a fault in a band that holds little of the energy hides in ``ir_l1``);
``out_rel_l2``, the relative L2 distance of the stereo output.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import harness, reference
from .. import reference_banded as banded
from . import walk


class Driver(walk.Driver):

    def __init__(self, cell, device, trace=False, ref_device=None, log=None):
        super().__init__(cell, device, trace=trace, ref_device=ref_device,
                         log=log)
        c = cell.config
        self.edges = [float(f) for f in c["band_edges"]]
        self.table = banded.material_table(*self.mesh, c["materials"])

    def program_scene(self):
        """The mesh and its absorption table handed to the program as raw
        arrays."""
        from audiorenderingv2_tpu_torch import testing

        return testing.scene_from_arrays(*self.mesh, self.table)

    def setup(self, seed: int) -> None:
        from audiorenderingv2_tpu_torch.renderer import AudioRenderer

        c, tr = self.cell.config, self.trace_params
        self.renderer = AudioRenderer(
            self.program_scene(), int(tr["ir_seconds"]),
            int(tr["sample_rate"]), int(c["rays"]),
            base_power=float(tr["base_power"]),
            energy_threshold=float(tr["energy_threshold"]),
            max_bounces=int(tr["max_bounces"]),
            hrtf_absorption_rate=float(tr["hrtf_absorption_rate"]),
            is_mono=False, opts=None, seed=self.program_seed(seed),
            device=self.device, band_edges=tuple(self.edges))
        self.renderer.set_emitter_pos(c["emitter"])
        self.mark("program_built")
        if self.trace:
            from audiorenderingv2_tpu_torch.utils import logging as plog

            self.log_path = harness.RUNS / self.cell.name / "events.jsonl"
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            self.log_path.write_text("")
            self._plog = plog
        # Warm-up: the cell's own shapes, on poses of a stream of its own.
        self._walk(np.random.default_rng([0, 7]))
        samples = self._signal(np.random.default_rng([0, 8]))
        for _ in range(int(self.cell.traffic["warmup_units"])):
            pos, yaw = self._next_pose()
            self.renderer.full_render_cycle(pos, yaw, samples)

    def check(self, control=None) -> dict:
        """Worst numbers over the kept cycles. With ``control`` (a dtype)
        the banded reference computed in that precision stands in the
        program's place: the precision control of the limits."""
        c, tr, dev = self.cell.config, self.trace_params, self.ref_device
        sr = int(tr["sample_rate"])
        geo = banded.BandedGeometry(*self.mesh, self.table, dev)
        geo_c = (banded.BandedGeometry(*self.mesh, self.table, dev, control)
                 if control is not None else None)
        worst = {"ir_l1": 0.0, "band_l1_max": 0.0, "out_rel_l2": 0.0}
        steps = []
        for k in sorted(self.kept.values(), key=lambda k: k["index"]):
            gen = reference.generator_from_state(k["state"], self.device)
            dirs = reference.directions(int(c["rays"]), gen,
                                        self.device).to(dev)
            ir_ref, n_steps = banded.trace_ir(geo, dirs, c["emitter"],
                                              k["pos"], k["yaw"], tr)
            steps.append(n_steps)
            samples = self.samples_host.to(dev)
            out_ref = banded.overlap_add(samples, ir_ref, sr, self.edges)
            ir, out = k["ir"], k["out"]
            if control is not None:
                gen = reference.generator_from_state(k["state"], self.device)
                dirs = reference.directions(int(c["rays"]), gen, self.device,
                                            control).to(dev)
                ir, _ = banded.trace_ir(geo_c, dirs, c["emitter"], k["pos"],
                                        k["yaw"], tr)
                out = banded.overlap_add(samples, ir, sr, self.edges)
                ir, out = ir.double().cpu().numpy(), out.double().cpu().numpy()
            got = self.judge(ir, out, ir_ref, out_ref)
            for name, v in got.items():
                worst[name] = max(worst[name], v)
            self.log(f"cycle {k['index']}: " + ", ".join(
                f"{n} {v:.6g}" for n, v in got.items()))
        self.run.reference = {"ray_steps_per_unit": float(np.mean(steps)),
                              "n_triangles": int(self.mesh[1].shape[0]),
                              "n_rays": int(c["rays"])}
        return worst

    @staticmethod
    def judge(ir, out, ir_ref, out_ref) -> dict:
        """The numbers compared for one cycle; ``ir`` [2, B, ir_length]."""
        got = walk.Driver.judge(ir, out, ir_ref, out_ref)
        ir_ref = ir_ref.double().cpu()
        diff = (torch.as_tensor(np.asarray(ir, np.float64)) - ir_ref).abs()
        per_band = diff.sum(dim=(0, 2)) / ir_ref.abs().sum(dim=(0, 2))
        got["band_l1_max"] = float(per_band.max())
        return got
