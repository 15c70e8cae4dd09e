"""The ``matrix`` driver: back-to-back source-listener IR matrices.

Each unit is one ``multi.render_ir_matrix`` call of ``sources`` x
``listeners`` pairs at the configuration's rays a pair, with the default
``pair_batch``, on the scene packed once at set-up by the program's own
``scene_to_arrays`` / ``packed_scene`` under ``tuned.auto_options``. Every
call draws new poses and a new seed from the run's seed; its IRs come back
to the host. Emitters and listeners keep the receiver sphere plus
``clearance_m`` from the walls, from the mesh's vertices and from each
other.

The check: ``check_units`` calls of the window, drawn from the seed by
reservoir sampling, and ``check_pairs`` pairs of each, drawn from the seed.
Pair ``i = s * L + l`` of a call with seed ``q`` traces the directions of a
generator seeded ``fold_seed(q, i)``; the reference draws them so, traces
them in float64 and gives ``ir_l1``, the relative L1 distance of the
program's IR of the pair from its own.
"""
from __future__ import annotations

import numpy as np

from .. import reference
from . import common


class Driver(common.Driver):
    unit_name = "call"

    def setup(self, seed: int) -> None:
        from audiorenderingv2_tpu_torch import accel, tuned
        from audiorenderingv2_tpu_torch.core.params import TraceParams
        from audiorenderingv2_tpu_torch.core.tracer import (packed_scene,
                                                            scene_to_arrays)

        tr = self.trace_params
        scene = self.program_scene()
        self.opts, cluster = tuned.auto_options(scene.n_triangles,
                                                int(tr["max_bounces"]))
        clusters = None
        if cluster is not None:
            scene, clusters = accel.prepare_scene(scene, cluster_size=cluster)
        self.sc = scene_to_arrays(scene, 128, device=self.device,
                                  clusters=clusters)
        self.params = TraceParams(
            sample_rate=int(tr["sample_rate"]),
            ir_length=int(tr["ir_seconds"]) * int(tr["sample_rate"]),
            base_power=float(tr["base_power"]),
            energy_threshold=float(tr["energy_threshold"]),
            max_bounces=int(tr["max_bounces"]),
            hrtf_absorption_rate=float(tr["hrtf_absorption_rate"]))
        self.rows, self.boxes = packed_scene(self.sc, self.params, None, None,
                                             self.opts)
        self.mark("program_built")
        self._rng = np.random.default_rng([0, 7])
        for _ in range(int(self.cell.traffic["warmup_units"])):
            self._call(*self._poses())

    def begin(self, seed: int) -> None:
        super().begin(seed)
        self._rng = np.random.default_rng([seed, 1])

    def unit(self, i: int) -> None:
        poses = self._poses()
        irs = self._call(*poses)
        slot = self.keep(i)
        if slot is not None:
            self.kept[slot] = dict(index=i, poses=poses, irs=irs)
        self.run.work += irs.shape[0] * irs.shape[1] * int(
            self.cell.config["rays"])

    def _call(self, emitters, listeners, yaws, call_seed):
        from audiorenderingv2_tpu_torch import multi

        return multi.render_ir_matrix(
            self.sc, call_seed, emitters, listeners, yaws,
            int(self.cell.config["rays"]), self.params, self.opts,
            rows=self.rows, boxes=self.boxes)

    def _poses(self):
        t = self.cell.traffic
        rng = self._rng
        placed: list = []

        def draw():
            for _ in range(1000):
                p = rng.uniform(self._lo, self._hi)
                if self.clear(p, placed):
                    placed.append(p)
                    return p.astype(np.float32)
            raise RuntimeError("no clear pose found")

        emitters = np.stack([draw() for _ in range(int(t["sources"]))])
        listeners = np.stack([draw() for _ in range(int(t["listeners"]))])
        yaws = rng.uniform(0.0, 360.0, size=len(listeners)).astype(np.float32)
        return emitters, listeners, yaws, int(rng.integers(1 << 62))

    def end_to_end(self) -> dict:
        return {"rays_per_s": self.run.work / self.run.window_s}

    def free(self) -> None:
        self.sc = self.rows = self.boxes = None

    def check(self, control=None) -> dict:
        """Worst ``ir_l1`` over the checked pairs; with ``control`` (a
        dtype) the reference in that precision stands in the program's
        place."""
        c, tr, dev = self.cell.config, self.trace_params, self.ref_device
        geo = reference.Geometry(*self.mesh, c["absorption"], dev)
        geo_c = (reference.Geometry(*self.mesh, c["absorption"], dev, control)
                 if control is not None else None)
        pick = np.random.default_rng([self.run.seed, 5])
        worst, steps = 0.0, []
        for k in sorted(self.kept.values(), key=lambda k: k["index"]):
            emitters, listeners, yaws, call_seed = k["poses"]
            n_l = len(listeners)
            n_pairs = len(emitters) * n_l
            for i in sorted(pick.choice(n_pairs, size=min(
                    n_pairs, int(self.cell.traffic["check_pairs"])),
                    replace=False).tolist()):
                s, l = divmod(i, n_l)
                pose = (emitters[s], listeners[l], float(yaws[l]), tr)
                pair_seed = reference.fold_seed(call_seed, i)
                dirs = reference.directions(
                    int(c["rays"]), reference.generator_from_seed(
                        pair_seed, self.device), self.device).to(dev)
                ir_ref, n_steps = reference.trace_ir(geo, dirs, *pose)
                steps.append(n_steps)
                ir = k["irs"][s, l]
                if control is not None:
                    dirs = reference.directions(
                        int(c["rays"]), reference.generator_from_seed(
                            pair_seed, self.device), self.device,
                        control).to(dev)
                    ir = reference.trace_ir(geo_c, dirs, *pose)[0]
                    ir = ir.double().cpu().numpy()
                got = common.ir_l1(ir, ir_ref)
                worst = max(worst, got)
                self.log(f"call {k['index']} pair {i}: ir_l1 {got:.6g}")
        self.run.reference = {
            "ray_steps_per_unit": float(np.mean(steps)) * int(
                self.cell.traffic["sources"]) * int(
                self.cell.traffic["listeners"]),
            "n_triangles": int(self.mesh[1].shape[0]),
            "n_rays": int(c["rays"]) * int(self.cell.traffic["sources"])
            * int(self.cell.traffic["listeners"])}
        return {"ir_l1": worst}
