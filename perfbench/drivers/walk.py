"""The ``walk`` driver: one listener walking through a room, closed loop.

Each unit is one ``AudioRenderer.full_render_cycle(receiver, yaw,
samples)``: the program sets the pose, renders (the whole trace on the
route that ``tuned.auto_options`` picks, the hard binning with the
cross-ear shift), copies the IR to the host, convolves the signal with it
and copies the stereo output to the host. The next cycle starts when the
last has returned, as the reference system's main loop re-renders.

Poses are a seeded walk: each step moves the listener ``step_m`` metres in
the horizontal plane, or turns it ``turn_deg`` degrees (``turn_share`` of
the steps), past the reference's re-render thresholds of 2 m and 5
degrees. A move that would bring the 1 m receiver sphere within
``clearance_m`` of a wall, a vertex of the mesh or the emitter is drawn
again. The signal is ``signal_seconds`` of seeded noise with tones, staged
on the device once, as ``streaming.Auralizer`` stages it.

The check: ``check_units`` cycles of the window, drawn from the seed by
reservoir sampling. For each, the reference draws the directions of the
renderer's generator as it stood before the cycle, traces them in float64,
and auralizes the signal with its IR. Compared: ``ir_l1``, the relative L1
distance of the program's IR from the reference's, and ``out_rel_l2``, the
relative L2 distance of the program's stereo output from the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import harness, reference
from . import common


class Driver(common.Driver):
    unit_name = "cycle"

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
            device=self.device)
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

    def begin(self, seed: int) -> None:
        super().begin(seed)
        self.renderer.generator.manual_seed(self.program_seed(seed))
        self._walk(np.random.default_rng([seed, 1]))
        self.samples_host = self._signal(np.random.default_rng([seed, 2]))
        self.samples = self.samples_host.to(self.device)
        if self.trace:
            self._plog.configure(path=str(self.log_path))

    def unit(self, i: int) -> None:
        pos, yaw = self._next_pose()
        slot = self.keep(i)
        state = (self.renderer.generator.get_state() if slot is not None
                 else None)
        out = self.renderer.full_render_cycle(pos, yaw, self.samples)
        if slot is not None:
            self.kept[slot] = dict(index=i, pos=pos, yaw=yaw, state=state,
                                   ir=self.renderer.ir, out=out)

    def end_to_end(self) -> dict:
        run = self.run
        ms = np.asarray(run.unit_s) * 1e3
        return {"cycle_ms": run.window_s * 1e3 / len(ms),
                "cycle_ms_p95": float(np.percentile(ms, 95))}

    def free(self) -> None:
        if self.trace:
            self._plog.configure()  # closes the file
            self.run.records = common.read_records(self.log_path,
                                                   "full_render_cycle")
        self.renderer = None
        self.samples = None

    def check(self, control=None) -> dict:
        """Worst numbers over the kept cycles. With ``control`` (a dtype)
        the reference computed in that precision stands in the program's
        place: the precision control of the limits."""
        c, tr, dev = self.cell.config, self.trace_params, self.ref_device
        geo = reference.Geometry(*self.mesh, c["absorption"], dev)
        geo_c = (reference.Geometry(*self.mesh, c["absorption"], dev, control)
                 if control is not None else None)
        worst = {"ir_l1": 0.0, "out_rel_l2": 0.0}
        steps = []
        for k in sorted(self.kept.values(), key=lambda k: k["index"]):
            dirs = reference.directions(
                int(c["rays"]), reference.generator_from_state(
                    k["state"], self.device), self.device).to(dev)
            ir_ref, n_steps = reference.trace_ir(
                geo, dirs, c["emitter"], k["pos"], k["yaw"], tr)
            steps.append(n_steps)
            sr = int(tr["sample_rate"])
            out_ref = reference.overlap_add(self.samples_host.to(dev), ir_ref,
                                            sr)
            ir, out = k["ir"], k["out"]
            if control is not None:
                dirs = reference.directions(
                    int(c["rays"]), reference.generator_from_state(
                        k["state"], self.device), self.device,
                    control).to(dev)
                ir, _ = reference.trace_ir(geo_c, dirs, c["emitter"],
                                           k["pos"], k["yaw"], tr)
                out = reference.overlap_add(self.samples_host.to(dev), ir, sr)
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
        """The numbers compared for one cycle."""
        out_ref = out_ref.double().cpu()
        out = torch.as_tensor(np.asarray(out, np.float64))
        return {"ir_l1": common.ir_l1(ir, ir_ref),
                "out_rel_l2": float((out - out_ref).norm()
                                    / out_ref.norm())}

    # ------------------------------------------------------------ traffic
    def _walk(self, rng: np.random.Generator) -> None:
        c = self.cell.config
        self._rng = rng
        self._pos = np.asarray(c["receiver"], np.float64)
        self._yaw = float(c.get("yaw_deg", 0.0))

    def _next_pose(self):
        t = self.cell.traffic
        rng = self._rng
        if rng.random() < float(t["turn_share"]):
            lo, hi = t["turn_deg"]
            self._yaw = (self._yaw + rng.choice((-1.0, 1.0))
                         * rng.uniform(lo, hi)) % 360.0
        else:
            lo, hi = t["step_m"]
            for _ in range(1000):
                ang = rng.uniform(0.0, 2.0 * np.pi)
                step = rng.uniform(lo, hi)
                cand = self._pos + step * np.array([np.cos(ang), 0.0,
                                                    np.sin(ang)])
                if self.clear(cand):
                    self._pos = cand
                    break
            else:
                raise RuntimeError("the walk found no clear step")
        return self._pos.astype(np.float32), float(self._yaw)

    def _signal(self, rng: np.random.Generator) -> torch.Tensor:
        sr = int(self.trace_params["sample_rate"])
        n = int(self.cell.traffic["signal_seconds"]) * sr
        t = np.arange(n) / sr
        f = rng.uniform(100.0, 2000.0, size=4)
        x = 0.05 * rng.standard_normal(n) + sum(
            0.2 * np.sin(2 * np.pi * fk * t + rng.uniform(0, 2 * np.pi))
            for fk in f)
        return torch.as_tensor(x.astype(np.float32))
