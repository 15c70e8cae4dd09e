"""The ``fit`` driver: a material fit to a measured IR, one step at a time.

The window is one ``diff.fit_scene_parameters(method="replay")`` call on
the configuration's scene: the fit's defaults (Adam at ``learning_rate``,
the log loss, a new recording of the paths every ``replay_refresh`` steps
through the route ``tuned.auto_options`` picks, the replay differentiated
through soft binning), fitting one uniform absorption from
``init_absorption``, at the configuration's rays and receiver. The
benchmark hands in the directions (drawn on the card from the seed, float32)
and the target IR (a decaying noise envelope drawn from the seed), so
neither side renders it. Its ``callback`` stamps every step; the window
closes at the first step that ends past ``--seconds`` (the callback raises,
as a user stops a fit whose time is up), and ``step_ms`` is the window over
the steps completed.

The check follows the window's own first ``check_steps`` steps. The
reference traces the same directions in float64 once (the paths do not
depend on absorption when the energy threshold is 0), and runs its own Adam
on the soft-binned IR of its deposits. Compared: ``loss_gap``, the largest
relative gap of a step's loss; ``grad_gap``, the relative gap of the first
gradient's norm (read from the parameter's ``grad`` after the step, as the
optimizer got it); ``change_gap``, the relative gap of the norm of the
parameter's change after the steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference
from . import common


class _WindowClosed(Exception):
    pass


class Driver(common.Driver):
    unit_name = "step"

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
            hrtf_absorption_rate=float(tr["hrtf_absorption_rate"]))
        self.mark("program_built")
        dirs, target = self._inputs(0)
        self._fit(dirs, target, int(self.cell.traffic["warmup_units"]))

    def begin(self, seed: int) -> None:
        super().begin(seed)
        self.dirs, self.target = self._inputs(seed)
        self.seen: list = []

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
        decay = rng.uniform(*t["decay_s"])
        env = np.where(time_s >= onset, np.exp(-(time_s - onset) / decay), 0)
        target = (float(t["peak"]) * env[None, :]
                  * rng.uniform(0.0, 1.0, size=(2, nb)))
        return dirs, torch.as_tensor(target.astype(np.float32))

    def _fit(self, dirs, target, steps, callback=None):
        from audiorenderingv2_tpu_torch import diff

        t = self.cell.traffic
        c = self.cell.config
        return diff.fit_scene_parameters(
            self.scene, target, self.params, n_rays=dirs.shape[0],
            fit_absorption=True, init_emitter=c["emitter"],
            receiver_pos=c["receiver"],
            receiver_yaw_deg=float(c.get("yaw_deg", 0.0)),
            init_absorption=float(t["init_absorption"]), steps=steps,
            learning_rate=float(t["learning_rate"]), method="replay",
            replay_refresh=int(t["replay_refresh"]), device=self.device,
            directions=dirs, callback=callback)

    def window(self, seconds: float, tracer=None):
        """One fit call whose steps are the units, closed by its callback."""
        run = self.run
        n_check = int(self.cell.traffic["check_steps"])
        start = time.perf_counter()
        st = {"prev": start, "rf": None}

        def open_unit(i):
            if tracer is not None:
                tracer.before(i, time.perf_counter() - start)
                if tracer.active:
                    st["rf"] = torch.profiler.record_function(
                        "perfbench.unit")
                    st["rf"].__enter__()

        def callback(i, loss, theta):
            if st["rf"] is not None:
                st["rf"].__exit__(None, None, None)
                st["rf"] = None
            if i < n_check:
                p = theta["absorption_logits"]
                self.seen.append((float(loss), p.grad.detach().cpu().clone(),
                                  p.detach().cpu().clone()))
            now = time.perf_counter()
            run.unit_s.append(now - st["prev"])
            st["prev"] = now
            if now - start >= seconds and i + 1 >= n_check:
                raise _WindowClosed
            open_unit(i + 1)

        open_unit(0)
        try:
            self._fit(self.dirs, self.target, 1 << 30, callback)
        except _WindowClosed:
            pass
        if tracer is not None:
            tracer.finish(len(run.unit_s))
            run.traced_units = tracer.units
        run.window_s = st["prev"] - start
        return run

    def end_to_end(self) -> dict:
        return {"step_ms": self.run.window_s * 1e3 / len(self.run.unit_s)}

    def free(self) -> None:
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
            geo = reference.Geometry(*self.mesh, c["absorption"], dev, dtype)
            deps: list = []
            _, steps = reference.trace_ir(
                geo, self.dirs.to(dev, dtype), c["emitter"], c["receiver"],
                float(c.get("yaw_deg", 0.0)), tr, deposits=deps)
            return reference.fit_steps(
                deps, target.to(dtype), tr, n, float(t["init_absorption"]),
                float(t["learning_rate"]), n_check), steps

        ref, steps = reference_fit(torch.float64)
        if control is not None:
            got = reference_fit(control)[0]
        else:
            got = [(loss, float(g.sum()), float(p.sum()))
                   for loss, g, p in self.seen[:n_check]]
        a0 = float(t["init_absorption"])
        theta0 = float(np.log(a0 / (1.0 - a0)))

        def gap(x, y):
            return abs(abs(x) - abs(y)) / abs(y)

        out = {"loss_gap": max(gap(g[0], r[0]) for g, r in zip(got, ref)),
               "grad_gap": gap(got[0][1], ref[0][1]),
               "change_gap": gap(got[-1][2] - theta0, ref[-1][2] - theta0)}
        self.log("steps: program " + repr(got) + " reference " + repr(ref))
        self.run.reference = {"ray_steps": steps}
        return out
