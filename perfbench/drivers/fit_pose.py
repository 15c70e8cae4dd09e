"""The ``fit_pose`` driver: a source localization, the emitter's position
and the room's absorption fitted jointly to the IRs of several receivers.

The window is one ``diff.fit_scene_parameters(method="replay",
fit_absorption=True, fit_emitter=True)`` call on the configuration's scene
over its ``receivers``, as the ``fit`` driver's call over one: Adam at
``learning_rate`` on the absorption's logit and the emitter, the log loss
of the receivers' stacked IRs, a new recording of every receiver's paths
every ``replay_refresh`` steps, from ``init_absorption`` and a start
emitter that is the configuration's (true) emitter moved ``start_offset_m``
in a direction drawn from the seed (drawn again until it keeps the
traffic's ``clearance_m`` from the room's walls and the mesh's vertices).
The benchmark hands in the directions (drawn on the card from the seed,
float32) and the targets: per receiver i, ``fit``'s decaying noise
envelope (one decay time drawn from ``decay_s``) from an onset at the true
emitter's distance ``d_i`` over the speed of sound, at the level ``peak *
(d_1 / d_i)^2``, times noise uniform in [0, 1) per receiver, ear and bin.
Its ``callback`` stamps every step, and the window closes as ``fit``'s.

The check follows the window's first ``check_steps`` steps, against the
float64 reference of ``reference_fit_pose`` on the same directions and
targets: it traces each receiver's paths once from the start emitter and
replays them differentiably at each step. Compared: ``loss_gap``,
``grad_gap`` and ``change_gap`` of the absorption's logit as ``fit``'s;
``emitter_grad_gap``, the relative L2 gap of the emitter's first gradient
[3] (read from its ``grad`` after the step), each side on its own
recorded paths; and the emitter's tangents deposit by deposit, where the
two sides' recordings agree: the program records each receiver's paths
from the start emitter as the fit's first recording does and replays them
with the emitter alone requiring a gradient, the reference differentiates
its walk forward-mode, and over the deposits whose paths are the same
triangles in the same order on both sides and whose half chord is at
least ``S_FLOOR``, ``emitter_arrival_gap`` and ``emitter_chord_gap`` are
the relative L2 gaps of the arrival's and the chord's tangents summed with
signs drawn from the seed. Logged and held to no limit (``LOGGED``):
``emitter_change_gap``, the relative L2 gap of the emitter's change after
the steps; the deposits whose paths part, how grazing they are and how
much of the chord's tangent they carry; the reference's first emitter
gradient on the program's own paths against the program's and the
reference's; the emitter's path through the window (every
``replay_refresh`` steps) and its least distance to the walls and to the
mesh.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import harness, reference
from .. import reference_fit_pose as rfp
from . import common, fit


# The emitter's tangents are compared on the paths that both sides
# recorded alike (the same triangles in the same order) and whose half
# chord s at the receiver, in the reference, is at least S_FLOOR metres:
# there a float32 s keeps its digits (the chord's tangent scales as 1 / s),
# and some 9% of the deposits (s^2 / r^2 of a sphere of radius 1 m) are
# left out.
S_FLOOR = 0.3
# Logged with each run and held to no limit (PERF.md section 2).
LOGGED = ("emitter_change_gap",)


def triangle_keys(v0, v1, v2) -> list:
    """A key a triangle [T, 3] x 3 that does not depend on the order of its
    vertices: their float32 bytes, sorted."""
    tri = np.stack([v0, v1, v2], 1).astype(np.float32)
    return [b"".join(sorted(r.tobytes() for r in t)) for t in tri]


def sums(tan: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """``tan`` [D, 3] summed with ``signs`` [D], in float64."""
    return (signs[:, None] * tan.double()).sum(0)


class Driver(fit.Driver):

    def __init__(self, cell, device, trace=False, ref_device=None, log=None):
        super().__init__(cell, device, trace=trace, ref_device=ref_device,
                         log=log)
        self.receivers = np.asarray(cell.config["receivers"], np.float64)
        self.true_emitter = np.asarray(cell.config["emitter"], np.float64)

    def setup(self, seed: int) -> None:
        if self.trace:
            from audiorenderingv2_tpu_torch.utils import logging as plog

            self.log_path = harness.RUNS / self.cell.name / "events.jsonl"
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            self.log_path.write_text("")
            self._plog = plog
        super().setup(seed)

    def begin(self, seed: int) -> None:
        super().begin(seed)
        self.seen_pose: list = []
        self.path: list = []
        if self.trace:
            self._plog.configure(path=str(self.log_path))

    def clearance(self, pos) -> tuple[float, float]:
        """(the least distance of ``pos`` to the room's walls, to the mesh's
        vertices), in metres."""
        pos = np.asarray(pos, np.float64)
        walls = float(min((pos - self._lo).min(), (self._hi - pos).min()))
        return walls, float(np.linalg.norm(self._verts - pos, axis=1).min())

    def start_emitter(self, seed: int) -> np.ndarray:
        """The true emitter moved ``start_offset_m`` in a seeded direction,
        drawn again until it keeps ``clearance_m`` from the walls and the
        mesh."""
        rng = np.random.default_rng([seed, 7])
        lo, hi = self.cell.traffic["start_offset_m"]
        margin = float(self.cell.traffic["clearance_m"])
        while True:
            u = rng.normal(size=3)
            u *= rng.uniform(lo, hi) / np.linalg.norm(u)
            pos = self.true_emitter + u
            if min(self.clearance(pos)) >= margin:
                return pos

    def _inputs(self, seed: int):
        n = int(self.cell.config["rays"])
        gen = reference.generator_from_seed(self.program_seed(seed),
                                            self.device)
        dirs = reference.directions(n, gen, self.device, torch.float32)
        self.start = self.start_emitter(seed)
        t = self.cell.traffic["target"]
        rng = np.random.default_rng([seed, 6])
        sr = int(self.trace_params["sample_rate"])
        nb = int(self.trace_params["ir_seconds"]) * sr
        time_s = np.arange(nb) / sr
        decay = rng.uniform(*t["decay_s"])
        dist = np.linalg.norm(self.receivers - self.true_emitter, axis=1)
        onset = dist / reference.SPEED_OF_SOUND
        level = float(t["peak"]) * (dist[0] / dist) ** 2
        env = np.where(time_s[None, :] >= onset[:, None], np.exp(
            -np.maximum(time_s[None, :] - onset[:, None], 0.0) / decay), 0.0)
        target = (level[:, None, None] * env[:, None, :]
                  * rng.uniform(0.0, 1.0, size=(len(dist), 2, nb)))
        return dirs, torch.as_tensor(target.astype(np.float32))

    def _fit(self, dirs, target, steps, callback=None):
        from audiorenderingv2_tpu_torch import diff

        t = self.cell.traffic
        c = self.cell.config
        n_check = int(t["check_steps"])
        every = int(t["replay_refresh"])

        def keep(i, loss, theta):
            e = theta["emitter"]
            if i < n_check:
                self.seen_pose.append((e.grad.detach().cpu().clone(),
                                       e.detach().cpu().clone()))
            if i % every == 0:
                self.path.append((i, e.detach().cpu().tolist()))
            callback(i, loss, theta)

        return diff.fit_scene_parameters(
            self.scene, target, self.params, n_rays=dirs.shape[0],
            fit_absorption=True, fit_emitter=True,
            init_emitter=self.start.astype(np.float32),
            receiver_pos=self.receivers.astype(np.float32),
            receiver_yaw_deg=float(c.get("yaw_deg", 0.0)),
            init_absorption=float(t["init_absorption"]), steps=steps,
            learning_rate=float(t["learning_rate"]),
            smooth_radius=int(t["smooth_radius"]), method="replay",
            replay_refresh=every, device=self.device, directions=dirs,
            callback=keep if callback is not None else None)

    def free(self) -> None:
        if self.trace:
            self._plog.configure()  # closes the file
            self.run.records = common.read_records(self.log_path,
                                                   "fit_record")
        self.scene = None

    def log_path_taken(self) -> None:
        """The emitter's path through the window and its least clearance."""
        walls, mesh = zip(*(self.clearance(e) for _, e in self.path))
        self.log(f"emitter path (step, position) every "
                 f"{self.cell.traffic['replay_refresh']} steps from "
                 f"{self.start.tolist()}: {self.path}; least distance to "
                 f"the walls {min(walls):.3f} m, to the mesh's vertices "
                 f"{min(mesh):.3f} m")

    def check(self, control=None) -> dict:
        """The gaps of the window's first steps from the reference's, and of
        the emitter's tangents on the paths recorded alike; with ``control``
        (a dtype) the reference in that precision stands in the program's
        place."""
        c, tr, dev = self.cell.config, self.trace_params, self.ref_device
        t = self.cell.traffic
        n = int(c["rays"])
        n_check = int(t["check_steps"])
        yaw = float(c.get("yaw_deg", 0.0))
        target = self.target.to(dev)
        if self.path:
            self.log_path_taken()

        def reference_side(dtype, steps=n_check, paths=None):
            geo = reference.Geometry(*self.mesh, c["absorption"], dev, dtype)
            d = self.dirs.to(dev, dtype)
            if paths is None:
                paths = [rfp.trace_paths(geo, d, self.start, rec, tr)
                         for rec in self.receivers]
            fitted = rfp.fit_steps(
                geo, paths, d, self.receivers, yaw, target.to(dtype), tr, n,
                float(t["init_absorption"]), self.start,
                float(t["learning_rate"]), steps, int(t["smooth_radius"]))
            return paths, fitted, [
                rfp.deposit_tangents(geo, p, d, self.start, rec)
                for p, rec in zip(paths, self.receivers)]

        paths, ref, ref_tan = reference_side(torch.float64)
        if control is not None:
            _, got, tan = reference_side(control)
            other = [self.reference_tangents(x) for x in tan]
        else:
            got = [(loss, float(g[0]), float(p[0]), ge, e)
                   for (loss, g, p), (ge, e)
                   in zip(self.seen[:n_check], self.seen_pose[:n_check])]
            other = self.program_tangents()
        out = self.judge(got, ref, float(t["init_absorption"]), self.start)
        out.update(self.tangent_gaps(ref_tan, other))
        self.logged = {k: out.pop(k) for k in LOGGED}
        self.log("not held to a limit: " + repr(self.logged))
        if control is None:
            # The reference's first step on the program's own paths: the
            # fit's emitter gradient apart from the recordings' differences.
            same = reference_side(torch.float64, 1,
                                  [o["paths"] for o in other])[1][0][3]
            self.log("emitter gradient against the reference's on the "
                     "program's paths: " + repr({
                         "program": self.l2(got[0][3], same),
                         "reference_own_paths": self.l2(ref[0][3], same)}))
        self.log("steps: program " + repr([g[:3] + (g[3].tolist(),
                                                    g[4].tolist())
                                           for g in got])
                 + " reference " + repr([r[:3] + (r[3].tolist(),
                                                  r[4].tolist())
                                         for r in ref]))
        # The scene's size, for the pose replay's least bytes.
        self.run.reference = {"ray_steps": sum(p["steps"] for p in paths),
                              "n_triangles": int(self.mesh[1].shape[0]),
                              "n_bands": 1}
        return out

    def tangent_gaps(self, ref_tan: list, other: list) -> dict:
        """``emitter_arrival_gap`` and ``emitter_chord_gap``: the relative
        L2 gaps, over the receivers' stacked [3] sums, of the arrival's
        tangent (in bins) and of the chord's, summed with signs drawn from
        the seed over the deposits whose paths both sides recorded alike
        and whose reference half chord is at least ``S_FLOOR``. Logs how
        many deposits part and how grazing they are."""
        bin_rate = (float(self.trace_params["sample_rate"])
                    / reference.SPEED_OF_SOUND)
        n = self.dirs.shape[0]
        sides, diag = [], []
        for i, (r, o) in enumerate(zip(ref_tan, other)):
            dev = r["ray"].device
            depth = o["depth"].to(dev)[r["ray"]]
            width = max(r["tri"].shape[1], o["tri"].shape[1])
            ref_tri = torch.nn.functional.pad(
                r["tri"], (0, width - r["tri"].shape[1]), value=-1)
            o_tri = torch.nn.functional.pad(
                o["tri"].to(dev), (0, width - o["tri"].shape[1]), value=-1)
            alike = (depth == r["depth"]) & (o_tri[r["ray"]]
                                             == ref_tri).all(1)
            kept = alike & (r["s"] >= S_FLOOR)
            rng = np.random.default_rng([self.run.seed, 8, i])
            signs = torch.zeros(n, dtype=torch.float64)
            ray = r["ray"][kept].cpu()
            signs[ray] = torch.from_numpy(
                rng.integers(0, 2, n).astype(np.float64) * 2 - 1)[ray]
            s_kept = signs[ray].to(dev)
            mine = (bin_rate * sums(r["d_arrival"][kept], s_kept).cpu(),
                    sums(r["d_chord"][kept], s_kept).cpu())
            sides.append((mine, o["sums"](signs)))
            # Where the paths part: how many, how grazing, how much of the
            # chord's tangent they carry.
            mag = r["d_chord"].double().norm(dim=1)
            top = torch.argsort(mag, descending=True)[:5]
            on_other = torch.zeros(n, dtype=torch.bool)
            on_other[(o["depth"] >= 0).cpu()] = True
            on_other[r["ray"].cpu()] = False
            apart = ~alike
            diag.append({
                "deposits": int(r["ray"].numel()),
                "alike": int(alike.sum()), "kept": int(kept.sum()),
                "reference_only": int((depth < 0).sum()),
                "other_only": int(on_other.sum()),
                "apart_s_below_0.05": int((apart & (r["s"] < 0.05)).sum()),
                "apart_s_median": (float(r["s"][apart].median())
                                   if apart.any() else None),
                "apart_chord_tangent_share": float(
                    mag[apart].sum() / mag.sum()),
                "largest_chord_tangents_s_alike": [
                    (round(float(r["s"][j]), 6), bool(alike[j]))
                    for j in top.tolist()]})
        self.tangent_diag = diag
        self.log("tangents: deposits a receiver, alike and apart " + repr(
            diag))

        def gap(k: int) -> float:
            return self.l2(torch.cat([o[k] for _, o in sides]),
                           torch.cat([m[k] for m, _ in sides]))

        return {"emitter_arrival_gap": gap(0), "emitter_chord_gap": gap(1)}

    def reference_tangents(self, tan: dict) -> dict:
        """``deposit_tangents``' output as a side of ``tangent_gaps``."""
        n = self.dirs.shape[0]
        dev = tan["ray"].device
        bin_rate = (float(self.trace_params["sample_rate"])
                    / reference.SPEED_OF_SOUND)
        depth = torch.full((n,), -1, dtype=torch.int64, device=dev)
        depth[tan["ray"]] = tan["depth"]
        tri = torch.full((n, tan["tri"].shape[1]), -1, dtype=torch.int64,
                         device=dev)
        tri[tan["ray"]] = tan["tri"]

        def tangent_sums(signs):
            s = signs.to(dev)[tan["ray"]]
            return (bin_rate * sums(tan["d_arrival"], s).cpu(),
                    sums(tan["d_chord"], s).cpu())

        return {"depth": depth, "tri": tri, "sums": tangent_sums}

    def program_tangents(self) -> list:
        """The program's side of ``tangent_gaps``, a receiver each: its
        recording from the start emitter as the fit's first (the scene
        prepared as ``fit_scene_parameters`` prepares it, the triangle ids
        taken back to the mesh's), and the sums of its replay's tangents,
        by autograd with the emitter alone requiring a gradient; and the
        recorded paths as ``reference_fit_pose.trace_paths`` gives them."""
        from audiorenderingv2_tpu_torch import tuned
        from audiorenderingv2_tpu_torch.core.tracer import (TracerOptions,
                                                            scene_to_arrays)
        from audiorenderingv2_tpu_torch.diff import replay as rp

        c, tr, dev = self.cell.config, self.trace_params, self.device
        yaw = float(c.get("yaw_deg", 0.0))
        n = self.dirs.shape[0]
        rec_opts, scene, clusters = tuned.prepare(self.program_scene(),
                                                  self.params.max_bounces)
        sc = scene_to_arrays(scene, TracerOptions().tri_chunk, device=dev,
                             clusters=clusters)
        verts, faces = (np.asarray(x) for x in self.mesh)
        index = {k: j for j, k in enumerate(triangle_keys(
            *verts[faces].transpose(1, 0, 2)))}
        to_mesh = torch.tensor(
            [index.get(k, -2) if v > 0 else -2 for k, v in zip(
                triangle_keys(scene.v0, scene.v1, scene.v2), scene.valid)],
            dtype=torch.int64, device=dev)
        dirs = self.dirs.to(dev)
        start = self.start.astype(np.float32)
        e0 = float(tr["base_power"]) / (n * reference.SPHERE_VOLUME)
        keep = 1.0 - float(c["absorption"])
        out = []
        for rec in self.receivers.astype(np.float32):
            ids, recv = rp.record_paths_kernels(sc, dirs, start, rec, yaw,
                                                self.params, rec_opts)
            depth = recv.long()
            steps = torch.arange(ids.shape[1], device=dev)
            tri = torch.where(
                (ids >= 0) & (steps[None, :] < depth[:, None]),
                to_mesh[ids.long().clamp(min=0)], -1)
            em = torch.tensor(start, device=dev, requires_grad=True)
            ev_bin, ev_w, _ = rp.replay_events(sc, ids, recv, dirs, em, rec,
                                               yaw, self.params)
            energy = e0 * keep ** depth.clamp(min=0).double()

            def tangent_sums(signs, ev_bin=ev_bin, ev_w=ev_w, em=em,
                             energy=energy):
                signs = signs.to(dev)
                arrival, = torch.autograd.grad(
                    (signs.float() * ev_bin).sum(), em, retain_graph=True)
                chord, = torch.autograd.grad(
                    ((signs / energy).float() * ev_w[:, 0]).sum(), em)
                return arrival.double().cpu(), chord.double().cpu()

            ray = torch.nonzero(depth >= 0).squeeze(1)
            k = int(depth[ray].max()) if ray.numel() else 0
            out.append({"depth": depth, "tri": tri, "sums": tangent_sums,
                        "paths": {"ray": ray.to(self.ref_device),
                                  "depth": depth[ray].to(self.ref_device),
                                  "tri": tri[ray, :k].to(self.ref_device)}})
        return out

    @staticmethod
    def l2(x, y) -> float:
        """The relative L2 gap of ``x`` from ``y``."""
        x = torch.as_tensor(x, dtype=torch.float64)
        y = torch.as_tensor(y, dtype=torch.float64)
        return float((x - y).norm() / y.norm())

    @staticmethod
    def judge(got, ref, init_absorption: float, start) -> dict:
        """The numbers compared, from the program's and the reference's
        [(loss, the logit's gradient, the logit after the step, the
        emitter's gradient [3], the emitter after the step [3])] a step."""
        theta0 = math.log(init_absorption / (1.0 - init_absorption))
        e0 = torch.as_tensor(np.asarray(start, np.float64))

        def gap(x, y):
            return abs(abs(x) - abs(y)) / abs(y)

        l2 = Driver.l2

        return {"loss_gap": max(gap(g[0], r[0]) for g, r in zip(got, ref)),
                "grad_gap": gap(got[0][1], ref[0][1]),
                "change_gap": gap(got[-1][2] - theta0, ref[-1][2] - theta0),
                "emitter_grad_gap": l2(got[0][3], ref[0][3]),
                "emitter_change_gap": l2(
                    torch.as_tensor(got[-1][4], dtype=torch.float64) - e0,
                    torch.as_tensor(ref[-1][4], dtype=torch.float64) - e0)}
