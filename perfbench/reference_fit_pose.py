"""The benchmark's plain reference for a source localization: the emitter's
position and a uniform absorption fitted jointly to several receivers' IRs.

Plain PyTorch, independent of the program under test: it imports nothing
of ``audiorenderingv2_tpu_torch``, and it runs with TF32 off. It takes
``reference.py``'s meshes, direction draw, culled Möller-Trumbore search,
``soft_ir`` and ``log_loss``, ``reference_banded.nearest_hit``'s "no hit"
answer and ``reference_fit_banded.no_tf32``, and states the rest:

* each receiver's paths are traced once from the start emitter (with an
  energy threshold of 0 they do not depend on absorption): each ray that
  reaches the receiver keeps the triangles it bounced off, in order, and
  their count, its depth;
* a replay walks those triangle sequences again from an emitter that may
  carry a gradient: at each bounce the plane of the recorded triangle is
  met at ``t = (v0 - p) . n / (d . n)``, the ray moves to the hit, reflects
  off the plane and steps ``BOUNCE_EPSILON`` along the new direction; then
  it enters the receiver's sphere, where its arrival distance, its chord
  and its ear are taken. A ray that no longer meets the sphere deposits
  nothing. Autograd differentiates the whole walk in the emitter;
* each receiver's deposits are binned by ``reference.soft_ir`` at a
  uniform absorption (its weight ``e0 (1 - a)^depth chord``), the IRs of
  the receivers stacked, and the fit's loss is ``reference.log_loss`` of
  the stack against the stacked targets, both first smoothed along time by
  ``smooth`` (a moving mean over ``2 radius + 1`` bins, three times);
* Adam on the absorption's logit and the emitter, entry by entry, as
  ``reference.fit_steps`` states it;
* each deposit's arrival and chord differentiated in the emitter, deposit
  by deposit: the same walk under forward-mode differentiation
  (``deposit_tangents``).

Everything runs in ``dtype`` (float64 for the check; lower for the
precision control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import reference
from . import reference_banded as banded
from .reference_fit_banded import no_tf32


def trace_paths(geo: "reference.Geometry", dirs: torch.Tensor, emitter,
                receiver, trace: dict) -> dict:
    """Trace ``dirs`` [N, 3] from ``emitter`` in ``dirs``' dtype and keep
    the paths of the rays that reach ``receiver``'s sphere: ``ray``
    (int64 [D], the ray's index), ``depth`` (int64 [D], its bounces before
    the receiver) and ``tri`` (int64 [D, K], the triangles bounced off in
    order, -1 past the depth), and ``steps``, the ray-bounce steps taken.
    The trace is ``reference.trace_ir``'s with the energy left out, which
    only an energy threshold above 0 could make matter."""
    if float(trace["energy_threshold"]) != 0.0:
        raise ValueError("the paths depend on absorption above an energy "
                         "threshold of 0")
    dev, dt = dirs.device, dirs.dtype
    n = dirs.shape[0]
    dist_thresh = max(1, min(int(trace["ir_seconds"]), 999)) \
        * reference.SPEED_OF_SOUND + 1.0
    max_b = int(trace["max_bounces"])
    center = torch.as_tensor(np.asarray(receiver, np.float64)).to(dev, dt)
    with no_tf32():
        pos = torch.as_tensor(np.asarray(emitter, np.float64)).to(
            dev, dt).expand(n, 3).clone()
        d = dirs.clone()
        dist = torch.zeros(n, dtype=dt, device=dev)
        depth = torch.zeros(n, dtype=torch.int64, device=dev)
        seq = torch.full((n, max_b), -1, dtype=torch.int64, device=dev)
        live = torch.arange(n, device=dev)
        rays, depths, steps = [], [], 0
        while live.numel():
            p, dd = pos[live], d[live]
            t_tri, tri = banded.nearest_hit(geo, p, dd)
            t_sph, _ = reference.sphere_entry(p, dd, center)
            steps += live.numel()
            rec = t_sph < t_tri
            rays.append(live[rec])
            depths.append(depth[live[rec]])
            go = ~rec & torch.isfinite(t_tri)
            r, t, k = live[go], t_tri[go], tri[go]
            seq[r, depth[r]] = k
            hit_p = p[go] + t[:, None] * dd[go]
            nrm = geo.normal[k]
            nd = dd[go] - 2.0 * (dd[go] * nrm).sum(-1, keepdim=True) * nrm
            dist[r] = dist[r] + t
            depth[r] = depth[r] + 1
            d[r] = nd
            pos[r] = hit_p + reference.BOUNCE_EPSILON * nd
            alive = (dist[r] < dist_thresh) & (depth[r] < max_b)
            live = r[alive]
    ray = torch.cat(rays)
    dep = torch.cat(depths)
    k_max = int(dep.max()) if dep.numel() else 0
    return {"ray": ray, "depth": dep, "tri": seq[ray, :k_max],
            "steps": steps}


def replay_deposits(geo: "reference.Geometry", paths: dict,
                    dirs: torch.Tensor, emitter: torch.Tensor, receiver,
                    yaw_deg: float) -> tuple:
    """``paths`` (``trace_paths``') walked again from ``emitter`` [3],
    which may carry a gradient (or a forward-mode tangent): (``ok`` [D],
    whether each path still meets the receiver's sphere; and for those
    that do, the arrival distance, the chord, the ear and the half chord
    s). In ``emitter``'s dtype."""
    dt, dev = emitter.dtype, emitter.device
    center = torch.as_tensor(np.asarray(receiver, np.float64)).to(dev, dt)
    d = dirs[paths["ray"]].to(dt)
    m = d.shape[0]
    p = emitter[None, :].expand(m, 3)
    dist = torch.zeros(m, dtype=dt, device=dev)
    for k in range(paths["tri"].shape[1]):
        tri = paths["tri"][:, k]
        on = tri >= 0
        ti = torch.clamp(tri, min=0)
        nrm, v0 = geo.normal[ti].to(dt), geo.v0[ti].to(dt)
        nd = (d * nrm).sum(-1)
        t = ((v0 - p) * nrm).sum(-1) / torch.where(
            on & (nd.abs() > 1e-12), nd, 1.0)
        refl = d - 2.0 * nd[:, None] * nrm
        hit = p + t[:, None] * d + reference.BOUNCE_EPSILON * refl
        p = torch.where(on[:, None], hit, p)
        d = torch.where(on[:, None], refl, d)
        dist = torch.where(on, dist + t, dist)
    # The receiver sphere's first crossing past T_MIN; the square root of a
    # discriminant of 0 or less never enters the graph.
    oc = p - center
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1)
                    - reference.RECEIVER_RADIUS * reference.RECEIVER_RADIUS)
    hit = disc > 0.0
    s = torch.sqrt(torch.where(hit, disc, 1.0))
    t1, t2 = -b - s, -b + s
    first = t1 > reference.T_MIN
    ok = hit & (first | (t2 > reference.T_MIN))
    ts = torch.where(first, t1, t2)
    q = p + ts[:, None] * d - center
    theta = math.radians(float(yaw_deg))
    ear = (-math.sin(theta) * q[:, 0] + math.cos(theta) * q[:, 2]
           >= 0.0).to(torch.int64)
    return ok, (dist + ts)[ok], (t2 - t1)[ok], ear[ok], s[ok]


def replay_ir(geo: "reference.Geometry", paths: dict, dirs: torch.Tensor,
              emitter: torch.Tensor, receiver, yaw_deg: float,
              absorption: torch.Tensor, trace: dict,
              n_total: int) -> torch.Tensor:
    """The soft-binned stereo IR [2, ir_length] of ``paths``
    (``trace_paths``') walked again from ``emitter`` [3] at the uniform
    ``absorption`` (a 0-d tensor); both may carry a gradient. In
    ``emitter``'s dtype."""
    ok, arrival, chord, ear, _ = replay_deposits(geo, paths, dirs, emitter,
                                                 receiver, yaw_deg)
    deposits = [(arrival, chord, paths["depth"][ok], ear)]
    return reference.soft_ir(deposits, absorption, trace, n_total)


def deposit_tangents(geo: "reference.Geometry", paths: dict,
                     dirs: torch.Tensor, emitter, receiver) -> dict:
    """Each deposit's tangents against the emitter, by forward-mode
    differentiation of ``replay_deposits`` at ``emitter``, one pass an
    axis, in ``dirs``' dtype, for the paths that meet the sphere from
    there: ``ray``, ``depth`` and ``tri`` (``paths``' rows), ``s`` (the
    half chord, m), ``d_arrival`` and ``d_chord`` [D, 3] (m per m)."""
    import torch.autograd.forward_ad as fwad

    dt, dev = dirs.dtype, dirs.device
    e = torch.as_tensor(np.asarray(emitter, np.float64)).to(dev, dt)
    cols = []
    with no_tf32():
        for axis in range(3):
            with fwad.dual_level():
                tangent = torch.zeros(3, dtype=dt, device=dev)
                tangent[axis] = 1.0
                ok, arrival, chord, _, s = replay_deposits(
                    geo, paths, dirs, fwad.make_dual(e, tangent), receiver,
                    0.0)
                cols.append((fwad.unpack_dual(arrival).tangent,
                             fwad.unpack_dual(chord).tangent))
                s = fwad.unpack_dual(s).primal
    return {"ray": paths["ray"][ok], "depth": paths["depth"][ok],
            "tri": paths["tri"][ok], "s": s,
            "d_arrival": torch.stack([c[0] for c in cols], 1),
            "d_chord": torch.stack([c[1] for c in cols], 1)}


def smooth(ir: torch.Tensor, radius: int) -> torch.Tensor:
    """``ir`` [..., T] with each bin replaced three times over by the sum
    of the bins within ``radius`` of it (those inside the IR) over
    ``2 radius + 1``, written as a sum of shifted copies."""
    if radius <= 0:
        return ir
    n = ir.shape[-1]
    for _ in range(3):
        out = torch.zeros_like(ir)
        for k in range(-radius, radius + 1):
            lo, hi = max(0, -k), min(n, n - k)
            out[..., lo:hi] = out[..., lo:hi] + ir[..., lo + k:hi + k]
        ir = out / (2 * radius + 1)
    return ir


def fit_steps(geo: "reference.Geometry", paths: list, dirs: torch.Tensor,
              receivers, yaw_deg: float, target: torch.Tensor, trace: dict,
              n_total: int, init_absorption: float, init_emitter, lr: float,
              steps: int, smooth_radius: int = 0) -> list:
    """Adam on the absorption's logit (absorption = its sigmoid) and the
    emitter, ``steps`` steps of ``reference.log_loss`` of the receivers'
    stacked replayed IRs against ``target`` [L, 2, ir_length], both
    smoothed by ``smooth`` at ``smooth_radius``, in
    ``target``'s dtype, from ``paths`` (one ``trace_paths`` a receiver):
    [(loss, the logit's gradient, the logit after the step, the emitter's
    gradient [3], the emitter after the step [3])] a step, the tensors on
    the host. Adam as Kingma and Ba state it, with bias correction, beta1
    0.9, beta2 0.999 and eps 1e-8 outside the root, entry by entry."""
    dt, dev = target.dtype, target.device
    a0 = float(init_absorption)
    with no_tf32():
        theta = [torch.tensor(math.log(a0 / (1.0 - a0)), dtype=dt,
                              device=dev),
                 torch.as_tensor(np.asarray(init_emitter, np.float64)).to(
                     dev, dt)]
        m = [torch.zeros_like(x) for x in theta]
        v = [torch.zeros_like(x) for x in theta]
        out = []
        for t in range(1, steps + 1):
            th = [x.detach().requires_grad_(True) for x in theta]
            absorption = torch.sigmoid(th[0])
            pred = torch.stack([
                replay_ir(geo, p, dirs, th[1], rec, yaw_deg, absorption,
                          trace, n_total)
                for p, rec in zip(paths, receivers)])
            loss = reference.log_loss(smooth(pred, smooth_radius),
                                      smooth(target, smooth_radius))
            grads = torch.autograd.grad(loss, th)
            for j, g in enumerate(grads):
                m[j] = 0.9 * m[j] + 0.1 * g
                v[j] = 0.999 * v[j] + 0.001 * g * g
                m_hat = m[j] / (1.0 - 0.9 ** t)
                v_hat = v[j] / (1.0 - 0.999 ** t)
                theta[j] = theta[j] - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
            out.append((float(loss.detach()), float(grads[0]),
                        float(theta[0]), grads[1].detach().cpu(),
                        theta[1].detach().cpu()))
    return out
