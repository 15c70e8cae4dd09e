"""The benchmark's plain reference for a banded material fit.

Plain PyTorch, independent of the program under test: it imports nothing
of ``audiorenderingv2_tpu_torch``, and it runs with TF32 off. It takes
``reference.py``'s meshes, direction draw, culled Möller-Trumbore search
and receiver sphere, ``reference_banded.py``'s material table and its
"no hit" handling, and reuses ``reference.soft_ir``, ``reference.log_loss``
and the Adam of ``reference.fit_steps`` as they state it:

* the paths are traced once: with an energy threshold of 0 they do not
  depend on absorption. Each deposit carries its arrival distance, its
  chord through the receiver sphere, its ear and its per-material visit
  counts ``k[m]``: how many of its bounces before the receiver landed on a
  triangle of material ``m``;
* at a table ``alpha`` [M + 1, B] (M materials and the no-material slot),
  a deposit's weight in band b is ``e0 * chord * prod_m (1 - alpha[m,
  b])^k[m]``, binned by ``soft_ir``'s two-bin split and cross-ear shift in
  every band: an IR [2, B, ir_length];
* the fit: Adam on the logits of the table (alpha is their sigmoid), the
  log loss of that IR against the target.

Everything runs in ``dtype`` (float64 for the check; lower for the
precision control).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import reference
from . import reference_banded as banded


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the block (matmuls and convolutions in full float32),
    as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def material_ids(vertices, triangles, materials: dict) -> np.ndarray:
    """Each triangle's material, int64 [T]: its index among ``materials``
    in the order the configuration lists them, by
    ``reference_banded.material_table``'s rule."""
    labels = {name: [float(m)] for m, name in enumerate(materials)}
    return banded.material_table(vertices, triangles, labels)[:, 0].astype(
        np.int64)


def trace_deposits(vertices, triangles, mat_ids, dirs: torch.Tensor,
                   emitter, receiver, yaw_deg: float, trace: dict,
                   n_slots: int) -> tuple[list, int]:
    """Trace ``dirs`` [N, 3] from ``emitter`` in ``dirs``' dtype and keep
    every receiver deposit: a list of (arrival distance [D], chord [D],
    visit counts [D, n_slots], ear [D]) a bounce step, before the cut at
    the IR's end, and the ray-bounce steps taken. ``mat_ids`` [T] gives
    each triangle's slot. The trace is ``reference.trace_ir``'s with the
    energy left out, which only an energy threshold above 0 could make
    matter."""
    if float(trace["energy_threshold"]) != 0.0:
        raise ValueError("the paths depend on absorption above an energy "
                         "threshold of 0")
    dev, dt = dirs.device, dirs.dtype
    geo = reference.Geometry(vertices, triangles, 0.0, dev, dt)
    mats = torch.as_tensor(np.asarray(mat_ids, np.int64)).to(dev)
    n = dirs.shape[0]
    dist_thresh = max(1, min(int(trace["ir_seconds"]), 999)) \
        * reference.SPEED_OF_SOUND + 1.0
    max_b = int(trace["max_bounces"])
    center = torch.as_tensor(np.asarray(receiver, np.float64)).to(dev, dt)
    theta = math.radians(float(yaw_deg))
    sin_t, cos_t = math.sin(theta), math.cos(theta)
    with no_tf32():
        pos = torch.as_tensor(np.asarray(emitter, np.float64)).to(
            dev, dt).expand(n, 3).clone()
        d = dirs.clone()
        dist = torch.zeros(n, dtype=dt, device=dev)
        counts = torch.zeros((n, n_slots), dtype=dt, device=dev)
        depth = torch.zeros(n, dtype=torch.int64, device=dev)
        live = torch.arange(n, device=dev)
        deposits, steps = [], 0
        while live.numel():
            p, dd = pos[live], d[live]
            t_tri, tri = banded.nearest_hit(geo, p, dd)
            t_sph, chord = reference.sphere_entry(p, dd, center)
            steps += live.numel()
            rec = t_sph < t_tri
            if bool(rec.any()):
                r = live[rec]
                ts = t_sph[rec]
                q = p[rec] + ts[:, None] * dd[rec] - center
                ear = (-sin_t * q[:, 0] + cos_t * q[:, 2] >= 0.0).to(
                    torch.int64)
                deposits.append((dist[r] + ts, chord[rec], counts[r], ear))
            go = ~rec & torch.isfinite(t_tri)
            r, t, k = live[go], t_tri[go], tri[go]
            hit_p = p[go] + t[:, None] * dd[go]
            nrm = geo.normal[k]
            nd = dd[go] - 2.0 * (dd[go] * nrm).sum(-1, keepdim=True) * nrm
            dist[r] = dist[r] + t
            counts[r, mats[k]] += 1.0
            depth[r] = depth[r] + 1
            d[r] = nd
            pos[r] = hit_p + reference.BOUNCE_EPSILON * nd
            alive = (dist[r] < dist_thresh) & (depth[r] < max_b)
            live = r[alive]
    return deposits, steps


def soft_ir(deposits: list, absorption: torch.Tensor, trace: dict,
            n_total: int) -> torch.Tensor:
    """The banded stereo IR [2, B, ir_length] of ``deposits``
    (``trace_deposits``') at the table ``absorption`` [n_slots, B], which
    may carry a gradient, in its dtype: each band's weights ``chord *
    prod_m (1 - absorption[m, b])^k[m]`` binned by ``reference.soft_ir``
    (which multiplies by ``e0``) with no further absorption."""
    dt = absorption.dtype
    dist = torch.cat([x[0] for x in deposits]).to(dt)
    chord = torch.cat([x[1] for x in deposits]).to(dt)
    counts = torch.cat([x[2] for x in deposits]).to(dt)
    ear = torch.cat([x[3] for x in deposits])
    keep = torch.prod((1.0 - absorption)[None] ** counts[:, :, None], dim=1)
    w = chord[:, None] * keep                          # [D, B]
    none = torch.zeros((), dtype=dt, device=absorption.device)
    zeros = torch.zeros_like(dist)
    return torch.stack([
        reference.soft_ir([(dist, w[:, b], zeros, ear)], none, trace,
                          n_total)
        for b in range(absorption.shape[1])], dim=1)


def fit_steps(deposits: list, target: torch.Tensor, trace: dict,
              n_total: int, init_absorption, lr: float, steps: int,
              n_slots: int) -> list:
    """``reference.fit_steps`` on the logits of a table [n_slots, B]
    (B from ``target`` [2, B, ir_length]), from ``init_absorption`` (one
    value for every entry, or a table) in ``target``'s dtype: [(loss,
    gradient [n_slots, B], logits after the step [n_slots, B])] a step,
    the tensors on the host. Adam as Kingma and Ba state it, with bias
    correction, beta1 0.9, beta2 0.999 and eps 1e-8 outside the root,
    entry by entry."""
    a0 = torch.as_tensor(np.asarray(init_absorption, np.float64))
    with no_tf32():
        theta = torch.log(a0 / (1.0 - a0)).expand(
            n_slots, target.shape[1]).to(target.device, target.dtype)
        m = torch.zeros_like(theta)
        v = torch.zeros_like(theta)
        out = []
        for t in range(1, steps + 1):
            th = theta.detach().requires_grad_(True)
            loss = reference.log_loss(
                soft_ir(deposits, torch.sigmoid(th), trace, n_total), target)
            (g,) = torch.autograd.grad(loss, th)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            m_hat = m / (1.0 - 0.9 ** t)
            v_hat = v / (1.0 - 0.999 ** t)
            theta = theta - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
            out.append((float(loss.detach()), g.detach().cpu(),
                        theta.detach().cpu()))
    return out
