"""CPU reference tracer in float64 numpy: the port's correctness oracle.

The counterpart of ``audiorenderingv2_tpu/core/tracer_ref.py``, with the
same loop order and the same arithmetic, so that both packages' oracles give
the same IR bit for bit (``tests/test_torch_oracle.py``). It is a simple
per-ray Python loop with classic Möller–Trumbore intersection, a different
formulation from the kernels' precomputed plane and barycentric rows, so the
two cross-check each other: the CPU tests hold the port's tracer to it on
every route, and ``chip_smoke.py`` holds the card's IR to it.

It runs on the host only, by nature: it is an oracle, not an entry point,
and takes no ``device``. Arrays may be numpy arrays or tensors on any
device; tensors are copied to the host.

Semantics mirrored from the reference device code:
  * per-ray energy = base_power / (n_rays * sphere_volume)   (cu:207-208)
  * bounce loop while {dist < ir_s*343+1, energy > thres,
    0 <= depth < max_bounces}                                (cu:227-252)
  * receiver = analytic 1 m sphere; deposited energy scaled by the chord
    length of the ray through the sphere                     (cu:91-122)
  * ear from the hit hemisphere in head-local (yaw) frame
    (OptixModel.cpp:175-195)
  * bin = round(dist / 343 * sr); drop if >= ir_length       (cu:131-134)
  * cross-ear write at +int(sr*0.00044) samples, scaled by
    (1 - hrtf_absorption_rate); falls back to the same bin on overflow
    (cu:124-168)
  * a ray that misses every triangle ends                    (cu:186-190)
  * surface: specular reflect, energy *= (1 - absorption), pos offset by
    ``constants.BOUNCE_EPSILON`` along the new direction     (cu:171-179)
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from .params import TraceParams

__all__ = ["TraceParams", "trace_ir_reference"]


def _host64(x) -> np.ndarray:
    """``x`` (array, sequence or tensor on any device) as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _intersect_brute(origin, direction, v0, v1, v2, t_min=constants.T_MIN):
    """Möller–Trumbore against all triangles; returns (t, tri_index) of the
    nearest hit or (inf, -1)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(direction[None, :], e2)
    det = np.einsum("ij,ij->i", e1, pvec)
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    tvec = origin[None, :] - v0
    u = np.einsum("ij,ij->i", tvec, pvec) * inv_det
    qvec = np.cross(tvec, e1)
    v = np.einsum("ij,j->i", qvec, direction) * inv_det
    t = np.einsum("ij,ij->i", e2, qvec) * inv_det
    eps = 1e-7
    ok &= (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps) & (t > t_min)
    t = np.where(ok, t, np.inf)
    i = int(np.argmin(t))
    return (float(t[i]), i) if np.isfinite(t[i]) else (np.inf, -1)


def _sphere_entry(origin, direction, center, radius=constants.RECEIVER_RADIUS,
                  t_min=constants.T_MIN):
    """First crossing of the receiver sphere along the ray.

    Returns (t_hit, chord) with t_hit = inf when the sphere is missed. The
    chord is the full secant length through the sphere — the reference's
    energy factor |intersection1 - intersection2| (devicePrograms.cu:111-120).
    """
    oc = origin - center
    b = float(np.dot(oc, direction))
    c = float(np.dot(oc, oc)) - radius * radius
    disc = b * b - c
    if disc <= 0.0:
        return np.inf, 0.0
    s = float(np.sqrt(disc))
    t1, t2 = -b - s, -b + s
    if t1 > t_min:
        return t1, t2 - t1
    if t2 > t_min:
        return t2, t2 - t1  # origin inside the sphere: hit the far surface
    return np.inf, 0.0


def _ear_of_point(p, center, yaw_deg):
    """0 = left, 1 = right. Head-local z sign after undoing the placement
    rotation R(-yaw) about Y (OptixModel.cpp:179-184; Camera.cpp:31-41)."""
    theta = np.radians(yaw_deg)
    d = p - center
    local_z = -np.sin(theta) * d[0] + np.cos(theta) * d[2]
    return 0 if local_z < 0.0 else 1


def trace_ir_reference(
    scene,
    directions,
    emitter,
    receiver_pos,
    receiver_yaw_deg: float,
    params: TraceParams,
    n_total_rays: int | None = None,
) -> np.ndarray:
    """Trace rays and accumulate the stereo IR histogram in float64.

    Args:
      scene: a :class:`audiorenderingv2_tpu_torch.scene.Scene` (its
        triangles ``v0``/``v1``/``v2``, ``normal`` and ``absorption``).
      directions: float [N, 3] unit directions.
      emitter / receiver_pos: float [3].
      receiver_yaw_deg: listener yaw in degrees (atan2(z, x) convention).
      n_total_rays: energy normalizer when this call traces a share of a
        larger launch.

    Returns float64 [2, ir_length] (or [2, n_bands, ir_length] for banded
    absorption) — (left, right) — on the host. Mono folding is the
    renderer's job, not this function's.
    """
    t_tris = scene.n_triangles
    v0 = scene.v0[:t_tris].astype(np.float64)
    v1 = scene.v1[:t_tris].astype(np.float64)
    v2 = scene.v2[:t_tris].astype(np.float64)
    normal = scene.normal[:t_tris].astype(np.float64)
    absorption = scene.absorption[:t_tris].astype(np.float64)

    emitter = _host64(emitter)
    center = _host64(receiver_pos)
    directions = _host64(directions)

    n = directions.shape[0]
    n_total = n_total_rays if n_total_rays is not None else n
    e0 = params.base_power / (n_total * constants.SPHERE_VOLUME)

    n_bands = params.n_bands
    if absorption.ndim == 1:
        absorption = absorption[:, None]  # broadcast broadband over bands

    ir = np.zeros((2, n_bands, params.ir_length), dtype=np.float64)
    delay = params.cross_ear_delay
    dist_thresh = params.distance_threshold

    for r in range(n):
        d = directions[r]
        pos = emitter.copy()
        dist = 0.0
        energy = np.full(n_bands, e0)
        depth = 0
        while (dist < dist_thresh and energy.max() > params.energy_threshold
               and 0 <= depth < params.max_bounces):
            t_tri, tri = _intersect_brute(pos, d, v0, v1, v2)
            t_sph, chord = _sphere_entry(pos, d, center)
            if t_sph < t_tri:
                dist += t_sph
                energy = energy * chord
                p = pos + t_sph * d
                ear = _ear_of_point(p, center, receiver_yaw_deg)
                b = int(round(dist / constants.SPEED_OF_SOUND
                              * params.sample_rate))
                if b < params.ir_length:
                    ir[ear, :, b] += energy
                    if not params.is_mono:
                        cb = b + delay if b + delay < params.ir_length else b
                        ir[1 - ear, :, cb] += energy * (
                            1.0 - params.hrtf_absorption_rate)
                break
            if not np.isfinite(t_tri):
                break  # miss kills the ray (devicePrograms.cu:186-190)
            dist += t_tri
            p = pos + t_tri * d
            nrm = normal[tri]
            d = d - 2.0 * np.dot(d, nrm) * nrm
            energy = energy * (1.0 - absorption[tri])
            depth += 1
            pos = p + constants.BOUNCE_EPSILON * d
    return ir if n_bands > 1 else ir[:, 0, :]
