"""The benchmark's plain reference for banded absorption.

Plain PyTorch, independent of the program under test: it imports nothing
of ``audiorenderingv2_tpu_torch``. It takes ``reference.py``'s meshes,
direction draw, culled Möller-Trumbore search and receiver sphere as they
are, and adds what a scene with frequency-dependent absorption needs:

* a ``[T, B]`` absorption table, one coefficient a triangle and band, and
  an energy ``[N, B]`` a ray: a hit scales each band's energy by
  ``1 - absorption[triangle, band]``; a ray bounces on while its strongest
  band's energy is above the threshold;
* the stereo banded IR ``[2, B, ir_length]``: a receiver hit deposits each
  band's energy times the chord, with the cross-ear shift applied to every
  band alike;
* the filterbank, written from its definition: B complementary bands over
  the rfft bins, split by raised-cosine crossovers of ``TRANSITION``
  fractional width; the lowpass of crossover f0 falls from 1 at
  ``f0 (1 - TRANSITION)`` to 0 at ``f0 (1 + TRANSITION)`` as
  ``(1 + cos(pi r)) / 2`` over that span, band 0 is the first lowpass,
  band b the difference of lowpasses b and b - 1, the last band 1 less
  the last lowpass, so the gains sum to 1 at every bin. The split is
  zero-phase, over the whole signal;
* the auralization: each band of the signal convolved with its band IR by
  the reference system's file overlap-add (``reference.overlap_add``), the
  bands summed.

Everything runs in ``dtype`` (float64 for the check; lower for the
precision control), blocked as ``reference.py`` is.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import reference

TRANSITION = 0.25


# ------------------------------------------------------------ materials

def material_table(vertices, triangles, materials: dict,
                   n_shell: int = 12) -> np.ndarray:
    """The ``[T, B]`` absorption table of an office mesh (``reference.
    office_mesh``: the room's box first, its ``n_shell`` triangles, then
    the icospheres). Of the shell, triangles whose normal is horizontal
    take ``materials["walls"]``, the two lowest ``materials["floor"]``,
    the two highest ``materials["ceiling"]``; every other triangle takes
    ``materials["furniture"]``."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    table = np.empty((t.shape[0], len(materials["furniture"])), np.float32)
    table[:] = materials["furniture"]
    p = v[t[:n_shell]]                          # [n_shell, 3, 3]
    nrm = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    level = np.abs(nrm[:, 1]) > 0.5
    y = p[:, :, 1].mean(1)
    lowest = y[level].min()
    for k in range(n_shell):
        if not level[k]:
            table[k] = materials["walls"]
        elif y[k] == lowest:
            table[k] = materials["floor"]
        else:
            table[k] = materials["ceiling"]
    return table


class BandedGeometry(reference.Geometry):
    """``reference.Geometry`` with a ``[T, B]`` absorption table, padded
    as the triangles are."""

    def __init__(self, vertices, triangles, absorption, device,
                 dtype=torch.float64):
        super().__init__(vertices, triangles, 0.0, device, dtype)
        a = torch.as_tensor(np.asarray(absorption, np.float64))
        pad = self.n_groups * reference.GROUP - a.shape[0]
        a = torch.cat([a, torch.zeros((pad, a.shape[1]),
                                      dtype=torch.float64)])
        self.absorption = a.to(device, dtype)
        self.n_bands = int(a.shape[1])


# ---------------------------------------------------------------- tracer

def nearest_hit(geo: BandedGeometry, pos, d):
    """``reference.nearest_hit``, which needs at least one ray that meets a
    group's box: where no ray meets the box that holds all of them (every
    ray has left the room, as the precision control's can), each hits
    nothing. In the office the room's shell lies in the first group, whose
    box is that whole box, so a ray that meets it meets a group's."""
    lo, hi = geo.box_lo.amin(0), geo.box_hi.amax(0)
    inv = 1.0 / d
    a = torch.nan_to_num((lo - pos) * inv, nan=-math.inf)
    b = torch.nan_to_num((hi - pos) * inv, nan=math.inf)
    near = torch.minimum(a, b).amax(-1)
    far = torch.maximum(a, b).amin(-1)
    if not bool(((far >= near) & (far > 0.0)).any()):
        m = pos.shape[0]
        return (torch.full((m,), math.inf, dtype=pos.dtype,
                           device=pos.device),
                torch.full((m,), -1, dtype=torch.int64, device=pos.device))
    return reference.nearest_hit(geo, pos, d)


def trace_ir(geo: BandedGeometry, dirs: torch.Tensor, emitter, receiver,
             yaw_deg: float, trace: dict) -> tuple[torch.Tensor, int]:
    """Trace ``dirs`` [N, 3] from ``emitter`` and bin the stereo banded IR,
    as ``reference.trace_ir`` does one band. Returns (ir [2, B,
    ir_length] in the geometry's dtype, on its device; the ray-bounce
    steps taken)."""
    dev, dt = dirs.device, dirs.dtype
    sr = int(trace["sample_rate"])
    ir_len = int(trace["ir_seconds"]) * sr
    n, nb = dirs.shape[0], geo.n_bands
    e0 = float(trace["base_power"]) / (n * reference.SPHERE_VOLUME)
    dist_thresh = max(1, min(int(trace["ir_seconds"]), 999)) \
        * reference.SPEED_OF_SOUND + 1.0
    delay = int(sr * reference.HEAD_DELAY_SECONDS)
    keep_other = 1.0 - float(trace["hrtf_absorption_rate"])
    e_thr = float(trace["energy_threshold"])
    max_b = int(trace["max_bounces"])
    center = torch.as_tensor(np.asarray(receiver, np.float64)).to(dev, dt)
    theta = math.radians(float(yaw_deg))
    sin_t, cos_t = math.sin(theta), math.cos(theta)

    pos = torch.as_tensor(np.asarray(emitter, np.float64)).to(dev, dt) \
        .expand(n, 3).clone()
    d = dirs.clone()
    dist = torch.zeros(n, dtype=dt, device=dev)
    energy = torch.full((n, nb), e0, dtype=dt, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    ir = torch.zeros((2 * ir_len, nb), dtype=dt, device=dev)
    live = torch.arange(n, device=dev)
    steps = 0
    while live.numel():
        p, dd = pos[live], d[live]
        t_tri, tri = nearest_hit(geo, p, dd)
        t_sph, chord = reference.sphere_entry(p, dd, center)
        steps += live.numel()
        rec = t_sph < t_tri
        if bool(rec.any()):
            r = live[rec]
            ts = t_sph[rec]
            dist_hit = dist[r] + ts
            e_hit = energy[r] * chord[rec][:, None]
            q = p[rec] + ts[:, None] * dd[rec] - center
            ear = (-sin_t * q[:, 0] + cos_t * q[:, 2] >= 0.0).to(torch.int64)
            b = torch.round(dist_hit / reference.SPEED_OF_SOUND * sr).to(
                torch.int64)
            inside = b < ir_len
            b, ear, e_hit = b[inside], ear[inside], e_hit[inside]
            cb = torch.where(b + delay < ir_len, b + delay, b)
            ir.index_add_(0, ear * ir_len + b, e_hit)
            ir.index_add_(0, (1 - ear) * ir_len + cb, e_hit * keep_other)
        go = ~rec & torch.isfinite(t_tri)
        r, t, k = live[go], t_tri[go], tri[go]
        hit_p = p[go] + t[:, None] * dd[go]
        nrm = geo.normal[k]
        nd = dd[go] - 2.0 * (dd[go] * nrm).sum(-1, keepdim=True) * nrm
        dist[r] = dist[r] + t
        energy[r] = energy[r] * (1.0 - geo.absorption[k])
        depth[r] = depth[r] + 1
        d[r] = nd
        pos[r] = hit_p + reference.BOUNCE_EPSILON * nd
        alive = (dist[r] < dist_thresh) & (energy[r].amax(-1) > e_thr) \
            & (depth[r] < max_b)
        live = r[alive]
    return ir.view(2, ir_len, nb).permute(0, 2, 1).contiguous(), steps


# ------------------------------------------------------------ filterbank

def band_gains(length: int, sample_rate: int, edges,
               dtype=torch.float64) -> torch.Tensor:
    """The filterbank's gains [B, length // 2 + 1] over the rfft bins of a
    signal of ``length`` samples (bin k at k sample_rate / length Hz), for
    the B - 1 crossovers ``edges``."""
    f = torch.fft.rfftfreq(length, 1.0 / sample_rate, dtype=torch.float64)
    lows = []
    for f0 in edges:
        lo, hi = f0 * (1.0 - TRANSITION), f0 * (1.0 + TRANSITION)
        r = torch.clamp((f - lo) / (hi - lo), 0.0, 1.0)
        lows.append(0.5 * (1.0 + torch.cos(math.pi * r)))
    gains = [lows[0]] + [lows[b] - lows[b - 1]
                         for b in range(1, len(lows))] + [1.0 - lows[-1]]
    return torch.stack(gains).to(dtype)


def split_bands(x: torch.Tensor, sample_rate: int, edges) -> torch.Tensor:
    """The signal [L] split into its bands [B, L] in ``x``'s dtype:
    zero-phase, the whole signal through one transform. A precision below
    float32 rounds the operands and the result to itself around a float32
    transform, as ``reference.overlap_add`` does."""
    dt = x.dtype
    ft = dt if dt in (torch.float64, torch.float32) else torch.float32
    g = band_gains(x.shape[-1], sample_rate, edges, ft).to(x.device)
    if ft != dt:
        g = g.to(dt).to(ft)
    spec = torch.fft.rfft(x.to(ft))
    return torch.fft.irfft(spec[None] * g, n=x.shape[-1]).to(dt)


def overlap_add(samples: torch.Tensor, ir: torch.Tensor, sample_rate: int,
                edges) -> torch.Tensor:
    """The banded auralization of ``samples`` [L] with ``ir`` [C, B,
    ir_length]: each band of the signal through the reference system's
    overlap-add with that band's IR, the bands summed. [C, L] in ``ir``'s
    dtype."""
    bands = split_bands(samples.to(ir.dtype), sample_rate, edges)
    out = reference.overlap_add(bands[0], ir[:, 0], sample_rate)
    for b in range(1, ir.shape[1]):
        out = out + reference.overlap_add(bands[b], ir[:, b], sample_rate)
    return out
