"""The path tracer: scene arrays, the trace entry points and the histogram.

The counterpart of ``audiorenderingv2_tpu/core/tracer.py`` on the export
path. ``trace_ir`` packs the triangle rows, runs the bounce rounds of
``ops/raytrace_cuda.py`` and sums the events into the binaural IR through
``core/binning.py`` (K3). A scene without cluster boxes takes the rows
route (K1 over every triangle, several bounces per round); a scene with
them, Morton-sorted by ``accel.prepare_scene``, the clustered route (one
bounce per round: the per-tile schedule, then K2 over each tile's candidate
clusters, then a coherent sort of the rays). The tensors' device picks the
kernels: a CUDA tensor launches them, a CPU tensor runs their plain
versions.

Geometry stays elementwise: no dot product here is a matmul or an einsum,
which on the card could run in TF32 and lose the bits that decide whether a
ray grazes a triangle edge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import binning
from .params import TraceParams


class SceneArrays(NamedTuple):
    """Scene tensors, float32, triangle count T padded like the JAX package
    pads it (to 128, then to the triangle chunk).

    ``u_off``/``v_off`` fold the -v0 term of the barycentric map.
    ``cluster_boxes``: None, or the [C, 8] boxes of a Morton-sorted scene
    (lo xyz, hi xyz, valid flag, 0), one per ``T // C`` triangles."""

    plane_n: torch.Tensor     # [T, 3]
    plane_d: torch.Tensor     # [T]
    bary_u: torch.Tensor      # [T, 3]
    bary_v: torch.Tensor      # [T, 3]
    u_off: torch.Tensor       # [T]
    v_off: torch.Tensor       # [T]
    normal: torch.Tensor      # [T, 3] unit geometric normal
    absorption: torch.Tensor  # [T] or [T, n_bands]
    valid: torch.Tensor       # [T] 1.0 real / 0.0 padding or degenerate
    cluster_boxes: torch.Tensor | None = None  # [C, 8]

    @property
    def device(self) -> torch.device:
        return self.plane_n.device


@dataclass(frozen=True)
class TracerOptions:
    """Tracer options.

    ``soft_binning``: linear-interpolated deposits instead of rounded bins.
    ``compact``: partition the ray state alive-first between bounce rounds
    (the JAX package's ``pallas_compact``). ``round_budgets``: explicit
    per-round bounce budgets (its ``pallas_round_budgets``); None = the
    default geometric schedule.

    The JAX package's options that only tuned its TPU kernels have no field
    here; ``convert.tracer_options_from_jax`` drops them.
    """

    soft_binning: bool = False
    compact: bool = True
    round_budgets: tuple | None = None


def scene_to_arrays(scene, tri_chunk: int = 2048,
                    absorption: np.ndarray | None = None,
                    device: torch.device | str = "cpu",
                    clusters=None) -> SceneArrays:
    """Pack a host Scene into f32 tensors on ``device``, padded to a whole
    number of triangle chunks. ``absorption`` may override the scene's
    per-triangle absorption. ``clusters``: the ``accel.ClusterData`` of a
    scene from ``accel.prepare_scene``; it adds the cluster boxes."""
    t = scene.v0.shape[0]
    t_pad = ((t + 127) // 128) * 128
    tc = min(tri_chunk, t_pad)
    t_pad = ((t_pad + tc - 1) // tc) * tc

    def pad(x):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32)
        if x.shape[0] != t_pad:
            x = torch.cat([x, x.new_zeros((t_pad - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        return x.to(device)

    v0 = torch.as_tensor(np.asarray(scene.v0), dtype=torch.float32)
    bu = torch.as_tensor(np.asarray(scene.bary_u), dtype=torch.float32)
    bv = torch.as_tensor(np.asarray(scene.bary_v), dtype=torch.float32)
    # Elementwise f32 sums in index order, not an einsum (see module doc).
    u_off = -(v0[:, 0] * bu[:, 0] + v0[:, 1] * bu[:, 1] + v0[:, 2] * bu[:, 2])
    v_off = -(v0[:, 0] * bv[:, 0] + v0[:, 1] * bv[:, 1] + v0[:, 2] * bv[:, 2])
    absorb = scene.absorption if absorption is None else absorption
    boxes = None
    if clusters is not None:
        # One box per cluster of the padded triangles; an empty or padding
        # cluster keeps flag 0 and a zeroed box, since an inverted box would
        # pass a min/max slab test (audiorenderingv2_tpu/core/tracer.py:194).
        n_clus = t_pad // clusters.cluster_size
        b = np.zeros((n_clus, 8), np.float32)
        m = min(clusters.n_clusters, n_clus)
        for j, col in enumerate((clusters.lo_x, clusters.lo_y, clusters.lo_z,
                                 clusters.hi_x, clusters.hi_y, clusters.hi_z)):
            b[:m, j] = col[:m]
        b[:m, 6] = np.isfinite(clusters.lo_x[:m]).astype(np.float32)
        b = np.nan_to_num(b, posinf=0.0, neginf=0.0)
        boxes = torch.from_numpy(b).to(device)
    return SceneArrays(
        plane_n=pad(scene.plane_n), plane_d=pad(scene.plane_d),
        bary_u=pad(scene.bary_u), bary_v=pad(scene.bary_v),
        u_off=pad(u_off), v_off=pad(v_off), normal=pad(scene.normal),
        absorption=pad(absorb), valid=pad(scene.valid), cluster_boxes=boxes)


def _slot_bins(bin_f: torch.Tensor, active: torch.Tensor, n_bins: int,
               soft: bool):
    """Per-event deposit slots: (bins int32 [E, S], fracs f32 [E, S])."""
    if soft:
        b0 = torch.floor(bin_f)
        frac = bin_f - b0
        b0i = b0.to(torch.int32)
        bins = torch.stack([torch.where(active, b0i, n_bins),
                            torch.where(active, b0i + 1, n_bins)], dim=-1)
        fracs = torch.stack([1.0 - frac, frac], dim=-1)
    else:
        b = torch.round(bin_f).to(torch.int32)  # half to even, as jnp.round
        bins = torch.where(active, b, n_bins)[..., None]
        fracs = torch.ones_like(bin_f)[..., None]
    return bins.to(torch.int32), fracs


def _events_to_flat_bins(ev_bin_f, ev_w, ev_ear, params: TraceParams,
                         soft: bool):
    """Expand per-ray events into (flat_bin int32 [E*S], weight [E*S,
    n_bands]). Left ear at [0, n_bins), right at [n_bins, 2*n_bins); an
    out-of-range deposit gets 2*n_bins and is dropped. The cross-ear
    deposit lands +cross_ear_delay samples later, scaled by
    (1 - hrtf_absorption_rate), and falls back to the same bin when the
    delayed bin overflows (devicePrograms.cu:124-168)."""
    nb = params.ir_length
    active = torch.any(ev_w != 0.0, dim=-1)

    def flatten(bins, fracs, band_w, ear):
        in_range = (bins >= 0) & (bins < nb)
        flat = torch.where(in_range, ear[:, None] * nb + bins, 2 * nb)
        return flat, fracs[:, :, None] * band_w[:, None, :]

    slots = [flatten(*_slot_bins(ev_bin_f, active, nb, soft), ev_w, ev_ear)]
    if not params.is_mono:
        delay = params.cross_ear_delay
        cross_w = ev_w * (1.0 - params.hrtf_absorption_rate)
        other = 1 - ev_ear
        if soft:
            over = torch.round(ev_bin_f) + delay >= nb
            cross_src = torch.where(over, ev_bin_f, ev_bin_f + delay)
            slots.append(flatten(*_slot_bins(cross_src, active, nb, soft),
                                 cross_w, other))
        else:
            base = torch.round(ev_bin_f).to(torch.int32)
            cb = torch.where(base + delay < nb, base + delay, base)
            cb = torch.where((base >= 0) & (base < nb) & active, cb, nb)
            fr = torch.ones_like(ev_bin_f)[..., None]
            slots.append(flatten(cb[:, None], fr, cross_w, other))
    flat = torch.cat([s[0] for s in slots], dim=1).reshape(-1)
    ws = torch.cat([s[1] for s in slots], dim=1)
    return flat.to(torch.int32), ws.reshape(-1, params.n_bands)


def _histogram_from_events(ev_bin_f, ev_w, ev_ear, params: TraceParams,
                           soft: bool) -> torch.Tensor:
    """Events -> stereo IR: [2, ir_length] for one band, [2, n_bands,
    ir_length] otherwise.

    Hard binning sums only the same-ear deposits and derives the
    cross-ear ones from the finished histogram by a shift: cross[j] =
    (1 - hrtf) * (same[j - delay] + same[j] for the last ``delay`` bins,
    the reference's overflow fallback)."""
    nb = params.ir_length
    dev = ev_bin_f.device
    if not soft and not params.is_mono:
        active = torch.any(ev_w != 0.0, dim=-1)
        b = torch.round(ev_bin_f).to(torch.int32)
        flat = torch.where(active & (b >= 0) & (b < nb),
                           ev_ear.to(torch.int32) * nb + b, 2 * nb)
        hist = binning.histogram_sum_banded(flat, ev_w, 2 * nb)
        hist = hist.reshape(2, nb, params.n_bands)
        scale = 1.0 - params.hrtf_absorption_rate
        delay = params.cross_ear_delay
        j = torch.arange(nb, device=dev)
        shifted = torch.roll(hist, delay, dims=1)
        mask = (j >= delay)[None, :, None]
        tail = (j >= nb - delay)[None, :, None]
        cross = scale * (torch.where(mask, shifted, 0.0)
                         + torch.where(tail, hist, 0.0))
        hist = hist + cross.flip(0)  # each ear receives the OTHER ear's
    else:
        flat, ws = _events_to_flat_bins(ev_bin_f, ev_w, ev_ear, params, soft)
        hist = binning.histogram_sum_banded(flat, ws, 2 * nb)
        hist = hist.reshape(2, nb, params.n_bands)
    if params.n_bands == 1:
        return hist[:, :, 0]
    return hist.permute(0, 2, 1)


def _as_vec(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def trace_ir(sc: SceneArrays, directions: torch.Tensor, emitter,
             receiver_pos, receiver_yaw_deg: float, params: TraceParams,
             opts: TracerOptions = TracerOptions(),
             n_total_rays: int | None = None,
             rows: torch.Tensor | None = None,
             boxes: torch.Tensor | None = None) -> torch.Tensor:
    """Trace ``directions`` [N, 3] and return the stereo IR histogram on
    the scene's device: f32 [2, ir_length], or [2, n_bands, ir_length]
    when ``params.n_bands > 1``. Mono folding is the renderer's job.

    ``rows``, ``boxes``: the scene's packed triangle rows and cluster boxes
    from ``raytrace_cuda.pack_scene(sc, params.n_bands)``, packed once per
    scene by a caller that renders it many times; None packs them here.
    The clustered route runs when the scene has cluster boxes."""
    from ..ops import raytrace_cuda

    dev = sc.device
    if rows is None:
        rows, boxes = raytrace_cuda.pack_scene(sc, params.n_bands)
    elif (boxes is None) != (sc.cluster_boxes is None):
        raise ValueError("a clustered scene needs its packed boxes, and an "
                         "unclustered one none")
    ev_bin_f, ev_w, ev_ear = raytrace_cuda.trace_events(
        rows, directions.to(device=dev, dtype=torch.float32).contiguous(),
        _as_vec(emitter, dev), _as_vec(receiver_pos, dev),
        float(receiver_yaw_deg), params, n_total_rays=n_total_rays,
        compact=opts.compact, round_budgets=opts.round_budgets, boxes=boxes)
    return _histogram_from_events(ev_bin_f, ev_w, ev_ear, params,
                                  opts.soft_binning)


def render_ir(sc: SceneArrays, generator: torch.Generator, n_rays: int,
              emitter, receiver_pos, receiver_yaw_deg: float,
              params: TraceParams, opts: TracerOptions = TracerOptions(),
              n_total_rays: int | None = None,
              rows: torch.Tensor | None = None,
              boxes: torch.Tensor | None = None) -> torch.Tensor:
    """Sample ``n_rays`` directions from ``generator`` on the scene's
    device and trace them (``rows``, ``boxes`` as in :func:`trace_ir`)."""
    from . import sampling

    dirs = sampling.sample_directions(n_rays, generator, sc.device)
    return trace_ir(sc, dirs, emitter, receiver_pos, receiver_yaw_deg,
                    params, opts, n_total_rays, rows, boxes)
