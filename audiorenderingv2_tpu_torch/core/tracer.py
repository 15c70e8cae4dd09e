"""The path tracer: scene arrays, the trace entry points and the histogram.

The counterpart of ``audiorenderingv2_tpu/core/tracer.py`` on the export
path. ``trace_ir`` packs the triangle rows, runs the bounce rounds of
``ops/raytrace_cuda.py`` and sums the events into the binaural IR through
``core/binning.py`` (K3). A scene without cluster boxes takes the rows
route (K1 over every triangle, several bounces per round); a scene with
them, Morton-sorted by ``accel.prepare_scene``, the clustered route (one
bounce per round: the per-tile schedule, then K2 over each tile's candidate
clusters, then a coherent sort of the rays). ``render_ir_pose_batch``
renders P poses in one launch per round (``trace_events_pose_batch``) and
one posed histogram; ``render_ir`` with ``opts.native_rng`` generates its
directions inside K4 instead of sampling them. The tensors' device picks
the kernels: a CUDA tensor launches them, a CPU tensor runs their plain
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
    default geometric schedule. ``native_rng``: ``render_ir`` generates the
    directions inside the state-initialising kernel, K4 (the JAX package's
    ``pallas_native_rng``), so no [N, 3] array is made; the stream differs
    from ``sample_directions``', so the two renders agree statistically.

    The JAX package's options that only tuned its TPU kernels have no field
    here; ``convert.tracer_options_from_jax`` drops them.
    """

    soft_binning: bool = False
    compact: bool = True
    round_budgets: tuple | None = None
    native_rng: bool = False


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


def _soft_slots(bin_f: torch.Tensor, active: torch.Tensor, n_bins: int):
    """Linear-interpolated deposit slots of each event: (bins int32 [E, 2],
    fracs f32 [E, 2]); an inactive event gets bin ``n_bins``."""
    b0 = torch.floor(bin_f)
    frac = bin_f - b0
    b0i = b0.to(torch.int32)
    bins = torch.stack([torch.where(active, b0i, n_bins),
                        torch.where(active, b0i + 1, n_bins)], dim=-1)
    fracs = torch.stack([1.0 - frac, frac], dim=-1)
    return bins.to(torch.int32), fracs


def _soft_flat_bins(ev_bin_f, ev_w, ev_ear, params: TraceParams):
    """Expand per-ray events into soft deposits (flat_bin int32 [E*S],
    weight [E*S, n_bands]). Left ear at [0, n_bins), right at [n_bins,
    2*n_bins); an out-of-range deposit gets 2*n_bins and is dropped. The
    cross-ear deposit lands +cross_ear_delay samples later, scaled by
    (1 - hrtf_absorption_rate), and falls back to the same bin when the
    delayed bin overflows (devicePrograms.cu:124-168)."""
    nb = params.ir_length
    active = torch.any(ev_w != 0.0, dim=-1)

    def flatten(bins, fracs, band_w, ear):
        in_range = (bins >= 0) & (bins < nb)
        flat = torch.where(in_range, ear[:, None] * nb + bins, 2 * nb)
        return flat, fracs[:, :, None] * band_w[:, None, :]

    slots = [flatten(*_soft_slots(ev_bin_f, active, nb), ev_w, ev_ear)]
    if not params.is_mono:
        delay = params.cross_ear_delay
        over = torch.round(ev_bin_f) + delay >= nb
        cross_src = torch.where(over, ev_bin_f, ev_bin_f + delay)
        slots.append(flatten(*_soft_slots(cross_src, active, nb),
                             ev_w * (1.0 - params.hrtf_absorption_rate),
                             1 - ev_ear))
    flat = torch.cat([s[0] for s in slots], dim=1).reshape(-1)
    ws = torch.cat([s[1] for s in slots], dim=1)
    return flat.to(torch.int32), ws.reshape(-1, params.n_bands)


def _histogram_from_events(ev_bin_f, ev_w, ev_ear, params: TraceParams,
                           soft: bool) -> torch.Tensor:
    """Events -> stereo IR: [2, ir_length] for one band, [2, n_bands,
    ir_length] otherwise. Hard binning is the posed histogram of one pose;
    soft binning expands every event into its deposit slots, the cross-ear
    ones included."""
    if not soft:
        return _histogram_from_events_posed(ev_bin_f[None], ev_w[None],
                                            ev_ear[None], params)[0]
    nb = params.ir_length
    flat, ws = _soft_flat_bins(ev_bin_f, ev_w, ev_ear, params)
    hist = binning.histogram_sum_banded(flat, ws, 2 * nb)
    hist = hist.reshape(2, nb, params.n_bands)
    if params.n_bands == 1:
        return hist[:, :, 0]
    return hist.permute(0, 2, 1)


def _histogram_from_events_posed(ev_bin_f, ev_w, ev_ear,
                                 params: TraceParams) -> torch.Tensor:
    """Pose-batched events (ev_bin_f [P, E], ev_w [P, E, n_bands], ev_ear
    [P, E]) -> IRs [P, 2, ir_length], or [P, 2, n_bands, ir_length].

    One flat histogram per chunk of poses (flat bin = (pose * 2 + ear) *
    ir_length + bin), so P histograms cost one K3 launch per chunk. A chunk
    holds as many poses as keep its flat bins inside int32. Hard binning
    only. Only the same-ear deposits are summed; the cross-ear ones follow
    from the finished histogram by a shift over the pose axis: cross[j] =
    (1 - hrtf) * (same[j - delay] + same[j] for the last ``delay`` bins,
    the reference's overflow fallback, devicePrograms.cu:124-168)."""
    nb = params.ir_length
    dev = ev_bin_f.device
    p = ev_bin_f.shape[0]
    pose_chunk = max(1, (2**31 - 1) // (2 * nb) - 1)
    outs = []
    for start in range(0, p, pose_chunk):
        pb = ev_bin_f[start:start + pose_chunk]
        pw = ev_w[start:start + pose_chunk]
        pe = ev_ear[start:start + pose_chunk].to(torch.int32)
        pc = pb.shape[0]
        active = torch.any(pw != 0.0, dim=-1)
        b = torch.round(pb).to(torch.int32)
        pose = torch.arange(pc, dtype=torch.int32, device=dev)[:, None]
        flat = torch.where(active & (b >= 0) & (b < nb),
                           (pose * 2 + pe) * nb + b, pc * 2 * nb)
        hist = binning.histogram_sum_banded(
            flat.reshape(-1), pw.reshape(-1, params.n_bands), pc * 2 * nb)
        hist = hist.reshape(pc, 2, nb, params.n_bands)
        if not params.is_mono:
            scale = 1.0 - params.hrtf_absorption_rate
            delay = params.cross_ear_delay
            j = torch.arange(nb, device=dev)
            shifted = torch.roll(hist, delay, dims=2)
            mask = (j >= delay)[None, None, :, None]
            tail = (j >= nb - delay)[None, None, :, None]
            cross = scale * (torch.where(mask, shifted, 0.0)
                             + torch.where(tail, hist, 0.0))
            hist = hist + cross.flip(1)  # each ear receives the OTHER ear's
        outs.append(hist)
    hist = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    if params.n_bands == 1:
        return hist[:, :, :, 0]
    return hist.permute(0, 1, 3, 2)


def _as_vec(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def packed_scene(sc: SceneArrays, params: TraceParams, rows, boxes):
    """The scene's packed rows and boxes: the caller's, checked, or a fresh
    pack."""
    from ..ops import raytrace_cuda

    if rows is None:
        return raytrace_cuda.pack_scene(sc, params.n_bands)
    if (boxes is None) != (sc.cluster_boxes is None):
        raise ValueError("a clustered scene needs its packed boxes, and an "
                         "unclustered one none")
    return rows, boxes


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
    rows, boxes = packed_scene(sc, params, rows, boxes)
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
    device and trace them (``rows``, ``boxes`` as in :func:`trace_ir`).

    With ``opts.native_rng`` the generator gives only a seed (an integer
    below 2^23, which survives its f32 scalar slot exactly) and K4
    generates the directions while it initialises the state."""
    from ..ops import raytrace_cuda
    from . import sampling

    dev = sc.device
    if opts.native_rng:
        rows, boxes = packed_scene(sc, params, rows, boxes)
        seed = torch.randint(0, 2**23, (), generator=generator, device=dev)
        ev_bin_f, ev_w, ev_ear = raytrace_cuda.trace_events(
            rows, None, _as_vec(emitter, dev), _as_vec(receiver_pos, dev),
            float(receiver_yaw_deg), params, n_total_rays=n_total_rays,
            compact=opts.compact, round_budgets=opts.round_budgets,
            boxes=boxes, n_rays=n_rays, native_rng_seed=seed)
        return _histogram_from_events(ev_bin_f, ev_w, ev_ear, params,
                                      opts.soft_binning)
    dirs = sampling.sample_directions(n_rays, generator, dev)
    return trace_ir(sc, dirs, emitter, receiver_pos, receiver_yaw_deg,
                    params, opts, n_total_rays, rows, boxes)


def render_ir_pose_batch(sc: SceneArrays, seed: int, n_rays: int, emitters,
                         receivers, receiver_yaws_deg, params: TraceParams,
                         opts: TracerOptions = TracerOptions(),
                         pose_indices=None,
                         rows: torch.Tensor | None = None,
                         boxes: torch.Tensor | None = None) -> torch.Tensor:
    """Render P poses in one launch per round (the multi-pose fast path).

    ``emitters``, ``receivers`` [P, 3], ``receiver_yaws_deg`` [P]. Pose
    ``i`` draws its ``n_rays`` directions from
    ``sampling.pose_generator(seed, pose_indices[i], device)`` (default
    ``i``), the stream a single :func:`render_ir` of that pose sees from the
    same generator. Hard binning only: ``opts.soft_binning`` raises. Returns [P, 2, ir_length] on the scene's
    device, or [P, 2, n_bands, ir_length]."""
    from ..ops import raytrace_cuda
    from . import sampling

    if opts.soft_binning:
        raise ValueError("render_ir_pose_batch is a forward-rendering path "
                         "(hard binning); use render_ir per pose for "
                         "soft_binning gradients")
    dev = sc.device
    emitters = _as_vec(emitters, dev).reshape(-1, 3)
    if pose_indices is None:
        pose_indices = range(emitters.shape[0])
    directions = torch.stack([
        sampling.sample_directions(
            n_rays, sampling.pose_generator(seed, int(i), dev), dev)
        for i in pose_indices])
    rows, boxes = packed_scene(sc, params, rows, boxes)
    ev_bin_f, ev_w, ev_ear = raytrace_cuda.trace_events_pose_batch(
        rows, directions.to(device=dev, dtype=torch.float32).contiguous(),
        emitters, _as_vec(receivers, dev).reshape(-1, 3),
        _as_vec(receiver_yaws_deg, dev).reshape(-1), params,
        compact=opts.compact, round_budgets=opts.round_budgets, boxes=boxes)
    return _histogram_from_events_posed(ev_bin_f, ev_w, ev_ear, params)
