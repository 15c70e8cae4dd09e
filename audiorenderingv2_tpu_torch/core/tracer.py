"""The path tracer: scene arrays, the trace entry points and the histogram.

The counterpart of ``audiorenderingv2_tpu/core/tracer.py``. Every entry
(``trace_ir``, ``render_ir``, ``render_ir_pose_batch``, ``packed_scene``,
and outside this module the matrix and the path recorder) takes its kernels
from :func:`trace_route`, whose docstring holds the route table. The
kernels run forward only (``ops/raytrace_cuda.py:trace_state`` drives
them); the ``"autograd"`` backend (the JAX package's ``"xla"``) is the
bounce loop as out-of-place PyTorch ops over blocks of rays
(``_bounce_step``), differentiable in absorption, emitter, receiver and the
geometry rows: the ``"full"`` method of ``diff/inverse.py`` and the oracle
of ``diff/replay.py``. Both end in the same histogram, whose backward is
K3-bwd. The tensors' device picks the kernels: a CUDA tensor launches
them, a CPU tensor runs their plain versions.

Geometry stays elementwise: no dot product here is a matmul or an einsum,
which on the card could run in TF32 and lose the bits that decide whether a
ray grazes a triangle edge.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from ..ops import histogram_cuda, raytrace_cuda
from ..ops.raytrace_cuda import Route
from ..utils import profiling
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

    ``backend``: ``"kernels"`` (the hand-written kernels, forward only; its
    ``"pallas"``) or ``"autograd"`` (out-of-place PyTorch ops that autograd
    can differentiate; its ``"xla"``). The rest are the autograd backend's:
    ``block_size`` rays advance in lockstep, ``tri_chunk`` triangles per
    step of the nearest-hit search, ``early_exit`` stops a block when all
    its rays are done (forward only: it reads a flag back per bounce),
    ``remat`` recomputes each block in the backward pass instead of keeping
    its activations (``torch.utils.checkpoint``, non-reentrant).

    ``schedule`` (its ``pallas_schedule``; ``tuned.auto_options`` sets it),
    ``layout``, ``version`` and ``precision`` (its ``pallas_layout``,
    ``pallas_version``, ``pallas_precision``) pick the kernels with
    ``backend``, as :func:`trace_route` tabulates: ``schedule`` the per-tile
    schedule and K2 on a clustered scene, else K5; ``layout="group"`` K6
    (``ops/group_cuda.py``), which forms the six plane and barycentric
    quantities of eight triangles at a time as a [48, 8] x [8] product per
    ray; ``version=1`` K7 (``ops/v1_cuda.py``), the rays-in-rows kernel.
    ``precision`` is K6's product's: ``"highest"`` is exact f32, ``"high"``
    (the JAX package's ``"high"`` and its alias ``"split3"``) splits both
    operands into bf16 high and low parts and sums three products, about
    2^-17 relative; the other kernels ignore it.

    The JAX package's other options that only tuned its TPU kernels have no
    field here; ``convert.tracer_options_from_jax`` drops them.
    """

    soft_binning: bool = False
    compact: bool = True
    round_budgets: tuple | None = None
    native_rng: bool = False
    schedule: bool = False
    backend: str = "kernels"
    block_size: int = 8192
    tri_chunk: int = 2048
    early_exit: bool = True
    remat: bool = False
    layout: str = "rows"
    version: int = 2
    precision: str = "highest"

    def __post_init__(self):
        if self.backend not in ("kernels", "autograd"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.layout not in ("rows", "group"):
            raise ValueError(f"layout must be rows|group, got "
                             f"{self.layout!r}")
        if self.version not in (1, 2):
            raise ValueError(f"version must be 1 or 2, got {self.version!r}")
        from ..ops.group_cuda import check_precision

        check_precision(self.precision)


def scene_to_arrays(scene, tri_chunk: int = 2048,
                    absorption: np.ndarray | None = None,
                    device: torch.device | str = "cuda",
                    clusters=None) -> SceneArrays:
    """Pack a host Scene into f32 tensors on ``device`` (the card unless
    the caller asks for the CPU: the entry points that take these arrays
    run where they lie), padded to a whole number of triangle chunks. ``absorption`` may override the scene's
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


# ------------------------------------------------------ the autograd backend

_BARY_EPS = 1e-7


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of [..., 3] tensors as two adds, never a
    matmul (see the module docstring)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for a 1-D int64 ``index``, as ``index_select``: its
    backward is one ``index_add_`` (atomics on the card), where the
    backward of ``table[index]`` sorts the indices first and, with a
    million rays gathering from twenty thousand triangle rows, took some
    thirty times as long on an H100 (``chip_smoke.py`` times the two)."""
    return table.index_select(0, index)


def _intersect_block(sc: SceneArrays, pos: torch.Tensor, dirn: torch.Tensor,
                     tri_chunk: int):
    """Nearest triangle hit of each ray of a block: (t [B], inf on a miss,
    triangle index int64 [B]).

    The search over all T triangles, ``tri_chunk`` at a time with a strict
    running minimum (ties to the lowest index), builds no graph: the
    gradient of a minimum is the gradient of its winner, so ``t`` is then
    recomputed from the winning triangle's plane row with the same
    operations, which gives the same bits and a graph of O(B) size, where
    differentiating the search itself would keep [B, T] activations."""
    t_total = sc.plane_n.shape[0]
    tri_chunk = min(tri_chunk, t_total)
    with torch.no_grad():
        p, d = pos.detach()[:, None, :], dirn.detach()[:, None, :]
        b = pos.shape[0]
        t_best = torch.full((b,), math.inf, dtype=torch.float32,
                            device=pos.device)
        i_best = torch.zeros((b,), dtype=torch.int64, device=pos.device)
        for c0 in range(0, t_total, tri_chunk):
            c = slice(c0, c0 + tri_chunk)
            pn, au, av = (x.detach()[None, c] for x in
                          (sc.plane_n, sc.bary_u, sc.bary_v))
            nd = _dot3(d, pn)                              # [B, Tc]
            no = _dot3(p, pn) + sc.plane_d.detach()[None, c]
            safe = torch.abs(nd) > 1e-12
            t = -no / torch.where(safe, nd, 1.0)
            u = (_dot3(p, au) + sc.u_off[None, c]) + t * _dot3(d, au)
            v = (_dot3(p, av) + sc.v_off[None, c]) + t * _dot3(d, av)
            ok = (safe & (t > constants.T_MIN)
                  & (u >= -_BARY_EPS) & (v >= -_BARY_EPS)
                  & (u + v <= 1.0 + _BARY_EPS) & (sc.valid[None, c] > 0))
            t_min, i_min = torch.where(ok, t, math.inf).min(dim=1)
            better = t_min < t_best
            t_best = torch.where(better, t_min, t_best)
            i_best = torch.where(better, i_min + c0, i_best)
    hit = t_best < math.inf
    pn = _rows(sc.plane_n, i_best)
    nd = _dot3(dirn, pn)
    no = _dot3(pos, pn) + _rows(sc.plane_d, i_best)
    t = -no / torch.where(hit & (torch.abs(nd) > 1e-12), nd, 1.0)
    return torch.where(hit, t, math.inf), i_best


def _sphere_entry(pos: torch.Tensor, dirn: torch.Tensor,
                  center: torch.Tensor):
    """The analytic receiver-sphere crossing: (t_hit [B], inf on a miss,
    chord [B]). The chord is the secant through the radius-1 sphere, the
    deposited-energy factor; an origin inside the sphere hits the far
    surface. The inner ``where`` keeps the square root of a negative
    discriminant, and with it a NaN gradient, out of the graph."""
    oc = pos - center[None, :]
    b = _dot3(oc, dirn)
    c = _dot3(oc, oc) - constants.RECEIVER_RADIUS ** 2
    disc = b * b - c
    hit = disc > 0.0
    s = torch.sqrt(torch.where(hit, disc, 0.0))
    t1 = -b - s
    t2 = -b + s
    t_hit = torch.where(hit & (t1 > constants.T_MIN), t1,
                        torch.where(hit & (t2 > constants.T_MIN), t2,
                                    math.inf))
    return t_hit, t2 - t1


class _RayState(NamedTuple):
    pos: torch.Tensor       # [B, 3]
    dirn: torch.Tensor      # [B, 3]
    dist: torch.Tensor      # [B]
    energy: torch.Tensor    # [B, n_bands]
    depth: torch.Tensor     # [B] int32
    done: torch.Tensor      # [B] bool
    ev_bin_f: torch.Tensor  # [B] fractional arrival bin of the one deposit
    ev_w: torch.Tensor      # [B, n_bands] deposited energy
    ev_ear: torch.Tensor    # [B] int32, 0 left / 1 right


def band_absorption(sc: SceneArrays, n_bands: int) -> torch.Tensor:
    """The scene's absorption as [T, n_bands]; only a one-band table
    broadcasts over the bands."""
    absorb = sc.absorption
    if absorb.dim() == 1:
        absorb = absorb[:, None]
    if absorb.shape[1] != n_bands:
        if absorb.shape[1] != 1:
            raise ValueError(f"scene has {absorb.shape[1]} absorption bands "
                             f"but params ask for {n_bands}; only 1-band "
                             f"scenes broadcast")
        absorb = absorb.expand(-1, n_bands)
    return absorb


def _bounce_step(state: _RayState, sc: SceneArrays, rec_center, yaw_rad,
                 params: TraceParams, opts: TracerOptions):
    """One bounce of a block, out of place (autograd keeps every tensor it
    saved): the physics of the kernels' tail, receiver before surface.
    Returns the new state and the step's topology (surface bool [B],
    receiver bool [B], tri int64 [B]): which rays bounced, which reached
    the receiver, and the triangle the search found."""
    can_continue = ((state.dist < params.distance_threshold)
                    & (state.energy.amax(dim=-1) > params.energy_threshold)
                    & (state.depth < params.max_bounces))
    alive = ~state.done & can_continue

    t_tri, tri = _intersect_block(sc, state.pos, state.dirn, opts.tri_chunk)
    t_sph, chord = _sphere_entry(state.pos, state.dirn, rec_center)

    receiver = alive & (t_sph < t_tri)
    surface = alive & ~receiver & torch.isfinite(t_tri)
    miss = alive & ~receiver & ~surface

    # The receiver event: the ray's one deposit. Each inner ``where`` turns
    # an infinite distance into 0 before it meets a product.
    t_sph_safe = torch.where(torch.isfinite(t_sph), t_sph, 0.0)
    dist_r = state.dist + t_sph_safe
    d_local = state.pos + t_sph_safe[:, None] * state.dirn - rec_center[None]
    local_z = (-torch.sin(yaw_rad) * d_local[:, 0]
               + torch.cos(yaw_rad) * d_local[:, 2])
    ear = (local_z >= 0.0).to(torch.int32)
    bin_f = dist_r * (params.sample_rate / constants.SPEED_OF_SOUND)

    # The surface bounce: reflect, absorb, offset, advance.
    t_tri_safe = torch.where(torch.isfinite(t_tri), t_tri, 0.0)
    n = _rows(sc.normal, tri)
    refl = state.dirn - 2.0 * _dot3(state.dirn, n)[:, None] * n
    hit_p = state.pos + t_tri_safe[:, None] * state.dirn
    new_pos = hit_p + constants.BOUNCE_EPSILON * refl
    absorb = _rows(band_absorption(sc, state.energy.shape[1]), tri)

    sm = surface[:, None]
    return _RayState(
        pos=torch.where(sm, new_pos, state.pos),
        dirn=torch.where(sm, refl, state.dirn),
        dist=torch.where(surface, state.dist + t_tri_safe, state.dist),
        energy=torch.where(sm, state.energy * (1.0 - absorb), state.energy),
        depth=torch.where(surface, state.depth + 1, state.depth),
        done=state.done | receiver | miss | ~can_continue,
        ev_bin_f=torch.where(receiver, bin_f, state.ev_bin_f),
        ev_w=torch.where(receiver[:, None], state.energy * chord[:, None],
                         state.ev_w),
        ev_ear=torch.where(receiver, ear, state.ev_ear),
    ), (surface, receiver, tri)


def _start_state(dirs_block, energy0, emitter, n_bands: int) -> _RayState:
    """A block of rays at the emitter, ``energy0`` [B] in every band."""
    b = dirs_block.shape[0]
    dev = dirs_block.device
    return _RayState(
        pos=emitter[None, :].expand(b, 3),
        dirn=dirs_block,
        dist=torch.zeros(b, device=dev),
        energy=energy0[:, None].expand(b, n_bands),
        depth=torch.zeros(b, dtype=torch.int32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        ev_bin_f=torch.zeros(b, device=dev),
        ev_w=torch.zeros((b, n_bands), device=dev),
        ev_ear=torch.zeros(b, dtype=torch.int32, device=dev),
    )


def _trace_block(dirs_block, energy0, sc, emitter, rec_center, yaw_rad,
                 params: TraceParams, opts: TracerOptions):
    """Trace one block of rays to the end; returns its event slots and
    each ray's completed bounces."""
    state = _start_state(dirs_block, energy0, emitter, params.n_bands)
    for _ in range(params.max_bounces):
        if opts.early_exit and bool(state.done.all()):
            break
        state, _ = _bounce_step(state, sc, rec_center, yaw_rad, params, opts)
    return state.ev_bin_f, state.ev_w, state.ev_ear, state.depth


def _trace_events_autograd(sc: SceneArrays, directions, emitter, rec_center,
                           receiver_yaw_deg, params: TraceParams,
                           opts: TracerOptions, n_total_rays: int | None):
    """The event slots of ``directions`` [N, 3] through the autograd
    backend, block by block: (ev_bin_f [N], ev_w [N, n_bands], ev_ear
    int32 [N], depth int32 [N], each ray's completed bounces). A tail block
    is padded with zero directions of zero energy."""
    from torch.utils.checkpoint import checkpoint

    n = directions.shape[0]
    n_total = n_total_rays if n_total_rays is not None else n
    block = min(opts.block_size, n)
    e0 = params.base_power / (n_total * constants.SPHERE_VOLUME)
    yaw_rad = torch.deg2rad(_as_vec(receiver_yaw_deg, sc.device))

    def block_fn(d, e):
        return _trace_block(d, e, sc, emitter, rec_center, yaw_rad, params,
                            opts)

    outs = []
    for start in range(0, n, block):
        d = directions[start:start + block]
        e = torch.full((block,), e0, dtype=torch.float32, device=d.device)
        if d.shape[0] < block:
            e[d.shape[0]:] = 0.0
            d = torch.cat([d, d.new_zeros((block - d.shape[0], 3))])
        if opts.remat and torch.is_grad_enabled():
            outs.append(checkpoint(block_fn, d, e, use_reentrant=False))
        else:
            outs.append(block_fn(d, e))
    return tuple(torch.cat([o[k] for o in outs])[:n] for k in range(4))


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
    [P, E]) -> IRs [P, 2, ir_length], or [P, 2, n_bands, ir_length]. Hard
    binning only.

    The stage is one launch on the card (``histogram_cuda.histogram_binned``:
    each event's same-ear and cross-ear deposits added directly). When the
    weights need a gradient it is the two-step stage through the
    differentiable K3 instead (``histogram_binned_plain`` with
    ``binning.histogram_sum_banded``: forward K3, backward K3-bwd), which is
    also the plain version a CPU tensor runs (with ``index_add_``)."""
    stage = (params.ir_length, params.is_mono, params.cross_ear_delay,
             params.hrtf_absorption_rate)
    if torch.is_grad_enabled() and ev_w.requires_grad:
        hist = histogram_cuda.histogram_binned_plain(
            ev_bin_f, ev_w, ev_ear, *stage,
            summed=binning.histogram_sum_banded)
    else:
        hist = histogram_cuda.histogram_binned(
            ev_bin_f.contiguous(), ev_w.contiguous(), ev_ear.contiguous(),
            *stage)
    if params.n_bands == 1:
        return hist[:, :, :, 0]
    return hist.permute(0, 1, 3, 2)


def _as_vec(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def trace_route(opts: TracerOptions, n_bands: int, clustered: bool,
                entry: str = "trace") -> Route | None:
    """The kernels a trace under ``opts`` runs, for a scene of ``n_bands``
    bands that carries cluster boxes or not: the one place that reads the
    options' ``backend``, ``version``, ``layout`` and ``schedule``. None is
    the differentiable tracer (``backend="autograd"``); otherwise the
    ``raytrace_cuda.Route``:

    ======================  ==========================  ===================
    options, scene          round kernel                reorder
    ======================  ==========================  ===================
    ``version=1``, 1 band   K7 over every triangle,     partition
                            row-major state, no cull
    ``version=1``, bands    None: K7 carries one band   (the JAX package's
                                                        gate, ``pallas_ok``)
    ``layout="group"``      K6, its product at          partition
                            ``precision``; refuses a
                            clustered scene
    unclustered             K1 over the rows            partition
    clustered, schedule     the schedule, then K2;      sort (dir72 keys)
                            one bounce a round
    clustered               K5, the traversal in the    sort
                            kernel; any round budgets
    ======================  ==========================  ===================

    ``compact=False`` leaves out the reorder (one round of ``max_bounces``
    unless ``round_budgets`` say otherwise). ``entry`` names the caller
    and its refusals, each raising the text its entry always raised:
    ``"trace"`` (``trace_ir``, ``packed_scene``, the matrix);
    ``"render"`` (``render_ir``: ``native_rng`` on version 2 asks for K4,
    which the route's ``k4`` offers on every kernel but K7, and refuses the
    autograd backend); ``"pose_batch"`` (refuses the autograd backend, soft
    binning and version 1; ``trace_events_pose_batch`` refuses K5); ``"record"`` (the
    path recorder: version 2's kernels whatever ``backend`` and
    ``version`` say, always reordered). Pure Python on the options: no
    device work, resolved once a trace, never a round."""
    version, backend = ((2, "kernels") if entry == "record"
                        else (opts.version, opts.backend))
    if entry == "pose_batch":
        if backend != "kernels":
            raise ValueError(f"render_ir_pose_batch runs the forward-only "
                             f"kernels; it has no backend={backend!r} form")
        if opts.soft_binning:
            raise ValueError("render_ir_pose_batch is a forward-rendering "
                             "path (hard binning); use render_ir per pose "
                             "for soft_binning gradients")
        if version != 2:
            raise ValueError("render_ir_pose_batch requires the kernels "
                             "backend with version=2; render per pose via "
                             "render_ir for other backends")
    if backend != "kernels":
        if entry == "render" and opts.native_rng and version == 2:
            raise ValueError(f"native_rng runs the forward-only kernels; it "
                             f"has no backend={backend!r} form")
        return None
    compact = opts.compact or entry == "record"
    if version == 1:
        return (None if n_bands > 1 else
                Route("k7", "partition" if compact else None))
    if opts.layout == "group":
        if clustered:
            raise ValueError("group layout cannot carry cluster boxes")
        kernel = "k6"
    elif not clustered:
        kernel = "k1"
    else:
        kernel = "sched" if opts.schedule else "k5"
    reorder = ("sort" if clustered else "partition") if compact else None
    return Route(kernel, reorder, opts.precision)


def pack_for_route(sc: SceneArrays, params: TraceParams, rows, boxes,
                   route: Route | None):
    """The scene's packed triangles and boxes for ``route``
    (``raytrace_cuda.pack_scene``): the caller's, checked, or a fresh pack.
    K7 never culls: its boxes are None whatever the scene carries."""
    if route is None:
        return rows, boxes  # the differentiable tracer reads the scene
    if rows is None:
        return raytrace_cuda.pack_scene(sc, params.n_bands, route)
    grouped = route.kernel == "k6"
    if isinstance(rows, tuple) != grouped:
        raise ValueError(f"the packed triangles are not those of layout="
                         f"{'group' if grouped else 'rows'!r}, version="
                         f"{1 if route.kernel == 'k7' else 2}: pack them "
                         f"with raytrace_cuda.pack_scene under the same "
                         f"options")
    return rows, None if route.kernel == "k7" else boxes


def packed_scene(sc: SceneArrays, params: TraceParams, rows, boxes,
                 opts: TracerOptions = TracerOptions()):
    """:func:`pack_for_route` for the route of ``opts`` on ``sc``."""
    return pack_for_route(sc, params, rows, boxes, trace_route(
        opts, params.n_bands, sc.cluster_boxes is not None))


def _trace(sc: SceneArrays, route: Route | None, directions, emitter,
           receiver_pos, receiver_yaw_deg, params: TraceParams,
           opts: TracerOptions, n_total_rays, rows, boxes, with_stats: bool,
           n_rays: int | None = None, seed: torch.Tensor | None = None):
    """The IR of one trace on ``route``: ``directions`` [N, 3] on the
    scene's device, or None for K4's ``n_rays`` from ``seed``."""
    dev = sc.device
    emitter, receiver_pos = _as_vec(emitter, dev), _as_vec(receiver_pos, dev)
    if route is None:
        events = _trace_events_autograd(sc, directions, emitter, receiver_pos,
                                        receiver_yaw_deg, params, opts,
                                        n_total_rays)
    else:
        rows, boxes = pack_for_route(sc, params, rows, boxes, route)
        events = raytrace_cuda.trace_events(
            rows, None if directions is None else directions.contiguous(),
            emitter, receiver_pos, float(receiver_yaw_deg), params,
            n_total_rays, route=route, boxes=boxes,
            round_budgets=opts.round_budgets, n_rays=n_rays,
            native_rng_seed=seed, return_depth=with_stats)
    with profiling.span("ar2.bin"):
        ir = _histogram_from_events(*events[:3], params, opts.soft_binning)
    if not with_stats:
        return ir
    return ir, {"bounces": events[3].to(torch.float32)}


def trace_ir(sc: SceneArrays, directions: torch.Tensor, emitter,
             receiver_pos, receiver_yaw_deg: float, params: TraceParams,
             opts: TracerOptions = TracerOptions(),
             n_total_rays: int | None = None,
             rows: torch.Tensor | None = None,
             boxes: torch.Tensor | None = None,
             with_stats: bool = False):
    """Trace ``directions`` [N, 3] and return the stereo IR histogram on
    the scene's device: f32 [2, ir_length], or [2, n_bands, ir_length]
    when ``params.n_bands > 1``. Mono folding is the renderer's job. The
    kernels are those of :func:`trace_route`.

    ``rows``, ``boxes``: the scene's packed triangles and cluster boxes
    (:func:`packed_scene` under the same options), packed once per scene
    by a caller that renders it many times; None packs them here.

    With ``opts.backend == "autograd"`` the trace is differentiable:
    ``emitter``, ``receiver_pos`` and the scene's tensors may require
    gradients (with ``opts.soft_binning`` the arrival time has one too);
    ``rows`` and ``boxes`` are not used.

    ``with_stats`` returns ``(ir, {"bounces": f32})`` instead: each ray's
    completed bounces, the useful-work count. The kernels give it for the
    padded state, [N rounded up to 128], in the order the state ends in
    (the reorder permutes the rays; padding rays count 0); the autograd
    backend for the N rays in order."""
    directions = directions.to(device=sc.device, dtype=torch.float32)
    route = trace_route(opts, params.n_bands, sc.cluster_boxes is not None)
    return _trace(sc, route, directions, emitter, receiver_pos,
                  receiver_yaw_deg, params, opts, n_total_rays, rows, boxes,
                  with_stats)


def render_ir(sc: SceneArrays, generator: torch.Generator, n_rays: int,
              emitter, receiver_pos, receiver_yaw_deg: float,
              params: TraceParams, opts: TracerOptions = TracerOptions(),
              n_total_rays: int | None = None,
              rows: torch.Tensor | None = None,
              boxes: torch.Tensor | None = None,
              with_stats: bool = False):
    """Sample ``n_rays`` directions from ``generator`` on the scene's
    device and trace them (``rows``, ``boxes``, ``with_stats`` as in
    :func:`trace_ir`).

    With ``opts.native_rng`` on a route with K4 the generator gives only a
    seed (an integer below 2^23, which survives its f32 scalar slot
    exactly) and K4 generates the directions while it initialises the
    state; K7 samples them, as in the JAX package."""
    from . import sampling

    dev = sc.device
    route = trace_route(opts, params.n_bands, sc.cluster_boxes is not None,
                        "render")
    seed = dirs = None
    with profiling.span("ar2.trace.init"):
        if opts.native_rng and route is not None and route.k4:
            seed = torch.randint(0, 2**23, (), generator=generator,
                                 device=dev)
        else:
            dirs = sampling.sample_directions(n_rays, generator, dev)
    return _trace(sc, route, dirs, emitter, receiver_pos, receiver_yaw_deg,
                  params, opts, n_total_rays, rows, boxes, with_stats,
                  n_rays=n_rays, seed=seed)


def render_ir_pose_batch(sc: SceneArrays, seed: int, n_rays: int, emitters,
                         receivers, receiver_yaws_deg, params: TraceParams,
                         opts: TracerOptions = TracerOptions(),
                         pose_indices=None,
                         rows: torch.Tensor | None = None,
                         boxes: torch.Tensor | None = None,
                         n_total_rays_per_pose: int | None = None,
                         rank: int | None = None) -> torch.Tensor:
    """Render P poses in one launch per round (the multi-pose fast path),
    on a route of :func:`trace_route` with a posed form, hard binning only.

    ``emitters``, ``receivers`` [P, 3], ``receiver_yaws_deg`` [P]. Pose
    ``i`` draws its ``n_rays`` directions from
    ``sampling.pose_generator(seed, pose_indices[i], device)`` (default
    ``i``), the stream a single :func:`render_ir` of that pose sees from the
    same generator. ``n_total_rays_per_pose``: the ray count that
    normalises each pose's energy when this call traces a share of each
    pose's rays (default ``n_rays``); ``rank``: the share's rank, whose
    directions come from ``sampling.pose_generator(seed, pose_indices[i],
    device, rank)``. Returns [P, 2, ir_length] on the scene's device, or
    [P, 2, n_bands, ir_length]."""
    from . import sampling

    route = trace_route(opts, params.n_bands, sc.cluster_boxes is not None,
                        "pose_batch")
    dev = sc.device
    emitters = _as_vec(emitters, dev).reshape(-1, 3)
    if pose_indices is None:
        pose_indices = range(emitters.shape[0])
    with profiling.span("ar2.trace.init"):
        directions = torch.stack([
            sampling.sample_directions(
                n_rays, sampling.pose_generator(seed, int(i), dev, rank), dev)
            for i in pose_indices])
    rows, boxes = pack_for_route(sc, params, rows, boxes, route)
    ev_bin_f, ev_w, ev_ear = raytrace_cuda.trace_events_pose_batch(
        rows, directions.to(device=dev, dtype=torch.float32).contiguous(),
        emitters, _as_vec(receivers, dev).reshape(-1, 3),
        _as_vec(receiver_yaws_deg, dev).reshape(-1), params,
        n_total_rays_per_pose, route=route, boxes=boxes,
        round_budgets=opts.round_budgets)
    with profiling.span("ar2.bin"):
        return _histogram_from_events_posed(ev_bin_f, ev_w, ev_ear, params)
