"""The replay of recorded paths (``diff/replay.py``): the eager chain, and
the kernel pair of an absorption-only gradient.

``chain_events`` is the replay as out-of-place PyTorch ops, one step of
every ray at a time, differentiable in everything: absorption, poses and
the triangle rows. Its backward gathers the absorption gradient of every
step into the table by ``index_add_``: a million rows a step, whose atomics
queue on the few shell triangles most bounces land on.

With the poses and the geometry fixed only a ray's weight depends on the
parameters, ``e0 * prod (1 - a) * chord`` over the steps before the ray
reaches the receiver, and the replay is one kernel pair
(``csrc/replay.cu``): ``ar2_replay`` walks each depositing ray's recorded
triangles in registers, ``ar2_replay_bwd`` reduces the gradient of the
weights into the table, warp by warp and through a per-block copy of the
table in shared memory where it fits. The pair replaces no TPU kernel: the
JAX package's ``replay_events`` is a ``lax.scan`` of plain XLA. More in the
source's header.

``replay`` and ``replay_bwd`` launch the kernels for CUDA tensors and run
the plain versions, ``replay_plain`` (``chain_events`` over the depositing
rays and the steps up to the last deposit) and ``replay_bwd_plain`` (the
products before and after each step by ``cumprod``, one ``index_add_``),
for CPU tensors. They never fall back from one to the other.
``replay_absorption`` joins them in a ``torch.autograd.Function``.
``launches`` and ``bwd_launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core.tracer import _dot3, _rows, _sphere_entry
from . import _build

# Kernel launches since import (or since a caller reset it to 0).
launches = 0
bwd_launches = 0


def chain_events(plane_n, plane_d, normal, absorb, tri_ids, recv_step, dirn,
                 emitter, rec_center, sin_y, cos_y, e0: float,
                 bin_rate: float):
    """The replay's steps as eager PyTorch ops over all rays and all of
    ``tri_ids``' K steps; returns (ev_bin_f [N], ev_w [N, n_bands], ev_ear
    int32 [N], chord [N]), chord 0 where a ray deposits nothing.

    Per step: one gather of the known triangle's plane, normal and
    absorption and one plane intersection, no search. Every step is out of
    place, so autograd differentiates it in every input."""
    n = tri_ids.shape[0]
    dev = dirn.device
    pos = emitter[None, :].expand(n, 3)
    dist = torch.zeros(n, device=dev)
    energy = torch.full((n, absorb.shape[1]), e0, device=dev)
    ev_bin = torch.zeros(n, device=dev)
    ev_w = torch.zeros((n, absorb.shape[1]), device=dev)
    ev_ear = torch.zeros(n, dtype=torch.int32, device=dev)
    ev_chord = torch.zeros(n, device=dev)
    for k in range(tri_ids.shape[1]):
        # The receiver deposit comes before this step's surface advance. On
        # a recorded path the sphere is hit wherever recv_step says so; the
        # other rays are guarded all the same.
        t_sph, chord = _sphere_entry(pos, dirn, rec_center)
        t_safe = torch.where(torch.isfinite(t_sph), t_sph, 0.0)
        d_local = pos + t_safe[:, None] * dirn - rec_center[None, :]
        local_z = -sin_y * d_local[:, 0] + cos_y * d_local[:, 2]
        ok = (recv_step == k) & torch.isfinite(t_sph)
        ev_bin = torch.where(ok, (dist + t_safe) * bin_rate, ev_bin)
        ev_w = torch.where(ok[:, None], energy * chord[:, None], ev_w)
        ev_ear = torch.where(ok, (local_z >= 0.0).to(torch.int32), ev_ear)
        ev_chord = torch.where(ok, chord, ev_chord)

        tri = tri_ids[:, k]
        surface = tri >= 0
        ti = torch.clamp(tri, min=0).long()
        pn, nrm = _rows(plane_n, ti), _rows(normal, ti)
        nd = _dot3(pn, dirn)
        no = _dot3(pn, pos) + _rows(plane_d, ti)
        t = -no / torch.where(torch.abs(nd) > 1e-12, nd, 1.0)
        refl = dirn - 2.0 * _dot3(dirn, nrm)[:, None] * nrm
        hit_p = pos + t[:, None] * dirn
        sm = surface[:, None]
        pos = torch.where(sm, hit_p + constants.BOUNCE_EPSILON * refl, pos)
        dirn = torch.where(sm, refl, dirn)
        dist = torch.where(surface, dist + t, dist)
        energy = torch.where(sm, energy * (1.0 - _rows(absorb, ti)), energy)
    # recv_step is always below K: a ray at depth max_bounces may not
    # continue and deposits nothing, so the loop covers every deposit.
    return ev_bin, ev_w, ev_ear, ev_chord


@torch.no_grad()
def replay_plain(tri_ids, recv_step, dirs, scal, plane_n, plane_d, normal,
                 absorb, e0: float, bin_rate: float):
    """Plain PyTorch version of ``ar2_replay``: :func:`chain_events` over
    the rays that deposit and the steps up to the last deposit, the others'
    slots left at 0 (each element's arithmetic is the chain's, so the
    events are the chain's bit for bit). Returns (ev_bin_f, ev_w, ev_ear,
    chord)."""
    n, k_all = tri_ids.shape
    dep = torch.nonzero((recv_step >= 0) & (recv_step < k_all)).squeeze(1)
    k = int(recv_step[dep].max()) + 1 if dep.numel() else 1
    sub = chain_events(plane_n, plane_d, normal, absorb, tri_ids[dep, :k],
                       recv_step[dep], dirs[dep], scal[0:3], scal[3:6],
                       scal[6], scal[7], e0, bin_rate)
    out = []
    for x in sub:
        full = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        full[dep] = x
        out.append(full)
    return tuple(out)


def replay(tri_ids, recv_step, dirs, scal, plane_n, plane_d, normal, absorb,
           e0: float, bin_rate: float):
    """The events of recorded paths with fixed poses and geometry: int32
    ``tri_ids`` [N, K] and ``recv_step`` [N], ``dirs`` [N, 3], ``scal`` [8]
    (emitter, receiver centre, sin and cos of the yaw), the triangle rows
    ``plane_n`` [T, 3], ``plane_d`` [T], ``normal`` [T, 3] and ``absorb``
    [T, n_bands]. Returns (ev_bin_f [N], ev_w [N, n_bands], ev_ear int32
    [N], chord [N]) on the input's device: one launch of ``ar2_replay`` for
    CUDA tensors (contiguous float32, 1 to 8 bands), :func:`replay_plain`
    for CPU tensors."""
    global launches
    dev = tri_ids.device
    if tri_ids.dtype != torch.int32 or recv_step.dtype != torch.int32:
        raise TypeError(f"replay needs int32 tri_ids and recv_step, got "
                        f"{tri_ids.dtype} and {recv_step.dtype}")
    if tri_ids.dim() != 2 or tuple(recv_step.shape) != tri_ids.shape[:1] \
            or tuple(dirs.shape) != (tri_ids.shape[0], 3) \
            or tuple(scal.shape) != (8,) or absorb.dim() != 2:
        raise ValueError(f"replay needs tri_ids [N, K], recv_step [N], dirs "
                         f"[N, 3], scal [8] and absorb [T, n_bands], got "
                         f"{tuple(tri_ids.shape)}, {tuple(recv_step.shape)}, "
                         f"{tuple(dirs.shape)}, {tuple(scal.shape)}, "
                         f"{tuple(absorb.shape)}")
    n_tris = absorb.shape[0]
    if tuple(plane_n.shape) != (n_tris, 3) or tuple(normal.shape) != (
            n_tris, 3) or tuple(plane_d.shape) != (n_tris,):
        raise ValueError(f"replay needs triangle rows of {n_tris} triangles, "
                         f"got {tuple(plane_n.shape)}, "
                         f"{tuple(plane_d.shape)}, {tuple(normal.shape)}")
    tensors = (recv_step, dirs, scal, plane_n, plane_d, normal, absorb)
    if any(x.device != dev for x in tensors):
        raise ValueError(f"replay's inputs are on {dev} and "
                         f"{sorted({str(x.device) for x in tensors})}")
    if dev.type == "cpu":
        return replay_plain(tri_ids, recv_step, dirs, scal, plane_n, plane_d,
                            normal, absorb, e0, bin_rate)
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    floats = tensors[1:]
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError(f"the replay kernel needs float32 rows, got "
                        f"{[str(x.dtype) for x in floats]}")
    if not all(x.is_contiguous() for x in (tri_ids, *tensors)):
        raise ValueError("the replay kernel needs contiguous inputs")
    (n, k_steps), n_bands = tri_ids.shape, absorb.shape[1]
    if not 1 <= n_bands <= 8:
        raise ValueError(f"the replay kernel takes 1 to 8 bands, got "
                         f"{n_bands}")
    ev_bin = torch.empty((n,), dtype=torch.float32, device=dev)
    ev_w = torch.empty((n, n_bands), dtype=torch.float32, device=dev)
    ev_ear = torch.empty((n,), dtype=torch.int32, device=dev)
    chord = torch.empty((n,), dtype=torch.float32, device=dev)
    err = _build.library().ar2_replay(
        tri_ids.data_ptr(), n, k_steps, recv_step.data_ptr(),
        dirs.data_ptr(), scal.data_ptr(), plane_n.data_ptr(),
        plane_d.data_ptr(), normal.data_ptr(), absorb.data_ptr(), n_tris,
        n_bands, e0, bin_rate, constants.BOUNCE_EPSILON, constants.T_MIN,
        constants.RECEIVER_RADIUS ** 2, ev_bin.data_ptr(), ev_w.data_ptr(),
        ev_ear.data_ptr(), chord.data_ptr(), _build.stream(dev))
    launches += 1
    _build.check(err, "ar2_replay")
    return ev_bin, ev_w, ev_ear, chord


def replay_bwd_plain(tri_ids, recv_step, chord, g, absorb, e0: float):
    """Plain PyTorch version of ``ar2_replay_bwd``: the gradient [T,
    n_bands] of the table ``absorb`` given ``g`` = d loss / d ev_w [N,
    n_bands]; visit k of a depositing ray adds ``-(g * chord * e0) *
    prod_{j < k} (1 - a_j) * prod_{j > k} (1 - a_j)`` at its triangle, the
    products over the steps before the deposit that left a surface."""
    grad = torch.zeros(absorb.shape, dtype=absorb.dtype, device=absorb.device)
    dep = torch.nonzero((recv_step > 0) & (recv_step < tri_ids.shape[1])
                        & (chord != 0)).squeeze(1)
    if dep.numel() == 0:
        return grad
    rs = recv_step[dep]
    k = int(rs.max())
    ids = tri_ids[dep, :k].long()
    counted = (ids >= 0) & (torch.arange(k, device=ids.device) < rs[:, None])
    ti = torch.where(counted, ids, 0)
    f = torch.where(counted[..., None], 1.0 - absorb[ti], 1.0)
    ones = torch.ones_like(f[:, :1])
    below = torch.cumprod(torch.cat([ones, f[:, :-1]], dim=1), dim=1)
    above = torch.cumprod(torch.cat([ones, f.flip(1)[:, :-1]], dim=1),
                          dim=1).flip(1)
    # e0 as the forward holds it: float32 (torch.full's default dtype).
    e0_f32 = float(torch.tensor(e0, dtype=torch.float32))
    scale = (g[dep] * chord[dep, None]) * e0_f32
    x = -(scale[:, None, :] * below) * above
    return grad.index_add_(0, ti[counted], x[counted])


def replay_bwd(tri_ids, recv_step, chord, g, absorb, e0: float):
    """The gradient of :func:`replay`'s ``ev_w`` with respect to ``absorb``
    [T, n_bands], given ``g`` [N, n_bands] and the forward's ``chord``:
    one launch of ``ar2_replay_bwd`` for CUDA tensors (contiguous float32),
    :func:`replay_bwd_plain` for CPU tensors."""
    global bwd_launches
    dev = tri_ids.device
    if tuple(g.shape) != (tri_ids.shape[0], absorb.shape[1]) \
            or tuple(chord.shape) != tri_ids.shape[:1]:
        raise ValueError(f"replay_bwd needs g [N, n_bands] and chord [N] "
                         f"for {tuple(tri_ids.shape)} paths and a table "
                         f"{tuple(absorb.shape)}, got {tuple(g.shape)} and "
                         f"{tuple(chord.shape)}")
    if dev.type == "cpu":
        return replay_bwd_plain(tri_ids, recv_step, chord, g, absorb, e0)
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    tensors = (recv_step, chord, g, absorb)
    if any(x.device != dev for x in tensors):
        raise ValueError(f"replay_bwd's inputs are on {dev} and "
                         f"{sorted({str(x.device) for x in tensors})}")
    if tri_ids.dtype != torch.int32 or recv_step.dtype != torch.int32 \
            or any(x.dtype != torch.float32 for x in tensors[1:]):
        raise TypeError(f"replay_bwd needs int32 paths and float32 chord, g "
                        f"and table, got "
                        f"{[str(x.dtype) for x in (tri_ids, *tensors)]}")
    g = g.contiguous()
    if not all(x.is_contiguous() for x in (tri_ids, *tensors)):
        raise ValueError("the replay kernel needs contiguous inputs")
    (n, k_steps), (n_tris, n_bands) = tri_ids.shape, absorb.shape
    grad = torch.empty((n_tris, n_bands), dtype=torch.float32, device=dev)
    err = _build.library().ar2_replay_bwd(
        tri_ids.data_ptr(), n, k_steps, recv_step.data_ptr(),
        chord.data_ptr(), g.data_ptr(), absorb.data_ptr(), n_tris, n_bands,
        e0, grad.data_ptr(), _build.stream(dev))
    bwd_launches += 1
    _build.check(err, "ar2_replay_bwd")
    return grad


class _Replay(torch.autograd.Function):
    """:func:`replay` forward, :func:`replay_bwd` backward: a gradient for
    the absorption table only."""

    @staticmethod
    def forward(ctx, absorb, tri_ids, recv_step, dirs, scal, plane_n,
                plane_d, normal, e0, bin_rate):
        ev_bin, ev_w, ev_ear, chord = replay(tri_ids, recv_step, dirs, scal,
                                             plane_n, plane_d, normal, absorb,
                                             e0, bin_rate)
        ctx.save_for_backward(tri_ids, recv_step, chord, absorb)
        ctx.e0 = e0
        ctx.mark_non_differentiable(ev_bin, ev_ear)
        return ev_bin, ev_w, ev_ear

    @staticmethod
    def backward(ctx, g_bin, g_w, g_ear):
        tri_ids, recv_step, chord, absorb = ctx.saved_tensors
        grad = None
        if g_w is not None and ctx.needs_input_grad[0]:
            grad = replay_bwd(tri_ids, recv_step, chord, g_w, absorb, ctx.e0)
        return (grad,) + (None,) * 9


def replay_absorption(absorb, tri_ids, recv_step, dirs, scal, plane_n,
                      plane_d, normal, e0: float, bin_rate: float):
    """The replay's events (ev_bin_f [N], ev_w [N, n_bands], ev_ear int32
    [N]) with a gradient for the absorption table ``absorb`` [T, n_bands]
    alone: the poses (``dirs``, ``scal``) and the triangle rows get none."""
    return _Replay.apply(absorb.contiguous(), tri_ids.contiguous(),
                         recv_step.contiguous(), dirs.contiguous(), scal,
                         plane_n.contiguous(), plane_d.contiguous(),
                         normal.contiguous(), e0, bin_rate)
