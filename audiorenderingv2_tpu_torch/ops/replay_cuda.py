"""The replay of recorded paths (``diff/replay.py``): the eager chain, and
the kernel pairs of an absorption gradient and of an emitter gradient.

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

Where the emitter requires a gradient as well (and the receiver, the
directions and the rows still do not), the pose pair, the same two entry
points given a ``tan`` buffer (the kernels' pose templates), walks the same
paths carrying forward-mode tangents against the emitter: the 3 x 3
displacement of each ray's line across its direction, mirrored at each
plane hit (:func:`_surface_tangent`) and closed at the receiver's entry
(:func:`_entry_tangent`) into ``tan`` [N, 6], ``d ev_bin / d e`` and
``d chord / d e``; its backward adds the emitter's gradient [3] to the
table's.

``replay`` and ``replay_bwd`` (with ``pose``, the pose pair) launch the
kernels for CUDA tensors and run the plain versions, ``replay_plain``
(``chain_events`` over the depositing rays and the steps up to the last
deposit; with ``tangents=True`` the chain carries the tangents) and
``replay_bwd_plain`` (the products before and after each step by
``cumprod``, one ``index_add_``; with ``pose`` the emitter's sum over the
deposits), for CPU tensors. They never fall back from one to the other.
``replay_absorption`` and ``replay_pose_pair`` join each pair in one
``torch.autograd.Function``. ``launches`` and ``bwd_launches`` count the
absorption pair's kernel launches, ``pose_launches`` and
``pose_bwd_launches`` the pose pair's.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core.tracer import _dot3, _rows, _sphere_entry
from . import _build

# Kernel launches since import (or since a caller reset it to 0).
launches = 0
bwd_launches = 0
pose_launches = 0
pose_bwd_launches = 0


def _surface_tangent(perp, nrm):
    """The tangents after a plane hit: ``perp`` [N, 3, 3], the ray line's
    displacement across its direction per unit move of the emitter, is
    mirrored by the plane (unit normals ``nrm`` [N, 3]), as the line is.
    (The hit point also slides along the line, by ``pn^T perp / (pn .
    dirn)``, but a slide along a line leaves the line and the arrival
    where they are, so the tangents need not carry it.)"""
    q = (nrm[:, 0, None] * perp[:, 0, :] + nrm[:, 1, None] * perp[:, 1, :]) \
        + nrm[:, 2, None] * perp[:, 2, :]
    return perp - nrm[:, :, None] * (2.0 * q)[:, None, :]


def _entry_tangent(perp, dir0, pos, dirn, center, bin_rate: float):
    """The tangents of the receiver sphere's entry, [N, 6]: d ev_bin / d e
    and d chord / d e. An emitter move along the first direction ``dir0``
    shortens every path by as much; across it, it displaces the line by
    ``perp``. With oc = pos - center, b = oc . dirn and s = sqrt(b^2 -
    (oc . oc - r^2)), a displacement x across the line moves the entry
    t1 = -b - s by (oc . x) / s and t2 = -b + s by -(oc . x) / s, and the
    chord 2 s by -2 (oc . x) / s. The tangents scale as 1 / s, and near a
    grazing entry that difference of squares of the distance (some 100 m^2
    against an s^2 of 1e-4) keeps few of float32's digits: here s comes
    from the same formula in float64 over the float32 position and
    direction, and is rounded to float32 once. Rays that miss the sphere
    get what the division gives; the caller keeps only the deposits."""
    oc = pos - center[None, :]
    b = _dot3(oc, dirn)
    c = _dot3(oc, oc) - constants.RECEIVER_RADIUS ** 2
    disc = b * b - c
    s = torch.sqrt(torch.where(disc > 0.0, disc, 0.0))
    first = (disc > 0.0) & (-b - s > constants.T_MIN)
    oc_d = pos.double() - center.double()[None, :]
    b_d = _dot3(oc_d, dirn.double())
    disc_d = b_d * b_d - (_dot3(oc_d, oc_d) - constants.RECEIVER_RADIUS ** 2)
    s_d = torch.sqrt(torch.clamp(disc_d, min=0.0)).to(s.dtype)
    s_d = torch.where(s_d > 0.0, s_d, s)
    w = (oc[:, 0, None] * perp[:, 0, :] + oc[:, 1, None] * perp[:, 1, :]) \
        + oc[:, 2, None] * perp[:, 2, :]
    ws = w / s_d[:, None]
    dt = torch.where(first[:, None], ws, -ws)
    return torch.cat([(-dir0 + dt) * bin_rate, -(ws + ws)], dim=1)


def chain_events(plane_n, plane_d, normal, absorb, tri_ids, recv_step, dirn,
                 emitter, rec_center, sin_y, cos_y, e0: float,
                 bin_rate: float, tangents: bool = False):
    """The replay's steps as eager PyTorch ops over all rays and all of
    ``tri_ids``' K steps; returns (ev_bin_f [N], ev_w [N, n_bands], ev_ear
    int32 [N], chord [N]), chord 0 where a ray deposits nothing, and with
    ``tangents`` also tan [N, 6], each deposit's d ev_bin / d e and
    d chord / d e against the emitter (0 where it deposits nothing).

    Per step: one gather of the known triangle's plane, normal and
    absorption and one plane intersection, no search. Every step is out of
    place, so autograd differentiates it in every input. The tangents are
    forward-mode, carried beside the same steps (``_surface_tangent``,
    ``_entry_tangent``) as the ray line's displacement across its direction,
    which each plane mirrors, so that no hit's slide along the line enters
    them: the pose kernel's plain version."""
    n = tri_ids.shape[0]
    dev = dirn.device
    pos = emitter[None, :].expand(n, 3)
    dist = torch.zeros(n, device=dev)
    energy = torch.full((n, absorb.shape[1]), e0, device=dev)
    ev_bin = torch.zeros(n, device=dev)
    ev_w = torch.zeros((n, absorb.shape[1]), device=dev)
    ev_ear = torch.zeros(n, dtype=torch.int32, device=dev)
    ev_chord = torch.zeros(n, device=dev)
    if tangents:
        # The line's displacement across the first direction per unit move
        # of the emitter: I - dir0 dir0^T.
        dir0 = dirn
        perp = torch.eye(3, dtype=pos.dtype, device=dev) \
            - dir0[:, :, None] * dir0[:, None, :]
        ev_tan = torch.zeros((n, 6), dtype=pos.dtype, device=dev)
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
        if tangents:
            ev_tan = torch.where(ok[:, None], _entry_tangent(
                perp, dir0, pos, dirn, rec_center, bin_rate), ev_tan)

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
        if tangents:
            perp = torch.where(sm[:, :, None], _surface_tangent(perp, nrm),
                               perp)
        pos = torch.where(sm, hit_p + constants.BOUNCE_EPSILON * refl, pos)
        dirn = torch.where(sm, refl, dirn)
        dist = torch.where(surface, dist + t, dist)
        energy = torch.where(sm, energy * (1.0 - _rows(absorb, ti)), energy)
    # recv_step is always below K: a ray at depth max_bounces may not
    # continue and deposits nothing, so the loop covers every deposit.
    if tangents:
        return ev_bin, ev_w, ev_ear, ev_chord, ev_tan
    return ev_bin, ev_w, ev_ear, ev_chord


@torch.no_grad()
def replay_plain(tri_ids, recv_step, dirs, scal, plane_n, plane_d, normal,
                 absorb, e0: float, bin_rate: float, tangents: bool = False):
    """Plain PyTorch version of ``ar2_replay`` (with ``tangents``, of its pose
    kernel): :func:`chain_events` over the rays that deposit
    and the steps up to the last deposit, the others' slots left at 0
    (each element's arithmetic is the chain's, so the events are the
    chain's bit for bit). Returns (ev_bin_f, ev_w, ev_ear, chord), and
    with ``tangents`` also tan [N, 6]."""
    n, k_all = tri_ids.shape
    dep = torch.nonzero((recv_step >= 0) & (recv_step < k_all)).squeeze(1)
    k = int(recv_step[dep].max()) + 1 if dep.numel() else 1
    sub = chain_events(plane_n, plane_d, normal, absorb, tri_ids[dep, :k],
                       recv_step[dep], dirs[dep], scal[0:3], scal[3:6],
                       scal[6], scal[7], e0, bin_rate, tangents=tangents)
    out = []
    for x in sub:
        full = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        full[dep] = x
        out.append(full)
    return tuple(out)


def _check_replay(what: str, tri_ids, recv_step, dirs, scal, plane_n,
                  plane_d, normal, absorb) -> None:
    """The forward wrappers' checks of shapes, types and devices; the
    dtypes and layout only for a CUDA launch."""
    dev = tri_ids.device
    if tri_ids.dtype != torch.int32 or recv_step.dtype != torch.int32:
        raise TypeError(f"{what} needs int32 tri_ids and recv_step, got "
                        f"{tri_ids.dtype} and {recv_step.dtype}")
    if tri_ids.dim() != 2 or tuple(recv_step.shape) != tri_ids.shape[:1] \
            or tuple(dirs.shape) != (tri_ids.shape[0], 3) \
            or tuple(scal.shape) != (8,) or absorb.dim() != 2:
        raise ValueError(f"{what} needs tri_ids [N, K], recv_step [N], dirs "
                         f"[N, 3], scal [8] and absorb [T, n_bands], got "
                         f"{tuple(tri_ids.shape)}, {tuple(recv_step.shape)}, "
                         f"{tuple(dirs.shape)}, {tuple(scal.shape)}, "
                         f"{tuple(absorb.shape)}")
    n_tris = absorb.shape[0]
    if tuple(plane_n.shape) != (n_tris, 3) or tuple(normal.shape) != (
            n_tris, 3) or tuple(plane_d.shape) != (n_tris,):
        raise ValueError(f"{what} needs triangle rows of {n_tris} "
                         f"triangles, got {tuple(plane_n.shape)}, "
                         f"{tuple(plane_d.shape)}, {tuple(normal.shape)}")
    tensors = (recv_step, dirs, scal, plane_n, plane_d, normal, absorb)
    if any(x.device != dev for x in tensors):
        raise ValueError(f"{what}'s inputs are on {dev} and "
                         f"{sorted({str(x.device) for x in tensors})}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    if any(x.dtype != torch.float32 for x in tensors[1:]):
        raise TypeError(f"the replay kernel needs float32 rows, got "
                        f"{[str(x.dtype) for x in tensors[1:]]}")
    if not all(x.is_contiguous() for x in (tri_ids, *tensors)):
        raise ValueError("the replay kernel needs contiguous inputs")
    if not 1 <= absorb.shape[1] <= 8:
        raise ValueError(f"the replay kernel takes 1 to 8 bands, got "
                         f"{absorb.shape[1]}")


def replay(tri_ids, recv_step, dirs, scal, plane_n, plane_d, normal, absorb,
           e0: float, bin_rate: float, pose: bool = False):
    """The events of recorded paths with fixed poses and geometry: int32
    ``tri_ids`` [N, K] and ``recv_step`` [N], ``dirs`` [N, 3], ``scal`` [8]
    (emitter, receiver centre, sin and cos of the yaw), the triangle rows
    ``plane_n`` [T, 3], ``plane_d`` [T], ``normal`` [T, 3] and ``absorb``
    [T, n_bands]. Returns (ev_bin_f [N], ev_w [N, n_bands], ev_ear int32
    [N], chord [N]) on the input's device, and with ``pose`` also tan [N,
    6], each deposit's d ev_bin / d e and d chord / d e against the emitter
    (0 where a ray deposits nothing): one launch of ``ar2_replay`` (its
    pose kernel with ``pose``) for CUDA tensors (contiguous float32, 1 to 8
    bands), :func:`replay_plain` for CPU tensors."""
    global launches, pose_launches
    _check_replay("replay", tri_ids, recv_step, dirs, scal, plane_n, plane_d,
                  normal, absorb)
    if tri_ids.device.type == "cpu":
        return replay_plain(tri_ids, recv_step, dirs, scal, plane_n, plane_d,
                            normal, absorb, e0, bin_rate, tangents=pose)
    dev = tri_ids.device
    (n, k_steps), (n_tris, n_bands) = tri_ids.shape, absorb.shape
    ev_bin = torch.empty((n,), dtype=torch.float32, device=dev)
    ev_w = torch.empty((n, n_bands), dtype=torch.float32, device=dev)
    ev_ear = torch.empty((n,), dtype=torch.int32, device=dev)
    chord = torch.empty((n,), dtype=torch.float32, device=dev)
    tan = (torch.empty((n, 6), dtype=torch.float32, device=dev) if pose
           else None)
    err = _build.library().ar2_replay(
        tri_ids.data_ptr(), n, k_steps, recv_step.data_ptr(),
        dirs.data_ptr(), scal.data_ptr(), plane_n.data_ptr(),
        plane_d.data_ptr(), normal.data_ptr(), absorb.data_ptr(), n_tris,
        n_bands, e0, bin_rate, constants.BOUNCE_EPSILON, constants.T_MIN,
        constants.RECEIVER_RADIUS ** 2, ev_bin.data_ptr(), ev_w.data_ptr(),
        ev_ear.data_ptr(), chord.data_ptr(),
        tan.data_ptr() if pose else None, _build.stream(dev))
    if pose:
        pose_launches += 1
    else:
        launches += 1
    _build.check(err, "ar2_replay")
    return (ev_bin, ev_w, ev_ear, chord) + ((tan,) if pose else ())


def replay_bwd_plain(tri_ids, recv_step, chord, g, absorb, e0: float,
                     pose=None, table: bool = True):
    """Plain PyTorch version of ``ar2_replay_bwd``: the gradient [T,
    n_bands] of the table ``absorb`` given ``g`` = d loss / d ev_w [N,
    n_bands]; visit k of a depositing ray adds ``-(g * chord * e0) *
    prod_{j < k} (1 - a_j) * prod_{j > k} (1 - a_j)`` at its triangle, the
    products over the steps before the deposit that left a surface.

    With ``pose`` = (g_bin [N] = d loss / d ev_bin, the forward's ev_w and
    tan), (that gradient, or None without ``table``; the emitter's [3]): a
    deposit adds ``g_bin * d ev_bin / d e + (sum_b g ev_w) / chord *
    d chord / d e``, its weight being its energy, which does not depend on
    the emitter, times its chord."""
    grad = None
    if table or pose is None:
        grad = torch.zeros(absorb.shape, dtype=absorb.dtype,
                           device=absorb.device)
        dep = torch.nonzero((recv_step > 0) & (recv_step < tri_ids.shape[1])
                            & (chord != 0)).squeeze(1)
        if dep.numel():
            rs = recv_step[dep]
            k = int(rs.max())
            ids = tri_ids[dep, :k].long()
            counted = (ids >= 0) & (torch.arange(k, device=ids.device)
                                    < rs[:, None])
            ti = torch.where(counted, ids, 0)
            f = torch.where(counted[..., None], 1.0 - absorb[ti], 1.0)
            ones = torch.ones_like(f[:, :1])
            below = torch.cumprod(torch.cat([ones, f[:, :-1]], dim=1), dim=1)
            above = torch.cumprod(torch.cat([ones, f.flip(1)[:, :-1]], dim=1),
                                  dim=1).flip(1)
            # e0 as the forward holds it: float32 (torch.full's default).
            e0_f32 = float(torch.tensor(e0, dtype=torch.float32))
            scale = (g[dep] * chord[dep, None]) * e0_f32
            x = -(scale[:, None, :] * below) * above
            grad.index_add_(0, ti[counted], x[counted])
    if pose is None:
        return grad
    g_bin, ev_w, tan = pose
    dep = (recv_step >= 0) & (recv_step < tri_ids.shape[1]) & (chord != 0)
    energy = (g[dep] * ev_w[dep]).sum(dim=1) / chord[dep]
    t = tan[dep]
    grad_e = (g_bin[dep, None] * t[:, :3] + energy[:, None] * t[:, 3:]).sum(0)
    return grad, grad_e


def replay_bwd(tri_ids, recv_step, chord, g, absorb, e0: float, pose=None,
               table: bool = True):
    """The gradient of :func:`replay`'s ``ev_w`` with respect to ``absorb``
    [T, n_bands], given ``g`` [N, n_bands] and the forward's ``chord``;
    with ``pose`` = (``g_bin`` [N], the forward's ``ev_w`` and ``tan``)
    the gradients of its ``ev_bin`` and ``ev_w`` with respect to the table
    (None without ``table``) and the emitter [3]: one launch of
    ``ar2_replay_bwd`` for CUDA tensors (contiguous float32),
    :func:`replay_bwd_plain` for CPU tensors."""
    global bwd_launches, pose_bwd_launches
    dev = tri_ids.device
    n = tri_ids.shape[0]
    extra = tuple(pose) if pose is not None else ()
    if tuple(g.shape) != (n, absorb.shape[1]) \
            or tuple(chord.shape) != (n,) \
            or (pose is not None and (tuple(extra[0].shape) != (n,)
                                      or extra[1].shape != g.shape
                                      or tuple(extra[2].shape) != (n, 6))):
        raise ValueError(f"replay_bwd needs g [N, n_bands] and chord [N] "
                         f"(and with pose g_bin [N], ev_w [N, n_bands] and "
                         f"tan [N, 6]) for {tuple(tri_ids.shape)} paths and "
                         f"a table {tuple(absorb.shape)}, got "
                         f"{[tuple(x.shape) for x in (g, chord, *extra)]}")
    if dev.type == "cpu":
        return replay_bwd_plain(tri_ids, recv_step, chord, g, absorb, e0,
                                pose, table)
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    tensors = (recv_step, chord, g, absorb) + extra
    if any(x.device != dev for x in tensors):
        raise ValueError(f"replay_bwd's inputs are on {dev} and "
                         f"{sorted({str(x.device) for x in tensors})}")
    if tri_ids.dtype != torch.int32 or recv_step.dtype != torch.int32 \
            or any(x.dtype != torch.float32 for x in tensors[1:]):
        raise TypeError(f"replay_bwd needs int32 paths and float32 "
                        f"gradients, events and table, got "
                        f"{[str(x.dtype) for x in (tri_ids, *tensors)]}")
    g = g.contiguous()
    if pose is not None:
        extra = (extra[0].contiguous(), *extra[1:])
    if not all(x.is_contiguous() for x in (tri_ids, recv_step, chord, absorb,
                                           *extra)):
        raise ValueError("the replay kernel needs contiguous inputs")
    k_steps, (n_tris, n_bands) = tri_ids.shape[1], absorb.shape
    table = table or pose is None
    grad = (torch.empty((n_tris, n_bands), dtype=torch.float32, device=dev)
            if table else None)
    g_bin, ev_w, tan = (x.data_ptr() for x in extra) if extra \
        else (None, None, None)
    grad_e = (torch.empty((3,), dtype=torch.float32, device=dev)
              if pose is not None else None)
    err = _build.library().ar2_replay_bwd(
        tri_ids.data_ptr(), n, k_steps, recv_step.data_ptr(),
        chord.data_ptr(), g.data_ptr(), absorb.data_ptr(), n_tris, n_bands,
        e0, grad.data_ptr() if table else None, g_bin, ev_w, tan,
        grad_e.data_ptr() if pose is not None else None, _build.stream(dev))
    if pose is None:
        bwd_launches += 1
    else:
        pose_bwd_launches += 1
    _build.check(err, "ar2_replay_bwd")
    return grad if pose is None else (grad, grad_e)


class _Replay(torch.autograd.Function):
    """:func:`replay` forward, :func:`replay_bwd` backward: a gradient for
    the absorption table, and given an ``emitter`` [3] (``scal`` then the
    receiver's [5]) the pose kernels', whose ``ev_bin`` carries the
    emitter's gradient as well."""

    @staticmethod
    def forward(ctx, absorb, emitter, tri_ids, recv_step, dirs, scal,
                plane_n, plane_d, normal, e0, bin_rate):
        pose = emitter is not None
        if pose:
            scal = torch.cat([emitter, scal])
        ev_bin, ev_w, ev_ear, chord, *tan = replay(
            tri_ids, recv_step, dirs, scal, plane_n, plane_d, normal, absorb,
            e0, bin_rate, pose=pose)
        ctx.save_for_backward(tri_ids, recv_step, chord, absorb,
                              *((ev_w, *tan) if pose else ()))
        ctx.e0 = e0
        ctx.mark_non_differentiable(*((ev_ear,) if pose else (ev_bin, ev_ear)))
        return ev_bin, ev_w, ev_ear

    @staticmethod
    def backward(ctx, g_bin, g_w, g_ear):
        tri_ids, recv_step, chord, absorb, *pose = ctx.saved_tensors
        table = ctx.needs_input_grad[0]
        if not pose:
            grad = None
            if g_w is not None and table:
                grad = replay_bwd(tri_ids, recv_step, chord, g_w, absorb,
                                  ctx.e0)
            return (grad,) + (None,) * 10
        ev_w, tan = pose
        if g_bin is None:
            g_bin = torch.zeros_like(chord)
        if g_w is None:
            g_w = torch.zeros_like(ev_w)
        grad, grad_e = replay_bwd(tri_ids, recv_step, chord, g_w, absorb,
                                  ctx.e0, pose=(g_bin, ev_w, tan),
                                  table=table)
        return (grad, grad_e if ctx.needs_input_grad[1] else None) \
            + (None,) * 9


def replay_absorption(absorb, tri_ids, recv_step, dirs, scal, plane_n,
                      plane_d, normal, e0: float, bin_rate: float):
    """The replay's events (ev_bin_f [N], ev_w [N, n_bands], ev_ear int32
    [N]) with a gradient for the absorption table ``absorb`` [T, n_bands]
    alone: the poses (``dirs``, ``scal``) and the triangle rows get none."""
    return _Replay.apply(absorb.contiguous(), None, tri_ids.contiguous(),
                         recv_step.contiguous(), dirs.contiguous(), scal,
                         plane_n.contiguous(), plane_d.contiguous(),
                         normal.contiguous(), e0, bin_rate)


def replay_pose_pair(absorb, emitter, tri_ids, recv_step, dirs, receiver,
                     plane_n, plane_d, normal, e0: float, bin_rate: float):
    """The replay's events (ev_bin_f [N], ev_w [N, n_bands], ev_ear int32
    [N]) with gradients for the absorption table ``absorb`` [T, n_bands]
    and the emitter [3]; ``receiver`` [5] is the receiver centre and the
    sin and cos of its yaw. The directions, the receiver and the triangle
    rows get none."""
    return _Replay.apply(absorb.contiguous(), emitter, tri_ids.contiguous(),
                         recv_step.contiguous(), dirs.contiguous(), receiver,
                         plane_n.contiguous(), plane_d.contiguous(),
                         normal.contiguous(), e0, bin_rate)
