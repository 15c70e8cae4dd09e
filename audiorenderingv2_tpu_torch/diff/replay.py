"""Path-replay differentiation: gradients at full ray scale.

The counterpart of ``audiorenderingv2_tpu/diff/replay.py``. The autograd
backend of ``core/tracer.py`` differentiates a trace whose every bounce
searches all triangles: fine for a small fit, far too slow at a million rays
on a large scene. But which triangle a ray hits is a discrete fact with no
useful derivative; what absorption, pose and geometry gradients need flows
through the continuous quantities along a FIXED path: plane distances, the
products of (1 - absorption), the receiver-sphere crossing. So:

1. ``record_paths_kernels`` (or ``record_paths``, the plain search) runs the
   forward tracer once and keeps only the triangle bounced off at each step
   and the step at which the receiver was reached: int32 [N, K] and [N].
2. ``replay_events`` walks the recorded paths again: per bounce one gather
   and one plane intersection, no search. Out-of-place PyTorch ops that
   autograd differentiates where the receiver, the directions or a
   triangle row needs a gradient; one kernel pair (forward, and a backward
   into the absorption table) where only absorption can, and where the
   emitter can too, the pose variant of that pair, which carries each
   ray's forward-mode tangents against the emitter.
3. ``render_ir_replay`` bins the replayed events into the IR (soft or hard);
   any loss on it back-propagates through K3-bwd and the replay.

The topology is recorded again whenever the parameters have moved far enough
to change it (the caller's choice; ``diff/inverse.py`` does so every
``replay_refresh`` steps).

MAINTENANCE INVARIANT: the bounce physics (alive predicate, receiver before
surface, reflect / absorb / offset) exists in FOUR forms, as in the JAX
package: the autograd tracer's ``core/tracer.py:_bounce_step`` (full
search; ``record_paths`` runs that very step and keeps its topology, where
the JAX package writes the step out again), the replay's step (gather, no
search: ``ops/replay_cuda.py:chain_events``, and its kernel
``csrc/replay.cu:advance``, whose plain version is that chain), and the
trace kernels' tail (``csrc/trace_common.cuh:finish_bounce`` with its plain
version ``ops/raytrace_cuda.py:_bounce``). The replay's step also carries
the emitter's tangents, the derivative of that physics: the ray line
mirrored at each plane and the receiver's entry (``chain_events
(tangents=True)``'s ``_surface_tangent`` and ``_entry_tangent``, the
kernel's ``surface_tangent`` and ``entry_tangent``), so a change to the
reflection or the receiver's entry lands in those as well. A change to the
physics lands in all four; the equality tests of
``tests/test_torch_replay.py`` and ``tests/test_torch_fit_pose.py`` are the
tripwire.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core.params import TraceParams
from ..core.tracer import (SceneArrays, TracerOptions, _as_vec, _bounce_step,
                           _histogram_from_events, _start_state,
                           band_absorption, pack_for_route, trace_route)
from ..ops import replay_cuda
from ..utils import profiling


@torch.no_grad()
def record_paths(sc: SceneArrays, dirs: torch.Tensor, emitter, rec_center,
                 receiver_yaw_deg, params: TraceParams,
                 opts: TracerOptions = TracerOptions(),
                 n_total_rays: int | None = None):
    """Trace once by the plain search, recording topology only.

    Returns (tri_ids int32 [N, K], recv_step int32 [N]), K =
    ``params.max_bounces``: ``tri_ids[i, k]`` is the triangle ray i bounced
    off at step k (-1: it did not advance at step k), ``recv_step[i]`` the
    step at which it entered the receiver sphere (-1: never). No gradients;
    blocks of ``opts.block_size`` rays as in the autograd tracer.

    ``n_total_rays``: the whole launch's ray count when this call records a
    share of it; it sets the per-ray energy, so that the energy threshold
    ends the same rays as in a trace of the whole launch.
    """
    dev = sc.device
    n = dirs.shape[0]
    dirs = dirs.to(device=dev, dtype=torch.float32)
    emitter, rec_center = _as_vec(emitter, dev), _as_vec(rec_center, dev)
    yaw_rad = torch.deg2rad(_as_vec(receiver_yaw_deg, dev))
    e0 = params.base_power / ((n_total_rays if n_total_rays is not None
                               else n) * constants.SPHERE_VOLUME)
    ids = torch.full((n, params.max_bounces), -1, dtype=torch.int32,
                     device=dev)
    recv = torch.full((n,), -1, dtype=torch.int32, device=dev)
    block = max(1, min(opts.block_size, n))
    for start in range(0, n, block):
        rays = slice(start, start + block)
        state = _start_state(dirs[rays],
                             torch.full((dirs[rays].shape[0],), e0,
                                        device=dev),
                             emitter, params.n_bands)
        for k in range(params.max_bounces):
            state, (surface, receiver, tri) = _bounce_step(
                state, sc, rec_center, yaw_rad, params, opts)
            recv[rays] = torch.where(receiver, k, recv[rays])
            ids[rays, k] = torch.where(surface, tri, -1).to(torch.int32)
    return ids, recv


@torch.no_grad()
def record_paths_kernels(sc: SceneArrays, dirs: torch.Tensor, emitter,
                         rec_center, receiver_yaw_deg, params: TraceParams,
                         opts: TracerOptions = TracerOptions(),
                         n_total_rays: int | None = None,
                         rows: torch.Tensor | None = None,
                         boxes: torch.Tensor | None = None):
    """:func:`record_paths` through the trace kernels: the fast recorder,
    the counterpart of the JAX package's ``record_paths_pallas``.

    One bounce a round on the recorder's route of
    ``core.tracer.trace_route``, through ``raytrace_cuda.trace_state``. The
    ray state carries three recording columns: RAYID, the launch index (so
    the topology survives the reorder between rounds), LTRI, 1 + the
    triangle bounced off in the current round, and RECVD, the depth at
    which the receiver was entered. After each round the harvest reads
    (RAYID, LTRI) and scatters the triangle ids into launch order, and
    after the last one RECVD. ``rows``, ``boxes``: the packed scene, as in
    ``core.tracer.trace_ir``.

    Returns the same (tri_ids int32 [N, K], recv_step int32 [N]) as
    :func:`record_paths`. Ids index the scene's own (sorted) triangles. The
    two recorders run the same arithmetic and agree wherever no two
    triangles tie for the nearest hit; on a tie K5 keeps the cluster visited
    first, the search and K2 the lowest index, which leaves the path's
    geometry the same (equal distance) and can differ in the normal only
    on an edge shared by two faces.
    """
    from ..ops import raytrace_cuda as rc

    dev = sc.device
    n, k_steps = dirs.shape[0], params.max_bounces
    n_pad = -(-n // rc._LANES) * rc._LANES
    if n_pad > 2 ** 24:
        raise ValueError(f"{n_pad} rays: the launch index rides in an f32 "
                         f"state column, exact only up to 2^24; record in "
                         f"chunks with n_total_rays")
    route = trace_route(opts, params.n_bands, sc.cluster_boxes is not None,
                        "record")
    rows, boxes = pack_for_route(sc, params, rows, boxes, route)
    tri_ids = torch.empty((n_pad, k_steps), dtype=torch.int32, device=dev)
    recv = torch.empty((n_pad,), dtype=torch.int32, device=dev)

    def harvest(k: int, st: torch.Tensor) -> None:
        ids = st[rc._C_RAYID].long()
        tri_ids[ids, k] = st[rc._C_LTRI].to(torch.int32) - 1
        if k + 1 == k_steps:  # the last round's state is the final one
            recv[ids] = st[rc._C_RECVD].to(torch.int32)

    rc.trace_state(rows, dirs.to(device=dev, dtype=torch.float32),
                   _as_vec(emitter, dev), _as_vec(rec_center, dev),
                   float(receiver_yaw_deg), params, route=route, boxes=boxes,
                   n_total_rays=n_total_rays, round_budgets=(1,) * k_steps,
                   harvest=harvest, record=True)
    return tri_ids[:n], recv[:n]


def _needs_grad(x) -> bool:
    return isinstance(x, torch.Tensor) and x.requires_grad


def replay_events(sc: SceneArrays, tri_ids: torch.Tensor,
                  recv_step: torch.Tensor, dirs: torch.Tensor, emitter,
                  rec_center, receiver_yaw_deg, params: TraceParams,
                  n_total_rays: int | None = None):
    """Walk recorded paths again, differentiably; returns the event slots
    (ev_bin_f [N], ev_w [N, n_bands], ev_ear int32 [N]) as the tracers do.

    Three paths, chosen from what the inputs require. Where the receiver
    (centre or yaw), the directions or a triangle row (``plane_n``,
    ``plane_d``, ``normal``) requires a gradient, the eager chain
    (``ops/replay_cuda.chain_events``, span ``ar2.replay.chain``): per
    step one gather of the known triangle's rows and one plane
    intersection, no search, O(N * K) out-of-place ops that autograd
    differentiates in every input. Otherwise the replay is one kernel pair
    under the span ``ar2.replay.kernel``: where the emitter requires a
    gradient, the pose pair (``ops/replay_cuda.replay_pose_pair``), whose
    forward carries each ray's tangents against the emitter in registers
    and gives ``ev_bin`` a gradient, and whose backward reduces the
    emitter's gradient beside the table's; else the absorption pair
    (``ops/replay_cuda.replay_absorption``). The same events every way.
    The energy threshold ends no path here: the recorded topology is the
    forward run that is being linearised.
    """
    dev = sc.device
    n, k_steps = tri_ids.shape
    n_total = n_total_rays if n_total_rays is not None else n
    e0 = params.base_power / (n_total * constants.SPHERE_VOLUME)
    bin_rate = params.sample_rate / constants.SPEED_OF_SOUND
    fixed = not any(map(_needs_grad, (dirs, rec_center, receiver_yaw_deg,
                                      sc.plane_n, sc.plane_d, sc.normal)))
    with profiling.span("ar2.replay.kernel" if fixed else
                        "ar2.replay.chain"):
        emitter, rec_center = _as_vec(emitter, dev), _as_vec(rec_center, dev)
        yaw_rad = torch.deg2rad(_as_vec(receiver_yaw_deg, dev))
        sin_y, cos_y = torch.sin(yaw_rad), torch.cos(yaw_rad)
        dirn = dirs.to(device=dev, dtype=torch.float32)
        absorb = band_absorption(sc, params.n_bands)
        if fixed and emitter.requires_grad:
            receiver = torch.cat([rec_center, sin_y[None], cos_y[None]])
            return replay_cuda.replay_pose_pair(
                absorb, emitter, tri_ids, recv_step, dirn, receiver,
                sc.plane_n, sc.plane_d, sc.normal, e0, bin_rate)
        if fixed:
            scal = torch.cat([emitter, rec_center, sin_y[None], cos_y[None]])
            return replay_cuda.replay_absorption(
                absorb, tri_ids, recv_step, dirn, scal, sc.plane_n,
                sc.plane_d, sc.normal, e0, bin_rate)
        return replay_cuda.chain_events(
            sc.plane_n, sc.plane_d, sc.normal, absorb, tri_ids, recv_step,
            dirn, emitter, rec_center, sin_y, cos_y, e0, bin_rate)[:3]


def render_ir_replay(sc: SceneArrays, tri_ids, recv_step, dirs, emitter,
                     rec_center, receiver_yaw_deg, params: TraceParams,
                     soft_binning: bool = True,
                     n_total_rays: int | None = None) -> torch.Tensor:
    """The replayed, differentiable IR: [2, ir_length], or [2, n_bands,
    ir_length]. ``soft_binning`` (the default) gives the arrival time a
    gradient, which is the point of replaying a pose; hard binning
    reproduces the forward tracer's IR."""
    ev = replay_events(sc, tri_ids, recv_step, dirs, emitter, rec_center,
                       receiver_yaw_deg, params, n_total_rays)
    return _histogram_from_events(*ev, params, soft_binning)
