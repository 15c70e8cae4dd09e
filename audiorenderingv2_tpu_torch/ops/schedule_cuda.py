"""The clustered route's kernels: the per-tile schedule and K2.

A tile is 128 consecutive rays of the state's ray order (the grouping of the
JAX package's ``to_tiles``). Each round of the clustered route runs:

* ``tile_schedule``: for every tile, the clusters that some ray of the tile
  that is not done can reach, by an exact slab test of each ray against each
  cluster box. The counterpart of
  ``audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:tile_schedule`` in exact
  mode, which is plain XLA there. Its kernel is ``csrc/tile_schedule.cu``
  (one block per tile; a warp tests a group of 32 boxes only where one of
  its rays reaches the group's union, which is exact).
  Rows are int32 [n_tiles, S], S = ceil((C + 1) / 8) * 8: slot 0 holds the
  count, then the reachable ids in ascending order, then zeros. (The JAX
  rows carry the unreachable ids after the count instead of zeros; nothing
  reads those slots.)
* ``trace_round_sched``: K2, one bounce of every ray over the candidate
  clusters of its tile, then K1's receiver test and bounce tail. Its kernel
  is ``csrc/trace_sched.cu``, which replaces the schedule branch of the TPU
  kernel ``raytrace_pallas_v2.py:_trace_round_kernel_v2`` (``use_sched``,
  launched by ``trace_round_v2``, :799): the candidate clusters' rows
  stream through a ring of shared-memory stages filled by bulk
  asynchronous copies, and the FP32 intersection bounds it. A warp of 32
  rays tests a candidate's rows only when one of its live rays reaches the
  candidate's box by the schedule's slab test, nearer than that ray's hit
  so far: the tile's list is the union of what its four warps reach, and
  a warp runs only its own part (``k2_search``). With ``scal``
  [P, 16] it is the posed form: tile ``i`` of a pose-major state reads the
  scalar row of pose ``i // tiles_per_pose``
  (``raytrace_pallas_v2.py:887-904``); the schedule is per tile and reads
  positions only, so it is the same for any number of poses.

Each wrapper checks its inputs, launches its kernel for a CUDA tensor and
runs the plain PyTorch version for a CPU tensor; it never falls back from
one to the other. ``tile_schedule_launches``,
``trace_round_sched_launches`` (one scalar row) and
``trace_round_sched_posed_launches`` (a row per pose) count kernel launches.
"""
from __future__ import annotations

import math

import torch

from ..core.params import TraceParams
from . import _build
from . import raytrace_cuda as rc

# Kernel launches since import (or since a caller reset them to 0).
tile_schedule_launches = 0
trace_round_sched_launches = 0
trace_round_sched_posed_launches = 0

_TILE = 128
_WARP = 32  # rays that share K2's per-warp cull of the tile's list
_EPS_DIR = 1e-20  # direction components closer to 0 count as +-1e-20


def schedule_width(n_clusters: int) -> int:
    """Slots per schedule row: the count and C ids, rounded up to 8."""
    return -(-(n_clusters + 1) // 8) * 8


def _contiguous_on(ref: torch.Tensor, **tensors) -> None:
    """Raise unless every tensor is contiguous and on ``ref``'s device."""
    for name, x in tensors.items():
        if x.device != ref.device:
            raise ValueError(f"{name} on {x.device}, state on {ref.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_aligned(**tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the kernels
    read boxes as float4 and copy a cluster's rows in one bulk copy."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_schedule_inputs(state: torch.Tensor,
                           boxes: torch.Tensor) -> None:
    if state.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise ValueError(f"state and boxes must be float32, got "
                         f"{state.dtype} and {boxes.dtype}")
    if state.dim() != 2 or state.shape[0] < 16 or state.shape[1] % _TILE:
        raise ValueError(f"state must be [ncols, N] with N a multiple of "
                         f"{_TILE}, got {tuple(state.shape)}")
    if boxes.dim() != 2 or boxes.shape[1] != 8 or boxes.shape[0] < 1:
        raise ValueError(f"boxes must be [C, 8], got {tuple(boxes.shape)}")
    _contiguous_on(state, state=state, boxes=boxes)


# ------------------------------------------------------ the schedule, plain

def slab_pass(st: torch.Tensor, boxes: torch.Tensor):
    """The exact slab test of every ray of ``st`` [ncols, k, 128] (k tiles)
    against every box [C, 8]: (entry f32 [k, C, 128], the distance at which
    the ray enters the box, floored at 0; ok bool [k, C, 128], the ray
    reaches a box whose valid flag is set). The rays' done flags are the
    caller's to apply."""
    lo = boxes[:, 0:3].T[:, None, :, None]                  # [3, 1, C, 1]
    hi = boxes[:, 3:6].T[:, None, :, None]
    box_ok = (boxes[:, 6] > 0.0)[None, :, None]             # [1, C, 1]
    p = st[rc._C_PX:rc._C_PZ + 1, :, None, :]               # [3, k, 1, 128]
    v = st[rc._C_VX:rc._C_VZ + 1, :, None, :]
    inv = 1.0 / torch.where(torch.abs(v) > _EPS_DIR, v,
                            torch.where(v >= 0, _EPS_DIR, -_EPS_DIR))
    t1 = (lo - p) * inv                                     # [3, k, C, 128]
    t2 = (hi - p) * inv
    tn = torch.minimum(t1, t2).amax(dim=0)                  # [k, C, 128]
    tf = torch.maximum(t1, t2).amin(dim=0)
    entry = torch.clamp(tn, min=0.0)
    return entry, (tf >= entry) & box_ok


def tile_schedule_plain(state: torch.Tensor, boxes: torch.Tensor,
                        chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the schedule, ``chunk`` tiles at a time so
    that the [3, chunk, C, 128] slab intermediates stay bounded (the JAX
    package maps over 64-tile chunks the same way)."""
    n_tiles = state.shape[1] // _TILE
    c = boxes.shape[0]
    dev = state.device
    out = torch.zeros((n_tiles, schedule_width(c)), dtype=torch.int32,
                      device=dev)
    ids = torch.arange(c, device=dev)
    for t0 in range(0, n_tiles, chunk):
        k = min(chunk, n_tiles - t0)
        st = state[:, t0 * _TILE:(t0 + k) * _TILE].reshape(-1, k, _TILE)
        ok = slab_pass(st, boxes)[1] & (st[rc._C_DONE][:, None, :] == 0.0)
        reach = ok.any(dim=2)                               # [k, C]
        # Reachable ids ascending, then C for the rest, which become 0.
        listed = torch.sort(torch.where(reach, ids, c), dim=1).values
        out[t0:t0 + k, 0] = reach.sum(dim=1).to(torch.int32)
        out[t0:t0 + k, 1:c + 1] = torch.where(listed < c, listed, 0).to(
            torch.int32)
    return out


def tile_schedule(state: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The schedule of ``state`` [ncols, N] against ``boxes`` [C, 8]:
    int32 [N / 128, S] on the state's device. A CUDA tensor goes to
    ``csrc/tile_schedule.cu``, a CPU tensor to :func:`tile_schedule_plain`.
    """
    global tile_schedule_launches
    _check_schedule_inputs(state, boxes)
    if state.device.type == "cpu":
        return tile_schedule_plain(state, boxes)
    if state.device.type != "cuda":
        raise ValueError(f"no schedule kernel for device {state.device}")
    _check_aligned(boxes=boxes)
    n_tiles = state.shape[1] // _TILE
    width = schedule_width(boxes.shape[0])
    out = torch.empty((n_tiles, width), dtype=torch.int32,
                      device=state.device)
    err = _build.library().ar2_tile_schedule(
        state.data_ptr(), state.shape[1], boxes.data_ptr(), boxes.shape[0],
        out.data_ptr(), width, _build.stream(state.device))
    tile_schedule_launches += 1
    _build.check(err, "ar2_tile_schedule")
    return out


# ------------------------------------------------------------- K2, plain

def _members(sched: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """bool [n_tiles, C]: cluster c is on tile i's list."""
    slot = torch.arange(sched.shape[1] - 1, device=sched.device)
    ids = torch.where(slot[None, :] < sched[:, :1], sched[:, 1:],
                      n_clusters).long()
    member = torch.zeros((sched.shape[0], n_clusters + 1), dtype=torch.bool,
                         device=sched.device)
    return member.scatter_(1, ids, True)[:, :n_clusters]


def k2_search(state: torch.Tensor, rows: torch.Tensor, boxes: torch.Tensor,
              sched: torch.Tensor, scal: torch.Tensor, params: TraceParams,
              rays_per_pose: int | None = None):
    """K2's search of one bounce, with its per-warp cull: for the rays not
    done (idx int64 [k], ascending), their nearest hits (t f32 [k], inf on
    a miss; row int64 [k]), and int32 [N / 32], the clusters whose rows
    each warp of 32 rays tested. Clusters are taken in ascending id order.
    A warp tests a cluster its tile lists when some ray of the warp that
    can take the bounce (not done, and within the distance, energy and
    depth limits of its scalar row) reaches the cluster's box, by the
    schedule's slab test, at an entry nearer than that ray's nearest hit
    so far; then every ray of the warp tests the cluster's rows, with a
    strict running minimum (ties to the lower row)."""
    dev = state.device
    n_clusters = boxes.shape[0]
    cs = rows.shape[0] // n_clusters
    tested = torch.zeros(state.shape[1] // _WARP, dtype=torch.int32,
                         device=dev)
    idx = torch.nonzero(state[rc._C_DONE] == 0.0).squeeze(1)
    best_t = torch.full((idx.numel(),), math.inf, dtype=torch.float32,
                        device=dev)
    best_i = torch.zeros((idx.numel(),), dtype=torch.int64, device=dev)
    if idx.numel() == 0:
        return idx, best_t, best_i, tested
    s = state[:, idx]
    alive = rc._can_continue(
        s, rc.pose_rows(scal, idx, rays_per_pose).movedim(-1, 0),
        rc.band_cols(params.n_bands)[0], params.max_bounces)
    ray = s[rc._C_PX:rc._C_VZ + 1]
    member = _members(sched, n_clusters)
    tile, warp = idx // _TILE, idx // _WARP
    for c in range(n_clusters):
        cand = torch.nonzero(member[tile, c]).squeeze(1)  # its tiles' rays
        if cand.numel() == 0:
            continue
        entry, ok = slab_pass(ray[:, None, cand], boxes[c:c + 1])
        votes = ok[0, 0] & alive[cand] & (entry[0, 0] < best_t[cand])
        visit = torch.zeros_like(tested, dtype=torch.bool)
        visit[warp[cand[votes]]] = True
        tested += visit
        sel = cand[visit[warp[cand]]]
        if sel.numel() == 0:
            continue
        t, i = rc._nearest_hit(*ray[:, sel], rows[c * cs:(c + 1) * cs])
        bt, bi = best_t[sel], best_i[sel]
        better = t < bt
        best_t[sel] = torch.where(better, t, bt)
        best_i[sel] = torch.where(better, i + c * cs, bi)
    return idx, best_t, best_i, tested


def trace_round_sched_plain(state: torch.Tensor, rows: torch.Tensor,
                            boxes: torch.Tensor, sched: torch.Tensor,
                            scal: torch.Tensor, params: TraceParams,
                            rays_per_pose: int | None = None,
                            visits: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of K2: one bounce of every ray that is not
    done, in place: :func:`k2_search`, then K1's receiver test and bounce
    tail. With ``scal`` [P, 16], ray ``i`` reads row
    ``i // rays_per_pose``. ``visits``, int32 [N / 128], has each tile's
    (warp, cluster) tests added to it."""
    en_cols, evw_cols = rc.band_cols(params.n_bands)
    idx, best_t, best_i, tested = k2_search(state, rows, boxes, sched, scal,
                                            params, rays_per_pose)
    if visits is not None:
        visits += tested.view(visits.shape[0], -1).sum(dim=1,
                                                        dtype=torch.int32)
    state[rc._C_LTRI] = 0.0
    if idx.numel() == 0:
        return state
    s = state[:, idx]
    rc._bounce(s, rows, rc.pose_rows(scal, idx, rays_per_pose), en_cols,
               evw_cols, params.max_bounces, best=(best_t, best_i))
    state[:, idx] = s
    return state


def _check_k2_inputs(state, rows, boxes, sched, scal, n_bands,
                     visits) -> None:
    rc._check_round(state, rows, scal, n_bands, 1)
    _check_schedule_inputs(state, boxes)
    n_clusters = boxes.shape[0]
    cs = rows.shape[0] // n_clusters
    if cs * n_clusters != rows.shape[0] or cs % rc._TRI_BLOCK:
        raise ValueError(f"{rows.shape[0]} rows over {n_clusters} clusters "
                         f"need a cluster size that is a multiple of "
                         f"{rc._TRI_BLOCK}")
    want = (state.shape[1] // _TILE, schedule_width(n_clusters))
    if sched.dtype != torch.int32 or tuple(sched.shape) != want:
        raise ValueError(f"sched must be int32 {list(want)}, got "
                         f"{sched.dtype} {list(sched.shape)}")
    _contiguous_on(state, sched=sched)
    if visits is not None:
        if visits.dtype != torch.int32 or tuple(visits.shape) != want[:1]:
            raise ValueError(f"visits must be int32 [{want[0]}], got "
                             f"{visits.dtype} {list(visits.shape)}")
        _contiguous_on(state, visits=visits)


def trace_round_sched(state: torch.Tensor, rows: torch.Tensor,
                      boxes: torch.Tensor, sched: torch.Tensor,
                      scal: torch.Tensor, params: TraceParams,
                      rays_per_pose: int | None = None,
                      visits: torch.Tensor | None = None) -> torch.Tensor:
    """K2: one bounce of ``state`` [ncols, N] over each tile's candidate
    clusters (``sched`` from :func:`tile_schedule`; ``rows``, ``boxes``
    from ``raytrace_cuda.pack_tris_clusters``), in place; returns
    ``state``. ``scal`` is one scalar row [16], or [P, 16] for a pose-major
    state of P poses with ``rays_per_pose`` rays each. ``visits``, int32
    [N / 128], has each tile's (warp, candidate) pairs whose rows the warp
    tested added to it. A CUDA tensor goes to ``csrc/trace_sched.cu``, a
    CPU tensor to :func:`trace_round_sched_plain`."""
    global trace_round_sched_launches, trace_round_sched_posed_launches
    _check_k2_inputs(state, rows, boxes, sched, scal, params.n_bands, visits)
    n_poses, rays_per_pose = rc.check_poses(state, scal, rays_per_pose)
    if state.device.type == "cpu":
        return trace_round_sched_plain(state, rows, boxes, sched, scal,
                                       params, rays_per_pose, visits)
    if state.device.type != "cuda":
        raise ValueError(f"no trace kernel for device {state.device}")
    _check_aligned(rows=rows, boxes=boxes)
    err = _build.library().ar2_trace_sched(
        state.data_ptr(), state.shape[1], state.shape[0], rows.data_ptr(),
        rows.shape[0] // boxes.shape[0], boxes.data_ptr(), sched.data_ptr(),
        sched.shape[1], scal.data_ptr(), n_poses, rays_per_pose,
        params.n_bands, rc.layout_bands(params.n_bands), params.max_bounces,
        None if visits is None else visits.data_ptr(),
        _build.stream(state.device))
    if scal.dim() == 2:
        trace_round_sched_posed_launches += 1
    else:
        trace_round_sched_launches += 1
    _build.check(err, "ar2_trace_sched")
    return state
