"""K5: bounce rounds over a clustered scene with the clusters found and
ordered inside the kernel.

The counterpart of the in-kernel traversal of the JAX package's trace kernel
(``audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2``,
``use_cull`` without ``use_sched``, :547-661; launched by
``trace_round_v2``, :799, with boxes and no schedule). It is what a
clustered scene runs when the schedule is off (``TracerOptions.schedule``
False, the default of explicit options): the path recorder's default and a
renderer with manual options.

A tile is 128 consecutive rays. Per bounce and tile, every alive ray is
slab-tested against every cluster box; a cluster's entry distance is the
least over the alive rays that reach it. Clusters are then visited in
increasing entry distance (ties to the lowest id), each visit intersecting
the cluster's rows with every alive ray of the tile under a strict running
minimum, until the nearest unvisited entry is not below the largest best hit
among the alive rays (+inf while one of them has no hit yet, 0 when none is
alive). Then K1's receiver test and bounce tail. Among hits at exactly the
same distance the cluster visited FIRST wins, where K2 keeps the lowest row:
the two agree wherever the nearest distance is unique. The kernel gets the
same entries by testing superboxes of 32 clusters first, and the same visit
sequence by sorting the reached clusters once per bounce (the plain version
picks the least unvisited entry before every visit).

``trace_traverse`` launches ``csrc/trace_traverse.cu`` for a CUDA tensor and
runs ``trace_traverse_plain`` for a CPU tensor; it never falls back from one
to the other. The plain version walks the same visit order per tile, so the
two agree bit for bit. ``trace_traverse_launches`` counts kernel launches
(with one scalar row or one per pose).
"""
from __future__ import annotations

import math

import torch

from .. import constants
from ..core.params import TraceParams
from . import _build
from . import raytrace_cuda as rc
from . import schedule_cuda as sc

# Kernel launches since import (or since a caller reset it to 0).
trace_traverse_launches = 0

_TILE = 128
_SMEM_BYTES = 226 * 1024  # what a block of the kernel may take (its kMaxSmem)
_GROUP = 32               # clusters per superbox
_SLAB_ELEMS = 1 << 22   # rays x boxes per chunk of the plain slab pass
_TEST_ELEMS = 1 << 24   # rays x rows per chunk of the plain intersection


def _tile_entries(state: torch.Tensor, boxes: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """f32 [n_tiles, C]: per tile and cluster, the least entry distance
    over the tile's alive rays that reach the box; inf when none does."""
    n_tiles = state.shape[1] // _TILE
    c = boxes.shape[0]
    chunk = max(1, _SLAB_ELEMS // (c * _TILE))
    out = torch.empty((n_tiles, c), dtype=torch.float32, device=state.device)
    for t0 in range(0, n_tiles, chunk):
        k = min(chunk, n_tiles - t0)
        st = state[:, t0 * _TILE:(t0 + k) * _TILE].reshape(-1, k, _TILE)
        entry, ok = sc.slab_pass(st, boxes)
        ok = ok & alive[t0 * _TILE:(t0 + k) * _TILE].view(k, 1, _TILE)
        out[t0:t0 + k] = torch.where(ok, entry, math.inf).amin(dim=2)
    return out


def _nearest_hit_tiles(ray: list[torch.Tensor], rows: torch.Tensor):
    """Nearest valid hit of each ray of A tiles over its tile's own rows:
    ``ray`` six tensors [A, 128], ``rows`` [A, cs, 24] -> (t [A, 128], inf
    on a miss, row index within the cluster [A, 128]; ties to the lowest).
    The arithmetic of ``raytrace_cuda._nearest_hit``."""
    px, py, pz, vx, vy, vz = (a[:, None, :] for a in ray)    # [A, 1, 128]
    cr = lambda j: rows[:, :, j, None]  # noqa: E731          [A, cs, 1]
    nd = vx * cr(rc._R_PNX) + vy * cr(rc._R_PNY) + vz * cr(rc._R_PNZ)
    no = (px * cr(rc._R_PNX) + py * cr(rc._R_PNY) + pz * cr(rc._R_PNZ)
          + cr(rc._R_PD))
    safe = torch.abs(nd) > 1e-12
    t = -no / torch.where(safe, nd, 1.0)
    ou = (px * cr(rc._R_AUX) + py * cr(rc._R_AUY) + pz * cr(rc._R_AUZ)
          + cr(rc._R_AUO))
    du = vx * cr(rc._R_AUX) + vy * cr(rc._R_AUY) + vz * cr(rc._R_AUZ)
    u = ou + t * du
    ov = (px * cr(rc._R_AVX) + py * cr(rc._R_AVY) + pz * cr(rc._R_AVZ)
          + cr(rc._R_AVO))
    dv = vx * cr(rc._R_AVX) + vy * cr(rc._R_AVY) + vz * cr(rc._R_AVZ)
    v = ov + t * dv
    ok = (safe & (t > constants.T_MIN)
          & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1.0 + 1e-7)
          & (cr(rc._R_VAL) > 0))
    return torch.where(ok, t, math.inf).min(dim=1)


def _traverse(state: torch.Tensor, rows: torch.Tensor, boxes: torch.Tensor,
              alive: torch.Tensor, visits: torch.Tensor | None):
    """Nearest hits of one bounce by the front-to-back traversal: (t [N],
    row index int64 [N]) of every ray; only the alive rays' are meant."""
    n = state.shape[1]
    n_tiles, c = n // _TILE, boxes.shape[0]
    cs = rows.shape[0] // c
    dev = state.device
    entry = _tile_entries(state, boxes, alive)
    rows_c = rows.view(c, cs, rows.shape[1])
    ray = [state[col].view(n_tiles, _TILE)
           for col in range(rc._C_PX, rc._C_VZ + 1)]
    alive_t = alive.view(n_tiles, _TILE)
    best_t = torch.full((n_tiles, _TILE), math.inf, dtype=torch.float32,
                        device=dev)
    best_i = torch.zeros((n_tiles, _TILE), dtype=torch.int64, device=dev)
    ids = torch.arange(c, device=dev)
    chunk = max(1, _TEST_ELEMS // (cs * _TILE))
    while True:
        tn = entry.amin(dim=1)
        nxt = torch.where(entry <= tn[:, None], ids, c).amin(dim=1)
        far = torch.where(alive_t, best_t, 0.0).amax(dim=1)
        act = torch.nonzero(tn < far).squeeze(1)   # tiles that visit `nxt`
        if act.numel() == 0:
            break
        ca = nxt[act]
        entry[act, ca] = math.inf                  # visited
        if visits is not None:
            visits[act] += 1
        for a0 in range(0, act.numel(), chunk):
            a, cl = act[a0:a0 + chunk], ca[a0:a0 + chunk]
            t, i = _nearest_hit_tiles([x[a] for x in ray], rows_c[cl])
            better = alive_t[a] & (t < best_t[a])
            best_t[a] = torch.where(better, t, best_t[a])
            best_i[a] = torch.where(better, i + (cl * cs)[:, None], best_i[a])
    return best_t.view(n), best_i.view(n)


def trace_traverse_plain(state: torch.Tensor, rows: torch.Tensor,
                         boxes: torch.Tensor, scal: torch.Tensor,
                         params: TraceParams, round_budget: int,
                         rays_per_pose: int | None = None,
                         visits: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5: up to ``round_budget`` bounces of every
    ray, in place. Each bounce runs the slab pass and the per-tile visit
    loop of the kernel over all tiles at once (one step of the loop is every
    tile's next visit), then K1's receiver test and bounce tail. With
    ``scal`` [P, 16], ray ``i`` reads row ``i // rays_per_pose``."""
    en_cols, evw_cols = rc.band_cols(params.n_bands)
    state[rc._C_LTRI] = 0.0
    every = torch.arange(state.shape[1], device=state.device)
    for _ in range(round_budget):
        running = state[rc._C_DONE] == 0.0
        idx = torch.nonzero(running).squeeze(1)
        if idx.numel() == 0:
            break
        alive = running & rc._can_continue(
            state, rc.pose_rows(scal, every, rays_per_pose).movedim(-1, 0),
            en_cols, params.max_bounces)
        best_t, best_i = _traverse(state, rows, boxes, alive, visits)
        s = state[:, idx]
        rc._bounce(s, rows, rc.pose_rows(scal, idx, rays_per_pose), en_cols,
                   evw_cols, params.max_bounces,
                   best=(best_t[idx], best_i[idx]))
        state[:, idx] = s
    return state


def _smem_bytes(cs: int, n_clusters: int) -> int:
    """Shared memory a block of the kernel takes (``traverse_smem`` in
    ``csrc/trace_traverse.cu``): one cluster's rows, a superbox per group
    of 32 clusters, a key per cluster and the sorted list of them, a mask
    word per group."""
    groups = -(-n_clusters // _GROUP)
    return 4 * rc._NR * cs + 32 * groups + 16 * n_clusters + 4 * groups


def _check_inputs(state, rows, boxes, scal, n_bands, round_budget,
                  visits) -> None:
    rc._check_round(state, rows, scal, n_bands, round_budget)
    sc._check_schedule_inputs(state, boxes)
    n_clusters = boxes.shape[0]
    cs = rows.shape[0] // n_clusters
    if cs * n_clusters != rows.shape[0] or cs % rc._TRI_BLOCK:
        raise ValueError(f"{rows.shape[0]} rows over {n_clusters} clusters "
                         f"need a cluster size that is a multiple of "
                         f"{rc._TRI_BLOCK}")
    # The same limit holds on every device, so that the CPU shows what the
    # card would refuse.
    need = _smem_bytes(cs, n_clusters)
    if need > _SMEM_BYTES:
        raise ValueError(f"{n_clusters} clusters of {cs} rows need {need} "
                         f"bytes of shared memory a block, over the "
                         f"{_SMEM_BYTES} the traversal kernel has")
    if visits is not None:
        want = (state.shape[1] // _TILE,)
        if visits.dtype != torch.int32 or tuple(visits.shape) != want:
            raise ValueError(f"visits must be int32 {list(want)}, got "
                             f"{visits.dtype} {list(visits.shape)}")
        sc._contiguous_on(state, visits=visits)


def trace_traverse(state: torch.Tensor, rows: torch.Tensor,
                   boxes: torch.Tensor, scal: torch.Tensor,
                   params: TraceParams, round_budget: int = 1,
                   rays_per_pose: int | None = None,
                   visits: torch.Tensor | None = None) -> torch.Tensor:
    """K5: advance every ray of ``state`` [ncols, N] by up to
    ``round_budget`` bounces over a clustered scene (``rows``, ``boxes``
    from ``raytrace_cuda.pack_tris_clusters``), in place; returns
    ``state``. ``scal`` is one scalar row [16], or [P, 16] for a pose-major
    state of P poses with ``rays_per_pose`` rays each. ``visits``, int32
    [N / 128], has each tile's cluster visits of the round added to it. A
    CUDA tensor goes to ``csrc/trace_traverse.cu``, a CPU tensor to
    :func:`trace_traverse_plain`."""
    global trace_traverse_launches
    _check_inputs(state, rows, boxes, scal, params.n_bands, round_budget,
                  visits)
    n_poses, rays_per_pose = rc.check_poses(state, scal, rays_per_pose)
    if state.device.type == "cpu":
        return trace_traverse_plain(state, rows, boxes, scal, params,
                                    int(round_budget), rays_per_pose, visits)
    if state.device.type != "cuda":
        raise ValueError(f"no trace kernel for device {state.device}")
    sc._check_aligned(rows=rows, boxes=boxes)
    err = _build.library().ar2_trace_traverse(
        state.data_ptr(), state.shape[1], state.shape[0], rows.data_ptr(),
        rows.shape[0] // boxes.shape[0], boxes.data_ptr(), boxes.shape[0],
        scal.data_ptr(), n_poses, rays_per_pose, params.n_bands,
        rc.layout_bands(params.n_bands), int(round_budget),
        params.max_bounces, None if visits is None else visits.data_ptr(),
        _build.stream(state.device))
    trace_traverse_launches += 1
    _build.check(err, "ar2_trace_traverse")
    return state
