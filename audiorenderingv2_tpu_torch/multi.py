"""Multi-source / multi-listener rendering.

The counterpart of ``audiorenderingv2_tpu/multi.py``. The reference engine
renders one emitter and one receiver per run; auralization of S sources at
L listeners is one more batch axis:

  * :func:`render_ir_matrix` renders the [S, L] IR matrix, ``pair_batch``
    pairs per kernel launch (``core/tracer.render_ir_pose_batch``: the ray
    state is pose-major and every 128-ray tile reads its pair's emitter,
    receiver and yaw from that pair's scalar row);
  * :func:`mix_sources` auralizes per listener: each source's dry signal is
    convolved with its IR to that listener and the results sum (linearity
    of the wave equation, the single-source normalisation).

Listeners are independent: a listener does not shadow another listener's
arrivals, as if the reference ran L separate times. With a ``mesh``
(``parallel.make_ray_mesh``) every pair's rays are sharded over the ranks,
one all-reduce a chunk of pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import sampling
from .core.params import TraceParams
from .core.tracer import (SceneArrays, TracerOptions, pack_for_route,
                          render_ir, render_ir_pose_batch, trace_route)
from .ops import convolve, filterbank
from .parallel import sharding
from .utils import profiling


def render_ir_matrix(
    sc: SceneArrays,
    seed: int,
    emitters: np.ndarray,
    receivers: np.ndarray,
    receiver_yaws_deg: np.ndarray,
    n_rays: int,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    pair_batch: int = 16,
    rows: torch.Tensor | None = None,
    boxes: torch.Tensor | None = None,
    mesh=None,
) -> np.ndarray:
    """Render IRs for every (source, listener) pair on the scene's device,
    or with ``mesh`` on the rank's device.

    Args:
      seed: pair ``i = s * L + l`` draws its directions from
        ``sampling.pose_generator(seed, i, device)``, whichever path
        renders it, so a single ``render_ir`` of one pair with that
        generator gives the pair's IR. With a mesh, rank ``r`` draws pair
        ``i``'s ``n_rays // world`` directions from
        ``sampling.pose_generator(seed, i, device, rank=r)``, seeded with
        ``fold_seed(fold_seed(seed, i), r)``, traced at the energy of
        ``n_rays``: pair ``i`` is ``parallel.render_ir_sharded`` of the
        pair's seed ``sampling.fold_seed(seed, i)`` on the same mesh, and a
        single-process replay traces the directions of every rank with
        ``n_total_rays=n_rays``.
      emitters: [S, 3]; receivers: [L, 3]; receiver_yaws_deg: [L] or one
        yaw for every listener.
      n_rays: rays per pair render.
      pair_batch: pairs traced per launch. It bounds the ray states in
        flight at exactly pair_batch * n_rays; 0 = all S * L pairs at once;
        1 = one single-pose render per pair.
      rows, boxes: the scene's packed rows and boxes
        (``raytrace_cuda.pack_scene``) on the device it renders on, None
        packs them here once.
      mesh: a ``parallel.sharding.Mesh``; every rank renders every pair
        and returns the same summed matrix. ``n_rays`` must divide by the
        world size.

    The fused batch needs a route with a posed form
    (``core.tracer.trace_route``), hard binning and sampled directions (not
    ``opts.native_rng``); otherwise every pair is one ``render_ir``.

    Returns float32 [S, L, 2, ir_length], or [S, L, 2, n_bands, ir_length]
    for a banded scene (params.n_bands > 1), on the host.

    Spans (``utils.profiling``): ``ar2.matrix`` around the batches, each an
    ``ar2.matrix.batch`` (the renders and the sum over ranks) and an
    ``ar2.matrix.to_host`` (the IRs' copy).
    """
    if pair_batch is not None and pair_batch < 0:
        raise ValueError(f"pair_batch must be >= 0 (0 = all pairs at "
                         f"once), got {pair_batch}")
    emitters = np.atleast_2d(np.asarray(emitters, np.float32))
    receivers = np.atleast_2d(np.asarray(receivers, np.float32))
    # A scalar yaw goes to every listener; a mismatched length is an error
    # (a short yaw list would otherwise silently zero listener rows).
    yaws = np.broadcast_to(np.asarray(receiver_yaws_deg, np.float32),
                           (receivers.shape[0],))
    s, l = len(emitters), len(receivers)
    n_pairs = s * l
    em_p = np.repeat(emitters, l, axis=0)
    rc_p = np.tile(receivers, (s, 1))
    yw_p = np.tile(yaws, s)
    n_local, rank = n_rays, None
    if mesh is not None:
        n_local, rank = sharding.shard_size(n_rays, mesh), mesh.rank
        sc = sharding.scene_on(sc, mesh.device)
    route = trace_route(opts, params.n_bands, sc.cluster_boxes is not None)
    rows, boxes = pack_for_route(sc, params, rows, boxes, route)
    fused = (pair_batch != 1 and route is not None and route.pose_batch
             and not opts.soft_binning and not opts.native_rng)
    # pair_batch is a bound on memory, not a hint: honour it exactly. The
    # tail runs at its own size.
    batch = n_pairs if pair_batch in (0, None) else min(pair_batch, n_pairs)
    chunks = []
    span = profiling.span
    with span("ar2.matrix"):
        for start in range(0, n_pairs, batch):
            idx = np.arange(start, min(start + batch, n_pairs))
            with span("ar2.matrix.batch"):
                if fused:
                    irs = render_ir_pose_batch(
                        sc, seed, n_local, em_p[idx], rc_p[idx], yw_p[idx],
                        params, opts, pose_indices=idx, rows=rows,
                        boxes=boxes, n_total_rays_per_pose=n_rays, rank=rank)
                else:
                    irs = torch.stack([
                        render_ir(sc, sampling.pose_generator(
                                      seed, i, sc.device, rank),
                                  n_local, em_p[i], rc_p[i], float(yw_p[i]),
                                  params, opts, n_total_rays=n_rays,
                                  rows=rows, boxes=boxes)
                        for i in idx])
                if mesh is not None:
                    irs = sharding.sum_across_ranks(irs, mesh)
            with span("ar2.matrix.to_host"):
                chunks.append(irs.cpu().numpy())
    flat = np.concatenate(chunks)
    # [S, L, 2(, n_bands), ir_length]: the per-pair IR after the pair axes.
    return flat.reshape((s, l) + flat.shape[1:])


def mix_sources(
    ir_matrix,
    signals: list[np.ndarray],
    sample_rate: int,
    band_edges: tuple = filterbank.DEFAULT_BAND_EDGES,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Auralize S sources at L listeners on ``device``.

    Args:
      ir_matrix: [S, L, 2, ir_length] from :func:`render_ir_matrix` (array
        or tensor), or its banded form [S, L, 2, n_bands, ir_length],
        auralized through the filterbank with ``band_edges``.
      signals: S mono dry signals (they may differ in length; each is
        zero-padded to the longest).
    Returns float32 [L, 2, max_len] on the host: per-listener stereo mixes.
    """
    irs = torch.as_tensor(ir_matrix, dtype=torch.float32).to(device)
    s, l = irs.shape[:2]
    if len(signals) != s:
        raise ValueError(f"{s} sources but {len(signals)} signals")
    max_len = max(sig.shape[0] for sig in signals)
    out = torch.zeros((l, 2, max_len), dtype=torch.float32, device=device)
    # One call per source: its L listeners' convolutions in one batch.
    for si, sig in enumerate(signals):
        padded = np.zeros(max_len, np.float32)
        padded[:sig.shape[0]] = sig
        ir = irs[si].reshape((l * 2,) + irs.shape[3:])
        if irs.dim() == 5:
            y = filterbank.convolve_file_banded(padded, ir, sample_rate,
                                                tuple(band_edges))
        else:
            y = convolve.convolve_file_stereo(padded, ir, sample_rate)
        out += y.reshape(l, 2, max_len)
    return out.cpu().numpy()
