"""Differentiable inverse rendering: fit scene and source parameters to a
target impulse response by gradient descent through the tracer.

The counterpart of ``audiorenderingv2_tpu/diff/inverse.py``. Two things
upstream make it possible:

* the autograd backend of ``core/tracer.py`` is reverse-differentiable, with
  gradients to absorption (through the per-bounce products of 1 - a), to
  emitter and receiver pose (through path lengths and the receiver chord)
  and to geometry (through the plane rows);
* soft (linearly interpolated) binning gives the arrival time a gradient
  (``TracerOptions(soft_binning=True)``).

``fit_scene_parameters`` has two methods. ``"full"`` back-propagates through
the autograd tracer, which searches every triangle at every bounce of every
step. ``"replay"`` records the path topology with the trace kernels once per
``replay_refresh`` steps and differentiates the replay of it
(``diff/replay.py``): the same gradients wherever the topology is locally
constant, and the only method that scales to a million rays. Adam is
``torch.optim.Adam``, which computes what ``optax.adam`` computes (bias
correction, eps 1e-8 outside the root, the count starting at 0).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import tuned
from ..core import sampling
from ..core.params import TraceParams
from ..core.tracer import SceneArrays, TracerOptions, scene_to_arrays, trace_ir
from ..scene import Scene
from ..utils import profiling
from ..utils.logging import get_logger
from . import checkpoint as ckpt
from . import replay as replay_mod


def material_ids_padded(scene: Scene, t_padded: int) -> torch.Tensor:
    """The material slot of every padded triangle, int64 [t_padded]: its
    material id, or the trailing "no material" slot for id -1 and for
    padding triangles."""
    n_mats = len(scene.material_names)
    ids = np.full(t_padded, n_mats, np.int64)
    tm = scene.tri_material[:t_padded]
    ids[: tm.shape[0]] = np.where(tm < 0, n_mats, tm)
    return torch.from_numpy(ids)


def with_material_absorption(sc: SceneArrays, mat_ids: torch.Tensor,
                             per_material: torch.Tensor) -> SceneArrays:
    """``sc`` with its absorption gathered from a per-material table: the
    hook that makes absorption an optimization variable."""
    return sc._replace(absorption=per_material.index_select(
        0, mat_ids.to(per_material.device)))


def smooth_ir(ir: torch.Tensor, radius: int) -> torch.Tensor:
    """Box-filter the time axis three times (about a Gaussian of sigma
    ``radius``). Soft binning supports a gradient over +-1 bin only;
    smoothing prediction and target before the loss widens the basin of a
    pose fit to +-3 * radius bins. By cumulative sums, O(n),
    differentiable."""
    if radius <= 0:
        return ir
    n = ir.shape[-1]
    j = torch.arange(n, device=ir.device)
    hi = torch.clamp(j + radius + 1, 0, n)
    lo = torch.clamp(j - radius, 0, n)

    def box(x):
        c = torch.cumsum(x, dim=-1)
        c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
        return (c[..., hi] - c[..., lo]) * (1.0 / (2 * radius + 1))

    return box(box(box(ir)))


def ir_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "l2",
            smooth_radius: int = 0) -> torch.Tensor:
    """Scalar distance of two IRs: ``"l2"`` on the energies; ``"log"`` on
    log(1 + 100 ir / max(target)), which weighs the tail against the strong
    early arrivals. ``smooth_radius`` filters both first
    (:func:`smooth_ir`)."""
    pred = smooth_ir(pred, smooth_radius)
    target = smooth_ir(target, smooth_radius)
    if kind == "l2":
        return torch.mean((pred - target) ** 2)
    if kind == "log":
        scale = torch.clamp(target.max(), min=1e-12)
        f = lambda x: torch.log1p(x / scale * 100.0)  # noqa: E731
        return torch.mean((f(pred) - f(target)) ** 2)
    raise ValueError(kind)


def _recording_counters(paths, pose: bool) -> dict:
    """The counters of one recording while a profiler records, else {}:
    ``replay_deposits``, the rays that deposit, and ``replay_steps``, the
    recorded steps the replay walks (each depositing ray's up to its
    ``recv_step``: every one left a surface), both summed over the
    receivers' path sets; ``replay_receivers``, the path sets recorded (one
    a receiver); ``replay_pose``, 1 where the replay is the pose pair,
    which carries the emitter's tangents, else 0. ``recv_step`` comes to
    the host in one copy, so no kernel is launched."""
    with profiling.collect() as counters:
        if profiling.counting():
            recv = np.concatenate([r.cpu().numpy() for _, r in paths])
            dep = recv[recv >= 0].astype(np.int64)
            profiling.count("replay_deposits", lambda: dep.size, once=True)
            profiling.count("replay_steps", lambda: dep.sum(), once=True)
            profiling.count("replay_receivers", lambda: len(paths),
                            once=True)
            profiling.count("replay_pose", lambda: int(pose), once=True)
    return counters.read()


@dataclass
class FitResult:
    params: dict
    losses: np.ndarray

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1])


def _diff_opts(opts: TracerOptions) -> TracerOptions:
    # The kernels are forward-only; gradients need the autograd backend.
    return dataclasses.replace(opts, early_exit=False, soft_binning=True,
                               remat=True, backend="autograd")


def _directions(directions, n_rays: int, seed: int, device) -> torch.Tensor:
    """The fixed direction set: the caller's, or ``n_rays`` drawn on
    ``device`` from a generator seeded with ``seed``."""
    if directions is not None:
        return torch.as_tensor(directions, dtype=torch.float32).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return sampling.sample_directions(n_rays, gen, device)


def _target(target_ir, device) -> torch.Tensor:
    """The target IR as a float32 tensor on ``device``, from a tensor on any
    device or from an array."""
    if not isinstance(target_ir, torch.Tensor):
        target_ir = torch.as_tensor(np.asarray(target_ir))
    return target_ir.detach().to(device=device, dtype=torch.float32)


def _receivers(receiver_pos, receiver_yaw_deg, device):
    """(positions [L, 3], yaws [L] as floats, whether there are several)."""
    recs = np.atleast_2d(np.asarray(receiver_pos, np.float32))
    yaws = np.broadcast_to(np.asarray(receiver_yaw_deg, np.float32),
                           (recs.shape[0],))
    return (torch.from_numpy(recs).to(device), [float(y) for y in yaws],
            np.asarray(receiver_pos).ndim > 1)


def fit_scene_parameters(
    scene: Scene,
    target_ir,
    params: TraceParams,
    *,
    n_rays: int = 8192,
    fit_absorption: bool = True,
    fit_emitter: bool = False,
    init_emitter=(0.0, 0.0, 0.0),
    receiver_pos=(0.0, 0.0, 0.0),
    receiver_yaw_deg: float = 0.0,
    init_absorption: float = 0.5,
    steps: int = 100,
    learning_rate: float = 0.05,
    opts: TracerOptions = TracerOptions(block_size=4096),
    loss_kind: str = "log",
    smooth_radius: int = 0,
    seed: int = 0,
    callback: Callable[[int, float, dict], None] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 50,
    method: str = "full",
    replay_refresh: int = 25,
    device: torch.device | str = "cuda",
    directions=None,
) -> FitResult:
    """Fit per-material absorption and/or the emitter position to a target
    IR, on ``device``.

    Absorption is parameterised through a sigmoid, so it stays in (0, 1);
    with banded ``params`` the table is [n_materials + 1, n_bands]. One
    fixed direction set serves every step (common random numbers), so the
    optimizer sees a smooth landscape: ``directions`` [N, 3], or ``n_rays``
    drawn from a ``torch.Generator`` seeded with ``seed``. One receiver [3]
    or several [L, 3] (then ``target_ir`` is [L, 2, bins]): several make the
    source position well-posed. ``callback(step, loss, theta)`` runs after
    every step; ``checkpoint_path`` saves every ``checkpoint_every`` steps
    and at the end, and resumes from the file when it exists.

    ``method``: ``"full"`` back-propagates through the autograd tracer's
    search at every step; ``"replay"`` records the topology every
    ``replay_refresh`` steps at the current parameters (it moves with the
    emitter and, through the energy threshold, with absorption) and
    differentiates its replay. The recorder is ``record_paths_kernels``; a
    scene of ``tuned.CLUSTER_THRESHOLD`` triangles and up is Morton-sorted
    into clusters first and recorded through the schedule and K2, as the
    renderer would trace it.

    Each step is an ``ar2.fit.step`` span (``utils.profiling``) around
    ``ar2.fit.record`` (when it records), ``ar2.fit.forward`` (the replay
    or the trace, and the binning), ``ar2.fit.loss``, ``ar2.fit.backward``,
    ``ar2.fit.adam`` and ``ar2.fit.loss_read`` (the loss's copy to the
    host); the callback runs after it. While a profiler records, each
    recording of the replay method also writes a ``fit_record`` event
    (``utils.logging``) with its step and its counters:
    ``replay_deposits`` (the rays that deposit), ``replay_steps`` (the
    recorded steps up to each depositing ray's ``recv_step``), both over
    every receiver, ``replay_receivers`` (the path sets recorded, one a
    receiver) and ``replay_pose`` (1 where the emitter is fitted, so the
    replay is the pose pair, which carries the emitter's tangents).
    Untraced, nothing is counted and no event is written.
    """
    if method not in ("full", "replay"):
        raise ValueError(f"unknown method {method!r}")
    use_replay = method == "replay"
    opts = _diff_opts(opts)
    dev = torch.device(device)
    clusters = None
    rec_opts = TracerOptions()
    if use_replay:
        rec_opts, scene, clusters = tuned.prepare(scene, params.max_bounces)
    sc = scene_to_arrays(scene, opts.tri_chunk, device=dev, clusters=clusters)
    mat_ids = material_ids_padded(scene, sc.absorption.shape[0]).to(dev)
    n_mats = len(scene.material_names)

    dirs = _directions(directions, n_rays, seed, dev)
    target_ir = _target(target_ir, dev)
    recs, yaws, multi_rec = _receivers(receiver_pos, receiver_yaw_deg, dev)
    if multi_rec and target_ir.dim() == 2:
        raise ValueError("multiple receivers need target_ir [L, 2, bins]")

    theta: dict = {}
    if fit_absorption:
        shape = ((n_mats + 1,) if params.n_bands == 1
                 else (n_mats + 1, params.n_bands))
        init_a = np.clip(np.asarray(init_absorption, np.float32), 1e-4,
                         1 - 1e-4)
        logits = np.broadcast_to(np.log(init_a / (1.0 - init_a)), shape)
        theta["absorption_logits"] = torch.tensor(logits, dtype=torch.float32,
                                                  device=dev)
    if fit_emitter:
        theta["emitter"] = torch.tensor(np.asarray(init_emitter, np.float32),
                                        device=dev)
    if not theta:
        raise ValueError("nothing to fit")
    for p in theta.values():
        p.requires_grad_(True)
    fixed_emitter = torch.tensor(np.asarray(init_emitter, np.float32),
                                 device=dev)

    def scene_at(theta):
        if not fit_absorption:
            return sc
        return with_material_absorption(
            sc, mat_ids, torch.sigmoid(theta["absorption_logits"]))

    def predict(theta, paths):
        sc_t = scene_at(theta)
        emitter = theta.get("emitter", fixed_emitter)
        if use_replay:
            irs = [replay_mod.render_ir_replay(
                       sc_t, ids, recv, dirs, emitter, recs[i], yaws[i],
                       params, soft_binning=True)
                   for i, (ids, recv) in enumerate(paths)]
        else:
            irs = [trace_ir(sc_t, dirs, emitter, recs[i], yaws[i], params,
                            opts) for i in range(recs.shape[0])]
        return torch.stack(irs) if multi_rec else irs[0]

    def record(theta):
        with torch.no_grad():
            sc_t = scene_at(theta)
            emitter = theta.get("emitter", fixed_emitter)
            return [replay_mod.record_paths_kernels(
                        sc_t, dirs, emitter, recs[i], yaws[i], params,
                        rec_opts) for i in range(recs.shape[0])]

    optimizer = torch.optim.Adam(list(theta.values()), lr=learning_rate)
    losses: list = []
    start_step = 0
    if checkpoint_path is not None:
        restored = ckpt.load_fit_state(checkpoint_path, theta)
        if restored is not None:
            start_step, saved, opt_state, losses = restored
            with torch.no_grad():
                for name, p in theta.items():
                    p.copy_(torch.as_tensor(saved[name]))
            ckpt.load_adam_state(optimizer, theta, opt_state)

    refresh = max(replay_refresh, 1)
    paths = None
    span = profiling.span
    for i in range(start_step, steps):
        with span("ar2.fit.step"):
            if use_replay and (paths is None or i % refresh == 0):
                with span("ar2.fit.record"):
                    paths = record(theta)
                counted = _recording_counters(paths, fit_emitter)
                if counted:
                    get_logger().event("fit_record", step=i, **counted)
            optimizer.zero_grad(set_to_none=True)
            with span("ar2.fit.forward"):
                pred = predict(theta, paths)
            with span("ar2.fit.loss"):
                loss = ir_loss(pred, target_ir, loss_kind, smooth_radius)
            with span("ar2.fit.backward"):
                loss.backward()
            with span("ar2.fit.adam"):
                optimizer.step()
            with span("ar2.fit.loss_read"):
                losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1], theta)
        done = i + 1
        if checkpoint_path is not None and (done % checkpoint_every == 0
                                            or done == steps):
            ckpt.save_fit_state(checkpoint_path, done, theta,
                                ckpt.adam_state_of(optimizer, theta), losses)

    out: dict = {}
    if fit_absorption:
        out["absorption"] = torch.sigmoid(
            theta["absorption_logits"]).detach().cpu().numpy()
    if fit_emitter:
        out["emitter"] = theta["emitter"].detach().cpu().numpy()
    return FitResult(params=out, losses=np.asarray(losses))


@torch.no_grad()
def coarse_emitter_search(
    scene: Scene,
    target_ir,
    params: TraceParams,
    *,
    candidates: np.ndarray,
    receiver_pos,
    receiver_yaw_deg=0.0,
    n_rays: int = 2048,
    opts: TracerOptions = TracerOptions(block_size=4096),
    loss_kind: str = "log",
    smooth_radius: int = 32,
    seed: int = 0,
    device: torch.device | str = "cuda",
    directions=None,
) -> tuple[np.ndarray, np.ndarray]:
    """The IR loss at candidate emitter positions; returns (the best
    position [3], losses [n_candidates]).

    The tracer's gradient has a fixed path topology: it cannot see rays
    that would start or stop hitting the receiver under a change, so a
    descent on the source position stalls in spurious basins more than
    about a metre from the truth. A coarse grid costs one forward render
    per candidate and receiver, no gradients, and lands the refinement
    inside the basin."""
    opts = _diff_opts(opts)
    dev = torch.device(device)
    sc = scene_to_arrays(scene, opts.tri_chunk, device=dev)
    dirs = _directions(directions, n_rays, seed, dev)
    target_ir = _target(target_ir, dev)
    recs, yaws, multi = _receivers(receiver_pos, receiver_yaw_deg, dev)
    candidates = np.asarray(candidates, np.float32).reshape(-1, 3)
    losses = []
    for cand in torch.from_numpy(candidates).to(dev):
        irs = [trace_ir(sc, dirs, cand, recs[i], yaws[i], params, opts)
               for i in range(recs.shape[0])]
        pred = torch.stack(irs) if multi else irs[0]
        losses.append(ir_loss(pred, target_ir, loss_kind, smooth_radius))
    losses = torch.stack(losses).cpu().numpy()
    return candidates[int(np.argmin(losses))], losses


def emitter_grid(bounds_min, bounds_max, spacing: float = 2.0) -> np.ndarray:
    """A regular grid of candidate positions inside an axis-aligned box
    (for :func:`coarse_emitter_search`)."""
    axes = [np.arange(lo + spacing / 2, hi, spacing)
            for lo, hi in zip(np.asarray(bounds_min), np.asarray(bounds_max))]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1).astype(np.float32)


@torch.no_grad()
def render_soft_ir(scene: Scene, params: TraceParams, *, n_rays: int,
                   emitter, receiver_pos, receiver_yaw_deg: float = 0.0,
                   opts: TracerOptions = TracerOptions(block_size=4096),
                   seed: int = 0, device: torch.device | str = "cuda",
                   directions=None) -> torch.Tensor:
    """A soft-binned target IR from the direction stream the fitter draws
    (same ``seed``, same ``device``), or from ``directions``: for
    self-consistent inverse tests and demos. Returned on ``device``."""
    opts = _diff_opts(opts)
    dev = torch.device(device)
    sc = scene_to_arrays(scene, opts.tri_chunk, device=dev)
    dirs = _directions(directions, n_rays, seed, dev)
    return trace_ir(sc, dirs, np.asarray(emitter, np.float32),
                    np.asarray(receiver_pos, np.float32),
                    float(receiver_yaw_deg), params, opts)
