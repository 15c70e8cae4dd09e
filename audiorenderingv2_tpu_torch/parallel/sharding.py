"""Rays sharded over processes, one process per GPU (``torch.distributed``).

The counterpart of ``audiorenderingv2_tpu/parallel/sharding.py``. Rays are
independent, so the trace splits along them:

  * a :class:`Mesh` stands where JAX's 1-D ``rays`` mesh stands: the process
    group, this rank, the world size and the rank's device;
  * each rank traces ``n_rays // world`` rays with the global ray count's
    energy normalisation (``n_total_rays``), its directions drawn from its
    own generator, ``sampling.pose_generator(seed, rank)``, where the JAX
    package folds the key with the axis index;
  * one all-reduce (SUM) of the partial IRs replaces the ``psum``;
  * gradients: every rank computes the same loss from the replicated IR, so
    the all-reduce's backward is the identity (:func:`sum_across_ranks`),
    and the partial gradients of replicated parameters are summed by one
    more all-reduce (:func:`all_reduce_gradients`), where shard_map's
    transpose psums them in JAX.

Multi-process: call :func:`init_distributed` once in every process before
building a mesh. Without a process group a mesh is a world of one and no
collective runs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core import sampling
from ..core.params import TraceParams
from ..core.tracer import SceneArrays, TracerOptions, render_ir, trace_ir

RAYS_AXIS = "rays"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join this process to the process group (one process per GPU). A
    no-op for a single process (``num_processes`` None or <= 1) and when
    the group already exists, as in the JAX package.

    ``coordinator_address``: ``host:port`` of rank 0's rendezvous.
    ``backend``: by default ``"nccl"`` where CUDA is available, else
    ``"gloo"``. Where CUDA is available the rank's device
    (``cuda:{rank % devices}``) becomes the current device before the group
    is made; a failed NCCL init raises, and nothing falls back to gloo."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device(process_id))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def local_device(rank: int) -> torch.device:
    """The GPU of global ``rank`` on its host: ``cuda:{rank % devices}``
    (ranks numbered host by host)."""
    n = torch.cuda.device_count()
    return torch.device("cuda", rank % n) if n else torch.device("cuda")


@dataclass(frozen=True)
class Mesh:
    """A 1-D set of ranks along one axis: ``group`` (None for a world of
    one without a process group: no collective runs), this process's
    ``rank`` in it, the world ``size`` and the rank's ``device``."""

    axis: str
    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(axis: str, group=None, device=None) -> Mesh:
    """A mesh over ``group`` (default: every process of the initialised
    group; without one, a world of one). ``device``: default the rank's
    GPU (:func:`local_device`); pass ``"cpu"`` to run on the CPU."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        own = dist.get_rank()
    elif group is not None:
        raise ValueError("a process group needs torch.distributed "
                         "initialised first (init_distributed)")
    else:
        rank, size, own = 0, 1, 0
    dev = local_device(own) if device is None else torch.device(device)
    return Mesh(axis, group, rank, size, dev)


def make_ray_mesh(group=None, device=None) -> Mesh:
    """The ``rays`` mesh over ``group`` (see :func:`make_mesh`)."""
    return make_mesh(RAYS_AXIS, group, device)


class _SumAcrossRanks(torch.autograd.Function):
    """Forward: all_reduce(SUM) of a copy. Backward: the identity, since
    every rank already holds dL/d(sum) (``torch.distributed.nn``'s
    all_reduce would all-reduce it again: world-size times the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_across_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, on every rank; its gradient
    is the identity (see the module docstring)."""
    if mesh.group is None:
        return x
    return _SumAcrossRanks.apply(x, mesh.group)


def all_reduce_gradients(tensors, mesh: Mesh) -> None:
    """Sum the ``.grad`` of each replicated parameter over the mesh's ranks
    in place: each rank's backward gave its shard's share."""
    if mesh.group is None:
        return
    for t in tensors:
        if t.grad is not None:
            dist.all_reduce(t.grad, op=dist.ReduceOp.SUM, group=mesh.group)


def scene_on(sc: SceneArrays, device: torch.device) -> SceneArrays:
    """``sc`` with every tensor on ``device`` (a no-op, graph kept, where
    it is there already)."""
    return SceneArrays(*(None if t is None else t.to(device) for t in sc))


def shard_size(n: int, mesh: Mesh) -> int:
    """Rays a rank traces of ``n``; raises unless the world divides it."""
    if n % mesh.size:
        raise ValueError(f"n_rays={n} not divisible by {mesh.size} ranks")
    return n // mesh.size


def render_ir_sharded(
    sc: SceneArrays,
    seed: int,
    n_rays: int,
    emitter,
    receiver_pos,
    receiver_yaw_deg: float,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    mesh: Mesh | None = None,
    rows: torch.Tensor | None = None,
    boxes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Render an IR with ``n_rays`` sharded over the mesh's ranks.

    Rank ``r`` draws its ``n_rays // world`` directions from
    ``sampling.pose_generator(seed, r, device)`` (with ``opts.native_rng``
    that generator gives K4's seed) and traces them at the global count's
    energy; the partial IRs are summed on every rank. ``rows``, ``boxes``:
    the scene packed on the mesh's device (None packs it). Returns the
    replicated float32 [2(, n_bands), ir_length] on the rank's device."""
    mesh = mesh or make_ray_mesh()
    local = shard_size(n_rays, mesh)
    sc = scene_on(sc, mesh.device)
    gen = sampling.pose_generator(seed, mesh.rank, mesh.device)
    ir = render_ir(sc, gen, local, emitter, receiver_pos, receiver_yaw_deg,
                   params, opts, n_total_rays=n_rays, rows=rows, boxes=boxes)
    return sum_across_ranks(ir, mesh)


def trace_directions_sharded(
    sc: SceneArrays,
    directions,
    emitter,
    receiver_pos,
    receiver_yaw_deg: float,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    mesh: Mesh | None = None,
    rows: torch.Tensor | None = None,
    boxes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Shard explicit ``directions`` [N, 3] over the mesh: rank ``r``
    traces the contiguous rows ``[r * N / world, (r + 1) * N / world)`` at
    the energy of N rays, and the partial IRs are summed on every rank (for
    tests and for parity with a single-process ``trace_ir`` of all N)."""
    mesh = mesh or make_ray_mesh()
    directions = torch.as_tensor(directions, dtype=torch.float32)
    n = directions.shape[0]
    local = shard_size(n, mesh)
    sc = scene_on(sc, mesh.device)
    mine = directions[mesh.rank * local:(mesh.rank + 1) * local]
    ir = trace_ir(sc, mine.to(mesh.device), emitter, receiver_pos,
                  receiver_yaw_deg, params, opts, n_total_rays=n, rows=rows,
                  boxes=boxes)
    return sum_across_ranks(ir, mesh)
