"""The port's dry-run entry points, the counterpart of the repository's
``__graft_entry__.py``:

``entry()``             the flagship scene's forward step: a render of
                        65,536 rays x 16 bounces through the kernels;
                        returns ``(fn, example_args)``.
``dryrun_multichip(n)`` run in every rank of an ``n``-process group: one
                        sharded training step (sharded soft-binned trace ->
                        all-reduce -> MSE -> gradients of the material
                        logits -> their all-reduce -> Adam), a sharded
                        schedule-mode clustered render, and a
                        segment-sharded convolution, at tiny shapes.

    python -m audiorenderingv2_tpu_torch.dryrun [--device cuda|cpu] [--world N]

runs ``entry``'s forward step, then spawns ``N`` ranks on a free localhost
port (default 1 on ``cuda``, 4 gloo ranks on ``cpu``; NCCL needs one GPU a
rank) and runs ``dryrun_multichip(N)`` in each.
"""
from __future__ import annotations

import argparse
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from . import accel, testing, tuned
from .core import sampling
from .core.params import TraceParams
from .core.tracer import TracerOptions, render_ir, scene_to_arrays, trace_ir
from .diff.inverse import material_ids_padded, with_material_absorption
from .parallel.ir_sharding import convolve_file_sharded, make_segment_mesh
from .parallel.sharding import (all_reduce_gradients, init_distributed,
                                make_ray_mesh, render_ir_sharded,
                                trace_directions_sharded)

FLAGSHIP_RAYS = 65_536
# A rank's rays in the training step: the JAX dry run's 512 (64 on each of
# its 8 devices). At 64 a rank, a world of one or two sees no reflected ray
# reach the receiver in 3 bounces, and the step's gradient is zero.
TRAIN_RAYS = 512
CLUSTER_RAYS = 128   # a rank's rays in the clustered render
SEED = 0
EMITTER = np.zeros(3, np.float32)
RECEIVER = np.array([3.5, 0.0, -2.0], np.float32)


def flagship_scene():
    """A closed room with an obstacle: the 14 x 9 x 11 m box (absorption
    0.3) and an icosphere of radius 1.5 at (3, -1, 2) (absorption 0.6)."""
    bv, bt = testing.box_room((14.0, 9.0, 11.0))
    sv, st = testing.icosphere(radius=1.5, center=(3.0, -1.0, 2.0),
                               subdivisions=2)
    absorption = np.concatenate([np.full(len(bt), 0.3, np.float32),
                                 np.full(len(st), 0.6, np.float32)])
    return testing.scene_from_arrays(np.vstack([bv, sv]),
                                     np.vstack([bt, st + len(bv)]),
                                     absorption)


def entry(device: torch.device | str = "cuda"):
    """Returns ``(fn, example_args)``: ``fn(sc, generator, emitter,
    receiver_pos, receiver_yaw_deg)`` renders the flagship scene's stereo
    IR [2, 32000] (16 kHz, 16 bounces) on the scene's device."""
    scene = flagship_scene()
    params = TraceParams(sample_rate=16000, ir_length=32000,
                         base_power=3.62, max_bounces=16,
                         hrtf_absorption_rate=0.9)
    opts, _ = tuned.auto_options(scene.n_triangles, params.max_bounces)

    def forward(sc, generator, emitter, receiver_pos, receiver_yaw_deg):
        return render_ir(sc, generator, FLAGSHIP_RAYS, emitter, receiver_pos,
                         receiver_yaw_deg, params, opts)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    example_args = (scene_to_arrays(scene, 128, device=device), gen, EMITTER,
                    RECEIVER, 25.0)
    return forward, example_args


def _train_problem(device):
    """The training step's scene arrays, material slots, parameters and
    options: soft binning through the differentiable tracer, 3 bounces."""
    scene = flagship_scene()
    opts = TracerOptions(backend="autograd", block_size=64, tri_chunk=512,
                         early_exit=False, soft_binning=True, remat=True)
    params = TraceParams(sample_rate=2000, ir_length=2000, base_power=3.62,
                         max_bounces=3)
    sc = scene_to_arrays(scene, opts.tri_chunk, device=device)
    mat_ids = material_ids_padded(scene, sc.absorption.shape[0])
    return sc, mat_ids, len(scene.material_names) + 1, params, opts


def _mse_step(ir_of, sc, mat_ids, n_slots: int):
    """The loss and gradient of the fit's step: the MSE of ``ir_of`` of
    the scene with absorption sigmoid(theta = 0) in every material slot
    against ``ir_of`` of the scene as it is. Returns (loss, theta), its
    ``.grad`` filled."""
    with torch.no_grad():
        target = ir_of(sc)
    theta = torch.zeros(n_slots, device=sc.device, requires_grad=True)
    pred = ir_of(with_material_absorption(sc, mat_ids, torch.sigmoid(theta)))
    loss = torch.mean((pred - target) ** 2)
    loss.backward()
    return loss.detach(), theta


def unsharded_train_gradient(world: int, device: torch.device | str
                             ) -> tuple[float, np.ndarray]:
    """The training step's loss and gradient in one process: every rank's
    directions (``sampling.pose_generator(SEED, r)``) traced together. The
    sharded step must give the same gradient."""
    sc, mat_ids, n_slots, params, opts = _train_problem(device)
    dirs = torch.cat([sampling.sample_directions(
        TRAIN_RAYS, sampling.pose_generator(SEED, r, device), device)
        for r in range(world)])
    loss, theta = _mse_step(lambda s: trace_ir(
        s, dirs, EMITTER, RECEIVER, 0.0, params, opts), sc, mat_ids, n_slots)
    return float(loss), theta.grad.cpu().numpy()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run in every rank of an ``n_devices``-process group (or in one
    process, without a group, for 1): one sharded training step, a sharded
    clustered render and a segment-sharded convolution. ``device``:
    ``"cuda"``, the rank's GPU, or ``"cpu"`` for gloo ranks on the CPU.

    Returns ``{"loss", "grad", "ir_sum", "conv_peak"}``: the training
    loss, the all-reduced gradient of the material logits (before Adam's
    step), the clustered IR's sum and the convolution's peak."""
    mesh = make_ray_mesh(device=None if device == "cuda" else device)
    if mesh.size != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the process group has "
                           f"{mesh.size}")
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    sc, mat_ids, n_slots, params, opts = _train_problem(mesh.device)
    loss, theta = _mse_step(lambda s: render_ir_sharded(
        s, SEED, TRAIN_RAYS * mesh.size, EMITTER, RECEIVER, 0.0, params,
        opts, mesh=mesh), sc, mat_ids, n_slots)
    all_reduce_gradients([theta], mesh)
    grad = theta.grad.detach().clone()
    optimizer = torch.optim.Adam([theta], lr=0.05)
    optimizer.step()
    if not torch.isfinite(loss):
        raise RuntimeError("non-finite training loss")
    if not bool(grad.any()):
        raise RuntimeError("the training step's gradient is zero: no "
                           "reflected ray reached the receiver")
    say(f"dryrun_multichip({n_devices}): one sharded train step ok, "
        f"loss={float(loss):.3e}")

    # The large-scene path under the same mesh: the schedule and K2 on the
    # 1,280-triangle icosphere in clusters of 32, rays sharded.
    v, t = testing.icosphere(radius=6.0, subdivisions=3)
    sorted_scene, clusters = accel.prepare_scene(
        testing.scene_from_arrays(v, t, 0.2), cluster_size=32)
    lsc = scene_to_arrays(sorted_scene, 128, device=mesh.device,
                          clusters=clusters)
    lparams = TraceParams(sample_rate=4000, ir_length=4000, base_power=3.62,
                          max_bounces=3)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(2)
    dirs = sampling.sample_directions(CLUSTER_RAYS * mesh.size, gen,
                                      mesh.device)
    ir = trace_directions_sharded(lsc, dirs, EMITTER, RECEIVER, 0.0, lparams,
                                  TracerOptions(schedule=True), mesh=mesh)
    ir_sum = float(ir.sum())
    if not (bool(torch.isfinite(ir).all()) and ir_sum > 0):
        raise RuntimeError(f"bad clustered IR (sum {ir_sum})")
    say(f"dryrun_multichip({n_devices}): sharded schedule-mode clustered "
        f"render ok, ir_sum={ir_sum:.3e}")

    # The overlap-add with its segments sharded over the same ranks.
    sr = lparams.sample_rate
    sig = np.sin(np.linspace(0, 200.0, 16 * sr)).astype(np.float32)
    out = convolve_file_sharded(sig, ir, sr, mesh=make_segment_mesh(
        mesh.group, mesh.device))
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite sharded convolution")
    peak = float(out.abs().max())
    say(f"dryrun_multichip({n_devices}): segment-sharded convolution ok, "
        f"out_peak={peak:.3e}")
    return {"loss": float(loss), "grad": grad.cpu().numpy(), "ir_sum": ir_sum,
            "conv_peak": peak}


def free_port() -> int:
    """A TCP port free on localhost now, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank,
                     backend="nccl" if device == "cuda" else "gloo")
    try:
        dryrun_multichip(world, device)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default 1 on cuda, 4 on cpu)")
    args = ap.parse_args(argv)
    world = args.world or (1 if args.device == "cuda" else 4)
    fn, example = entry(args.device)  # on the card: builds the kernels once
    out = fn(*example)
    print("entry forward:", tuple(out.shape), float(out.sum()))
    if world == 1:
        dryrun_multichip(1, args.device)
    else:
        torch.multiprocessing.spawn(_rank_main, nprocs=world, args=(
            world, free_port(), args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
