"""One rank of a gloo world of the PyTorch port on the CPU, for
tests/test_torch_parallel.py and tests/test_torch_ir_sharding.py.

It imports the port only (never JAX), joins the process group through
``parallel.init_distributed``, runs the sharded entry points of one mode
and writes what it got to ``<out_dir>/<mode>_rank<r>.npz``:

  rays      trace_directions_sharded of 2048 seeded directions,
            render_ir_sharded of 2048 rays, and the sharded gradient of the
            material logits (soft binning, 4 bounces, 512 directions);
  pairs     render_ir_matrix(mesh=) 2 x 2, fused and pair by pair,
            render_ir_sharded of pair 3's seed, and dryrun_multichip(world);
  segments  convolve_file_sharded at the cases of CONV_CASES.

argv: coordinator_address rank world mode out_dir
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent

CONV_SR = 4000
# (signal seconds, IR seconds): tests/test_ir_sharding.py's five cases, a
# signal shorter than a second, and one whole second with a tail.
CONV_CASES = [(16, 2), (16, 4), (9, 2), (8, 3), (16.5, 2), (0.5, 2),
              (1.5, 2)]
BOX = (12.0, 8.0, 10.0)
RECEIVER = np.array([2.0, 0.0, 1.0], np.float32)
MATRIX_EMITTERS = np.array([[0.0, 0.0, 0.0], [-3.0, 1.0, 2.0]], np.float32)
MATRIX_RECEIVERS = np.array([[2.0, 0.0, 1.0], [1.0, -2.0, -3.0]],
                            np.float32)
MATRIX_YAWS = np.array([30.0, -45.0], np.float32)


def unit_dirs(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def conv_signal(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=int(seconds * CONV_SR)).astype(np.float32) * 0.3


def conv_ir(k_seconds, seed=1):
    rng = np.random.default_rng(seed)
    ir = rng.normal(size=(2, k_seconds * CONV_SR)).astype(np.float32)
    return ir * np.exp(-np.linspace(0, 6, k_seconds * CONV_SR))[None, :]


def box_problem():
    """The box of tests/test_sharding.py, its parameters (6 bounces, 1 s IR
    at 16 kHz) and its scene arrays on the CPU."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.core.tracer import scene_to_arrays

    v, t = testing.box_room(BOX)
    scene = testing.scene_from_arrays(v, t, 0.3)
    params = TraceParams(sample_rate=16000, ir_length=16000,
                         base_power=3.62, max_bounces=6)
    return scene, scene_to_arrays(scene, 128, device="cpu"), params


def grad_options():
    """tests/test_sharding.py's gradient options in the port: the
    differentiable tracer, soft binning, blocks of 128."""
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions

    return TracerOptions(backend="autograd", block_size=128, tri_chunk=128,
                         early_exit=False, soft_binning=True)


def material_loss(sc, scene, trace):
    """mean(ir^2) of ``trace(sc with absorption sigmoid(logits))`` and the
    logits (zeros, one slot: the box has no named material)."""
    from audiorenderingv2_tpu_torch.diff import (material_ids_padded,
                                                 with_material_absorption)

    logits = torch.zeros(1, requires_grad=True)
    mat_ids = material_ids_padded(scene, sc.absorption.shape[0])
    ir = trace(with_material_absorption(sc, mat_ids, torch.sigmoid(logits)))
    return torch.mean(ir ** 2), logits


def run_rays(mesh) -> dict:
    import dataclasses

    from audiorenderingv2_tpu_torch.parallel import (render_ir_sharded,
                                                     trace_directions_sharded)
    from audiorenderingv2_tpu_torch.parallel.sharding import \
        all_reduce_gradients

    scene, sc, params = box_problem()
    traced = trace_directions_sharded(sc, unit_dirs(2048, 5), np.zeros(3),
                                      RECEIVER, 20.0, params, mesh=mesh)
    rendered = render_ir_sharded(sc, 5, 2048, np.zeros(3), RECEIVER, 20.0,
                                 params, mesh=mesh)
    p4 = dataclasses.replace(params, max_bounces=4)
    loss, logits = material_loss(sc, scene, lambda s: (
        trace_directions_sharded(s, unit_dirs(512, 3), np.zeros(3), RECEIVER,
                                 0.0, p4, grad_options(), mesh=mesh)))
    loss.backward()
    all_reduce_gradients([logits], mesh)
    return {"traced": traced.numpy(), "rendered": rendered.numpy(),
            "loss": float(loss.detach()), "grad": logits.grad.numpy()}


def run_pairs(mesh) -> dict:
    from audiorenderingv2_tpu_torch import dryrun, multi
    from audiorenderingv2_tpu_torch.core import sampling
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.parallel import render_ir_sharded

    _, sc, params = box_problem()
    opts = TracerOptions(round_budgets=(2, 4))
    args = (sc, 11, MATRIX_EMITTERS, MATRIX_RECEIVERS, MATRIX_YAWS, 512,
            params, opts)
    fused = multi.render_ir_matrix(*args, pair_batch=0, mesh=mesh)
    single = multi.render_ir_matrix(*args, pair_batch=1, mesh=mesh)
    # pair 3 = (source 1, listener 1), rendered alone from its pair seed
    pair3 = render_ir_sharded(sc, sampling.fold_seed(11, 3), 512,
                              MATRIX_EMITTERS[1], MATRIX_RECEIVERS[1],
                              float(MATRIX_YAWS[1]), params, opts, mesh=mesh)
    dry = dryrun.dryrun_multichip(mesh.size, device="cpu")
    return {"fused": fused, "single": single, "pair3": pair3.numpy(),
            "dry_loss": dry["loss"],
            "dry_grad": dry["grad"], "dry_ir_sum": dry["ir_sum"],
            "dry_conv_peak": dry["conv_peak"]}


def run_segments() -> dict:
    from audiorenderingv2_tpu_torch.parallel import (convolve_file_sharded,
                                                     make_segment_mesh)

    mesh = make_segment_mesh(device="cpu")
    return {f"{sig}_{k}": convolve_file_sharded(
        conv_signal(sig), conv_ir(k), CONV_SR, mesh=mesh).numpy()
        for sig, k in CONV_CASES}


def run_world(mode: str, world: int, out_dir, timeout: int = 300) -> list:
    """Start ``world`` rank processes of ``mode`` on a free localhost port,
    wait for them (each within ``timeout`` seconds) and return each rank's
    arrays, rank by rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, __file__, coord, str(r), str(world), mode,
         str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(Path(out_dir) / f"{mode}_rank{r}.npz"))
            for r in range(world)]


def main():
    coord, rank, world, mode, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from audiorenderingv2_tpu_torch.parallel import (init_distributed,
                                                     make_ray_mesh)

    init_distributed(coord, world, rank, backend="gloo")
    try:
        mesh = make_ray_mesh(device="cpu")
        assert (mesh.rank, mesh.size) == (rank, world)
        out = {"rays": run_rays, "pairs": run_pairs,
               "segments": lambda m: run_segments()}[mode](mesh)
        bad = [m for m in sys.modules if m in ("jax", "audiorenderingv2_tpu")
               or m.startswith(("jax.", "audiorenderingv2_tpu."))]
        assert not bad, bad
        np.savez(f"{out_dir}/{mode}_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
