"""BASELINE config #5: multi-source multi-listener scene, rays sharded over
GPUs (16M rays on the card; 16,384 on the CPU).

The counterpart of ``examples/demo_5_sharded.py``: a 24 x 12 x 18 m box
(absorption 0.2) holding an icosphere of radius 2 m at (6, -2, 4)
(absorption 0.7), 332 triangles, 8 bounces, a 2 s IR at 16 kHz. It renders
one pair with ``parallel.render_ir_sharded`` over ``make_ray_mesh()``, then
the 2 x 2 source x listener matrix with ``render_ir_matrix(mesh=)`` at a
sixteenth of the rays a pair. The options are ``tuned.auto_options``' for
the scene: the rows route (K1) in the 3-round split of 8 bounces.

One process is a world of one. Launched under ``torchrun`` (``WORLD_SIZE``
> 1), each process joins the group from torchrun's environment and shards
the rays over the ranks:

    python -m audiorenderingv2_tpu_torch.examples.demo_5_sharded \
        [--device cpu]
    torchrun --nproc-per-node 4 \
        -m audiorenderingv2_tpu_torch.examples.demo_5_sharded
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import multi, testing, tuned
from ..core.params import TraceParams
from ..core.tracer import packed_scene, scene_to_arrays
from ..parallel import make_ray_mesh, render_ir_sharded
from . import parser

SR = 16000
ROOM = (24.0, 12.0, 18.0)
MAX_BOUNCES = 8
IR_SECONDS = 2
SEED = 0
EMITTER = np.zeros(3, np.float32)
RECEIVER = np.array([8.0, 3.0, -5.0], np.float32)
YAW = 30.0
MATRIX_SEED = 1
EMITTERS = np.array([[0.0, 0.0, 0.0], [-6.0, 3.0, 5.0]], np.float32)
LISTENERS = np.array([[8.0, 3.0, -5.0], [2.0, -4.0, 6.0]], np.float32)
YAWS = np.array([30.0, -45.0], np.float32)


def scene():
    """The box and the icosphere, 332 triangles."""
    v, t = testing.box_room(ROOM)
    sv, st = testing.icosphere(radius=2.0, center=(6.0, -2.0, 4.0),
                               subdivisions=2)
    absorption = np.concatenate([np.full(len(t), 0.2, np.float32),
                                 np.full(len(st), 0.7, np.float32)])
    return testing.scene_from_arrays(np.vstack([v, sv]),
                                     np.vstack([t, st + len(v)]), absorption)


def trace_params() -> TraceParams:
    return TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                       base_power=3.62, max_bounces=MAX_BOUNCES)


def setup(device):
    """(scene arrays on ``device``, packed rows, params, options): the
    scene on the rows route, unclustered, as ``tuned.auto_options`` picks
    for its 332 triangles."""
    sc_scene = scene()
    params = trace_params()
    opts, cluster_size = tuned.auto_options(sc_scene.n_triangles,
                                            MAX_BOUNCES)
    assert cluster_size is None  # under CLUSTER_THRESHOLD: the rows route
    sc = scene_to_arrays(sc_scene, 128, device=device)
    rows, _ = packed_scene(sc, params, None, None, opts)
    return sc, rows, params, opts


def total_rays(device) -> int:
    return 16_000_000 if torch.device(device).type == "cuda" else 16_384


def join_torchrun(device) -> None:
    """Join the process group torchrun describes (``env://``), with NCCL on
    the card and gloo on the CPU; a no-op for a single process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")


def main(device="cuda", mesh=None, seed: int = SEED) -> dict:
    """The sharded render and the 2 x 2 matrix over ``mesh`` (default:
    ``make_ray_mesh`` on ``device``, a world of one without a process
    group). The render's rank r draws from ``pose_generator(seed, r)``; the
    matrix from MATRIX_SEED, as the JAX demo's from ``PRNGKey(1)``.
    Returns the world size, the ray counts, the IR [2, 32000] on the rank's
    device, the render's wall seconds (its first call included) and the
    matrix [2, 2, 2, 32000] on the host."""
    device = torch.device(device)
    if mesh is None:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_ray_mesh(device=device)
    print(f"mesh: {mesh.size} x {mesh.device.type} devices")
    sc, rows, params, opts = setup(mesh.device)
    n_rays = (total_rays(mesh.device) // mesh.size) * mesh.size

    # single-pair sharded render + timing
    t0 = time.perf_counter()
    ir = render_ir_sharded(sc, seed, n_rays, EMITTER, RECEIVER, YAW, params,
                           opts, mesh=mesh, rows=rows)
    energy = float(ir.sum())  # waits for the device
    wall = time.perf_counter() - t0
    print(f"sharded render: {n_rays:.2e} rays over {mesh.size} devices "
          f"in {wall:.1f}s (incl. build) -> IR sum {energy:.3e}")

    # multi-source x multi-listener matrix on the same mesh
    pair_rays = max(mesh.size * 256, n_rays // 16)
    pair_rays = (pair_rays // mesh.size) * mesh.size
    irs = multi.render_ir_matrix(sc, MATRIX_SEED, EMITTERS, LISTENERS, YAWS,
                                 pair_rays, params, opts, mesh=mesh,
                                 rows=rows)
    finite = bool(np.isfinite(irs).all())
    print(f"IR matrix {irs.shape} (sources x listeners x ears x bins), "
          f"finite={finite}")
    return {"world": mesh.size, "n_rays": n_rays, "pair_rays": pair_rays,
            "ir": ir, "ir_sum": energy, "wall_s": wall, "irs": irs,
            "finite": finite}


if __name__ == "__main__":
    dev = torch.device(parser(__doc__).parse_args().device)
    join_torchrun(dev)
    try:
        main(dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
