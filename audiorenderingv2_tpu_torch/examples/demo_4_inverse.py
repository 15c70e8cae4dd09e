"""BASELINE config #4: differentiable inverse rendering — fit material
absorption + source pose from a target IR via gradient descent.

The counterpart of ``examples/demo_4_inverse.py``: a 12 x 8 x 10 m box of
absorption 0.35, the source at (0.8, -0.4, 0.6), soft-binned target IRs at
three receivers (2,048 rays, 5 bounces, a 1 s IR at 8 kHz); stage A searches
a 2 m grid of sources (``coarse_emitter_search``), stage B refines
absorption and source jointly by 200 Adam steps of ``fit_scene_parameters``.
It asserts the JAX demo's bars: absorption within 0.08, the source within
0.5 m. The tracer is the differentiable one; on the card its histogram is
K3 and its backward K3-bwd.

Usage: python -m audiorenderingv2_tpu_torch.examples.demo_4_inverse
           [--device cpu] [--steps N]
"""
from __future__ import annotations

import numpy as np
import torch

from .. import testing
from ..core.params import TraceParams
from ..core.tracer import TracerOptions
from ..diff import (coarse_emitter_search, emitter_grid, fit_scene_parameters,
                    render_soft_ir)
from . import parser

TRUE_ABSORPTION = 0.35
TRUE_EMITTER = (0.8, -0.4, 0.6)
N_RAYS = 2048
SEED = 7
STEPS = 200
# A single IR is nearly invariant to source DIRECTION at fixed distance;
# three spread receivers make the pose well-posed (acoustic trilateration).
RECEIVERS = np.array([[2.0, 1.0, -1.5], [-3.0, -1.0, 2.0], [1.0, 2.5, 3.0]],
                     np.float32)
OPTS = TracerOptions(block_size=1024, tri_chunk=128)


def scene():
    v, t = testing.box_room((12.0, 8.0, 10.0))
    return testing.scene_from_arrays(v, t, TRUE_ABSORPTION)


def trace_params() -> TraceParams:
    return TraceParams(sample_rate=8000, ir_length=8000, base_power=3.62,
                       max_bounces=5)


def main(device="cuda", steps: int = STEPS, directions=None) -> dict:
    """Fit and assert. ``steps``: stage B's Adam steps (the JAX demo's 200;
    fewer for a short run). ``directions`` [N, 3]: the fixed direction set
    of every render (default N_RAYS drawn from SEED on ``device``).
    Returns the grid, stage A's best source, the fitted values, the losses
    and the source's error."""
    device = torch.device(device)
    box = scene()
    params = trace_params()
    kw = dict(n_rays=N_RAYS, opts=OPTS, seed=SEED, device=device,
              directions=directions)
    target = torch.stack([
        render_soft_ir(box, params, emitter=TRUE_EMITTER, receiver_pos=r,
                       **kw) for r in RECEIVERS])
    print(f"3 target IRs rendered at absorption={TRUE_ABSORPTION}, "
          f"emitter={TRUE_EMITTER}")

    # Stage A: coarse grid search for the source. The autodiff gradient has
    # fixed path topology (it can't see hit/miss changes), so its convergent
    # basin is ~1 m wide; a 2 m grid lands refinement inside it.
    grid = emitter_grid(box.bounds_min + 1.0, box.bounds_max - 1.0,
                        spacing=2.0)
    best, losses = coarse_emitter_search(
        box, target, params, candidates=grid, receiver_pos=RECEIVERS,
        smooth_radius=32, **kw)
    print(f"stage A: grid of {len(grid)} candidates -> best {best} "
          f"(loss {losses.min():.3e})")

    # Stage B: joint gradient refinement from the grid winner.
    result = fit_scene_parameters(
        box, target, params, steps=steps, learning_rate=0.03,
        fit_absorption=True, fit_emitter=True, smooth_radius=8,
        init_emitter=tuple(best), receiver_pos=RECEIVERS,
        callback=lambda i, loss, _: print(f"  step {i:3d} loss {loss:.3e}")
        if i % 50 == 0 else None, **kw)

    fitted_a = float(result.params["absorption"][-1])
    fitted_e = result.params["emitter"]
    print(f"fitted absorption: {fitted_a:.3f} (true {TRUE_ABSORPTION})")
    print(f"fitted emitter:    {np.round(fitted_e, 3)} (true "
          f"{TRUE_EMITTER})")
    print(f"loss: {result.losses[0]:.3e} -> {result.final_loss:.3e}")
    err = float(np.linalg.norm(fitted_e - np.asarray(TRUE_EMITTER)))
    assert abs(fitted_a - TRUE_ABSORPTION) < 0.08, "absorption off"
    assert err < 0.5, f"emitter off by {err:.2f} m"
    print(f"OK: absorption within 0.08, emitter within {err:.2f} m")
    return {"grid": grid, "best": best, "absorption": fitted_a,
            "emitter": fitted_e, "emitter_err": err,
            "losses": result.losses}


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    main(args.device, args.steps)
