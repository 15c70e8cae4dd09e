"""Tracer options for a scene: one source of truth for the renderer.

The counterpart of ``audiorenderingv2_tpu/tuned.py:auto_options``. It splits
scenes as the JAX package does: below ``CLUSTER_THRESHOLD`` triangles the
trace runs K1 over every triangle row in rounds of several bounces; at and
above it the scene is Morton-sorted into clusters of ``CLUSTER_SIZE``
triangles and traced one bounce per round through the per-tile schedule and
K2 (``TracerOptions(schedule=True)``; without it a clustered scene runs K5,
the traversal inside the kernel). Culling changes only the speed: the physics is the same over all
triangles. The device of the scene's tensors picks the kernels (CUDA) or
their plain versions (CPU), not these options.

The constants (threshold 512, cluster size 32, the round split (8, 24, 68)
at 100 bounces) are the JAX package's, measured on a TPU and kept so that
both packages run the same path; none has been tuned on the H100 yet.
"""
from __future__ import annotations

from .core.tracer import TracerOptions

CLUSTER_THRESHOLD = 512
CLUSTER_SIZE = 32
MANUAL_CLUSTER_SIZE = 128  # a renderer given explicit kernel options
SMALL_BUDGET_FRACS = (0.08, 0.24)


def round_budgets_for(max_bounces: int) -> tuple | None:
    """The 3-round bounce split, scaled to ``max_bounces``: exactly
    (8, 24, 68) at 100 bounces, proportional with a floor of one bounce per
    round otherwise; None below 6 bounces (the default schedule then)."""
    mb = int(max_bounces)
    if mb < 6:
        return None
    r1 = max(1, int(mb * SMALL_BUDGET_FRACS[0]))
    r2 = max(1, int(mb * SMALL_BUDGET_FRACS[1]))
    return (r1, r2, mb - r1 - r2)


def auto_options(n_triangles: int, max_bounces: int
                 ) -> tuple[TracerOptions, int | None]:
    """Options for a scene of ``n_triangles`` traced to ``max_bounces``.

    Returns ``(opts, cluster_size)``: ``cluster_size`` is None for a scene
    that stays unclustered (the rows route, with the 3-round split), else
    the size to pass to ``accel.prepare_scene`` (the clustered route, one
    bounce per round)."""
    if int(n_triangles) >= CLUSTER_THRESHOLD:
        return TracerOptions(schedule=True), CLUSTER_SIZE
    return TracerOptions(round_budgets=round_budgets_for(max_bounces)), None
