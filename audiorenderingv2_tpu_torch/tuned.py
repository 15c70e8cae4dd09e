"""Tracer options for a scene: one source of truth for the renderer.

The counterpart of ``audiorenderingv2_tpu/tuned.py:auto_options``. On the
card the trace runs the K1 kernel, on the CPU its plain version: the device
of the scene's tensors picks that, not these options. Every scene size takes
the rows kernel for now. The JAX package sends scenes of 512 triangles and
up through Morton clusters and per-round candidate lists (its K2 kernel);
that path is ROADMAP work (Queue 2, K2). Culling changes only the speed:
the physics is the same over all triangles.

The round split (8, 24, 68) at 100 bounces is the JAX package's setting,
kept so that both packages run the same schedule; it has not been tuned on
the GPU yet.
"""
from __future__ import annotations

from .core.tracer import TracerOptions

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


def auto_options(n_triangles: int, max_bounces: int) -> TracerOptions:
    """Options for a scene of ``n_triangles`` traced to ``max_bounces``.
    The triangle count does not change them yet (see the module doc)."""
    del n_triangles  # one path for every scene size until K2 is ported
    return TracerOptions(round_budgets=round_budgets_for(max_bounces))
