"""Tracer options for a scene: one source of truth for the renderer and
the fit, which prepare their scene through :func:`prepare`.

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

``bench_small_options``, ``bench_large_options`` and
``bench_large_cluster_size`` build the benchmark's configurations with the
``AR2_BENCH_*`` overrides of the JAX package's builders; ``warmup.py``
builds through them, so a warmed configuration is the one a benchmark run
with the same environment builds.
"""
from __future__ import annotations

import os

from . import accel
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


def small_scene_options(max_bounces: int) -> TracerOptions:
    """The rows route: K1 over every triangle row in the 3-round split of
    :func:`round_budgets_for` (the JAX package's ``small_scene_options``,
    whose layout, unroll and RNG knobs tuned the TPU kernel only)."""
    return TracerOptions(round_budgets=round_budgets_for(max_bounces))


def clustered_scene_options() -> TracerOptions:
    """The clustered route: the per-tile schedule and K2, one bounce per
    round (the JAX package's ``clustered_scene_options``; its key layout,
    cell bits, triangle block and visit unroll tuned the TPU only)."""
    return TracerOptions(schedule=True)


def auto_options(n_triangles: int, max_bounces: int
                 ) -> tuple[TracerOptions, int | None]:
    """Options for a scene of ``n_triangles`` traced to ``max_bounces``.

    Returns ``(opts, cluster_size)``: ``cluster_size`` is None for a scene
    that stays unclustered (the rows route, with the 3-round split), else
    the size to pass to ``accel.prepare_scene`` (the clustered route, one
    bounce per round)."""
    if int(n_triangles) >= CLUSTER_THRESHOLD:
        return clustered_scene_options(), CLUSTER_SIZE
    return small_scene_options(max_bounces), None


def prepare(scene, max_bounces: int, opts: TracerOptions | None = None):
    """``(opts, scene, clusters)`` for a renderer or a fit of ``scene``:
    ``opts`` None takes :func:`auto_options`; explicit options of the
    version-2 kernels cluster in ``MANUAL_CLUSTER_SIZE``, as the JAX
    renderer does for manual pallas-v2 options; other options never
    cluster. ``accel.prepare_scene`` Morton-sorts the scene and builds its
    clusters, or leaves a scene under ``CLUSTER_THRESHOLD`` triangles as it
    is (clusters None); pass both to ``core.tracer.scene_to_arrays``."""
    if opts is None:
        opts, cluster_size = auto_options(scene.n_triangles, max_bounces)
    elif opts.backend == "kernels" and opts.version == 2:
        cluster_size = MANUAL_CLUSTER_SIZE
    else:
        cluster_size = None
    if cluster_size is None:
        return opts, scene, None
    return (opts, *accel.prepare_scene(scene, cluster_size=cluster_size))


# ------------------------------------------------------------------------
# The benchmark's configurations, with the JAX package's AR2_BENCH_*
# overrides mapped onto the port's fields (audiorenderingv2_tpu/tuned.py:
# bench_small_options, bench_large_options, bench_large_cluster_size).
# The variables that tuned only the TPU kernels have no field here and are
# ignored, by the rule of ``convert.tracer_options_from_jax``: BLOCK and
# the fixed tri_chunk (the differentiable trace's block sizes, left at the
# port's defaults), TILE, UNROLL, RNG, KEYS, CELL_BITS, TRI_BLOCK,
# SCHED_UNROLL and DIR_SPLIT.

_BACKENDS = {"pallas": "kernels", "xla": "autograd"}


def bench_small_options(env=os.environ) -> TracerOptions:
    """The small-scene (box) benchmark configuration: with no variable set,
    ``auto_options``' rows route at 100 bounces. ``AR2_BENCH_BUDGETS``
    (comma-separated; empty: the default schedule) -> ``round_budgets``;
    ``AR2_BENCH_BACKEND`` ``pallas`` / ``xla`` -> ``kernels`` /
    ``autograd``; ``AR2_BENCH_LAYOUT`` -> ``layout`` (``auto`` is
    ``rows``); ``AR2_BENCH_NATIVE_RNG=1`` -> ``native_rng`` on the kernels
    backend."""
    budgets_env = env.get("AR2_BENCH_BUDGETS", "8,24,68")
    budgets = (tuple(int(b.strip()) for b in budgets_env.split(","))
               if budgets_env.strip() else None)
    backend = env.get("AR2_BENCH_BACKEND", "pallas")
    backend = _BACKENDS.get(backend, backend)  # TracerOptions checks it
    layout = env.get("AR2_BENCH_LAYOUT", "rows")
    return TracerOptions(
        round_budgets=budgets, backend=backend,
        layout={"auto": "rows"}.get(layout, layout),
        native_rng=(backend == "kernels"
                    and env.get("AR2_BENCH_NATIVE_RNG", "0") == "1"))


def bench_large_options(env=os.environ) -> TracerOptions:
    """The large-scene (clustered office) benchmark configuration: with no
    variable set, ``auto_options``' clustered route. ``AR2_BENCH_SCHEDULE``
    (default ``1``) -> ``schedule``; ``0`` runs K5, the traversal inside
    the kernel."""
    return TracerOptions(
        schedule=env.get("AR2_BENCH_SCHEDULE", "1") == "1")


def bench_large_cluster_size(env=os.environ) -> int:
    """The office's cluster size: ``AR2_BENCH_CLUSTER_SIZE``, default
    ``CLUSTER_SIZE``."""
    return int(env.get("AR2_BENCH_CLUSTER_SIZE", CLUSTER_SIZE))
