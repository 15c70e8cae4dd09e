"""The benchmark's fixed arithmetic: the card's peaks and the work counts.

Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense, no sparsity): 67 TFLOP/s in float32 outside the tensor cores
and 3.35 TB/s of HBM bandwidth.

A ray-triangle test is 40 float32 operations: the plane and the two
barycentric rows of a triangle dotted with the ray's origin and direction
(6 dot products of 3 terms, 30 operations), the division for t, the two
barycentric coordinates and the three comparisons that accept the hit.
Every implementation of the reference system's trace tests a ray against
each triangle of the box at each bounce, so the box's count is the
reference's ray-bounce steps times its 12 triangles, whatever the program
culls or skips.

A ray's state is 16 float32 values (position, direction, distance, energy,
depth, flags, its event), read once and written once per render.
"""
from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TRI_TEST_OPS = 40
RAY_STATE_BYTES = 16 * 4


def bound_s(ops: float, n_bytes: float) -> float:
    """The least time the card can take: the larger of the operations over
    the float32 peak and the bytes over the HBM peak."""
    return max(ops / FP32_FLOPS, n_bytes / HBM_BYTES_PER_S)


def trace_bound_s(ray_steps: float, n_triangles: int, n_rays: int) -> float:
    """Least time of a brute-force trace: ``ray_steps`` ray-bounce steps,
    each testing ``n_triangles`` triangles, over ``n_rays`` ray states."""
    return bound_s(ray_steps * n_triangles * TRI_TEST_OPS,
                   2.0 * n_rays * RAY_STATE_BYTES)
