"""[Copy of audiorenderingv2_tpu/accel.py: numpy only, kept equal to it by tests/test_torch_host.py.]

Spatial acceleration: Morton-ordered triangle clusters.

The reference leans on OptiX's hardware BVH (AudioRenderer.cpp:95-218).
Pointer-chasing BVH traversal fights the TPU's vector model, so this module
builds the TPU-shaped equivalent:

  * triangles are sorted by the Morton code of their centroid (spatial
    locality) and grouped into lane-sized clusters of 128,
  * each cluster gets an AABB; the trace kernel slab-tests a ray tile
    against every cluster box (one vector op row per cluster chunk) and
    skips whole 128-triangle chunks that no ray in the tile can reach
    before its current best hit,
  * cluster skipping is predicated (`pl.when` on a per-tile scalar), which
    is exactly what the hardware supports well — no stacks, no pointer
    chasing, bounded depth.

Build is host-side numpy, O(T log T), run once per scene (the receiver is
analytic, so listener movement never rebuilds anything — unlike the
reference's per-move GAS rebuild).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .scene import Scene

CLUSTER_SIZE = 128


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantized coordinates into 30-bit Morton codes."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


def morton_order(centroids: np.ndarray, bounds_min, bounds_max) -> np.ndarray:
    """Permutation sorting points along the Morton curve."""
    span = np.maximum(np.asarray(bounds_max) - np.asarray(bounds_min), 1e-9)
    q = ((centroids - bounds_min) / span * 1023.0).clip(0, 1023).astype(np.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    return np.argsort(codes, kind="stable")


@dataclass
class ClusterData:
    """Per-cluster AABBs, aligned with a cluster-sorted Scene.

    Arrays are float32 [n_clusters]; padding clusters get inverted boxes
    (lo=+inf, hi=-inf) that can never be hit.
    """

    lo_x: np.ndarray
    lo_y: np.ndarray
    lo_z: np.ndarray
    hi_x: np.ndarray
    hi_y: np.ndarray
    hi_z: np.ndarray
    cluster_size: int = CLUSTER_SIZE

    @property
    def n_clusters(self) -> int:
        return int(self.lo_x.shape[0])


def sort_scene_for_clusters(scene: Scene, big_frac: float = 0.25) -> Scene:
    """Reorder a Scene's triangles along the Morton curve (padding stays at
    the tail). Returns a new Scene; histograms/IRs are unaffected because
    triangle order only changes argmin tie-breaks between coincident
    surfaces.

    Triangles whose AABB diagonal exceeds ``big_frac`` of the scene diagonal
    (room walls, floors) are quarantined at the FRONT, in their own leading
    cluster(s): a giant triangle Morton-sorted by centroid would inflate its
    cluster's AABB to near scene size, making that cluster (and its
    supercluster) reachable from everywhere and defeating the culling for
    the 127 small triangles sharing it. Quarantined, only the few leading
    clusters are always-entered; every other cluster stays tight."""
    t = scene.n_triangles
    v0, v1, v2 = scene.v0[:t], scene.v1[:t], scene.v2[:t]
    centroids = (v0 + v1 + v2) / 3.0
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    diag = np.linalg.norm(hi - lo, axis=1)
    scene_diag = float(np.linalg.norm(
        np.asarray(scene.bounds_max) - np.asarray(scene.bounds_min)))
    big = diag > big_frac * max(scene_diag, 1e-9)
    small_idx = np.where(~big)[0]
    big_idx = np.where(big)[0]
    perm = np.concatenate([
        big_idx[np.argsort(-diag[big_idx], kind="stable")],
        small_idx[morton_order(centroids[small_idx], scene.bounds_min,
                               scene.bounds_max)],
    ]).astype(np.int64)
    full = np.concatenate([perm, np.arange(t, scene.t_padded)])

    def take(x):
        return x[full] if isinstance(x, np.ndarray) and x.shape[:1] == (scene.t_padded,) else x

    out = Scene(**{**scene.__dict__})
    for name in ("v0", "v1", "v2", "normal", "plane_n", "plane_d",
                 "bary_u", "bary_v", "absorption", "valid", "tri_material"):
        setattr(out, name, take(getattr(scene, name)))
    return out


def prepare_scene(scene: Scene, min_triangles: int = 512,
                  cluster_size: int = CLUSTER_SIZE):
    """Morton-sort + cluster a scene when it is big enough to benefit.

    ``cluster_size``: triangles per cluster AABB (multiple of 16; the r3
    culling study measured tested-triangles per ray-bounce on the office
    scene dropping 2934 -> 2098 -> 1551 for 128 -> 64 -> 32 with dir72
    compaction keys — smaller clusters mean tighter boxes and finer
    skipping, at the cost of more candidate ids per tile).

    Returns (scene, ClusterData-or-None); pass both to
    ``scene_to_arrays(scene, clusters=...)``."""
    if scene.n_triangles < min_triangles:
        return scene, None
    sorted_scene = sort_scene_for_clusters(scene)
    return sorted_scene, build_clusters(sorted_scene, cluster_size)


def build_clusters(scene: Scene, cluster_size: int = CLUSTER_SIZE) -> ClusterData:
    """AABBs per cluster of ``cluster_size`` consecutive (Morton-sorted)
    triangles. Call on a scene already passed through
    :func:`sort_scene_for_clusters`."""
    t_pad = scene.t_padded
    if t_pad % cluster_size:
        # A floor division here would leave the trailing triangles without
        # a box; downstream the kernel re-derives the cluster size from
        # t_pad // n_clusters and could silently cull against MISALIGNED
        # boxes (rays through uncovered triangles would vanish).
        raise ValueError(f"cluster_size {cluster_size} does not divide the "
                         f"padded triangle count {t_pad}")
    n_clusters = t_pad // cluster_size
    lo = np.full((n_clusters, 3), np.inf, np.float32)
    hi = np.full((n_clusters, 3), -np.inf, np.float32)
    valid = scene.valid > 0
    for c in range(n_clusters):
        sl = slice(c * cluster_size, (c + 1) * cluster_size)
        m = valid[sl]
        if not m.any():
            continue
        pts = np.concatenate([scene.v0[sl][m], scene.v1[sl][m], scene.v2[sl][m]])
        lo[c] = pts.min(axis=0)
        hi[c] = pts.max(axis=0)
    return ClusterData(
        lo_x=lo[:, 0], lo_y=lo[:, 1], lo_z=lo[:, 2],
        hi_x=hi[:, 0], hi_y=hi[:, 1], hi_z=hi[:, 2],
        cluster_size=cluster_size,
    )
