"""Test helpers of the port: procedural rooms and the IR comparison bar.

``box_room`` and ``scene_from_arrays`` build the same scenes as the JAX
package's ``testing`` module; ``assert_ir_close`` is its comparison bar.
They live here so that ``chip_smoke.py`` and the card-side checks need
nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

from .io.obj import MeshData
from .scene import Scene, build_scene


def assert_ir_close(a, b, exact: bool = True, rtol: float = 1e-3,
                    atol: float = 5e-7, l1_budget: float = 1e-2) -> None:
    """Compare two IR histograms, exactly or statistically.

    ``exact``: per-bin allclose, for two programs that run the same f32
    arithmetic. Otherwise the statistical bar for two programs whose f32
    rounding differs somewhere: at 100 bounces one ulp can send a ray down
    another path and move a whole deposit to another bin, so the bar holds
    what survives that:

      * per-ear total energy within ``rtol`` (at least 1e-3);
      * relative L1 distance between the histograms below ``l1_budget``.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if exact:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    ea = a.reshape(a.shape[0], -1).sum(axis=1)
    eb = b.reshape(b.shape[0], -1).sum(axis=1)
    np.testing.assert_allclose(ea, eb, rtol=max(rtol, 1e-3), atol=atol)
    denom = np.abs(a).sum()
    assert denom > 0, "empty IR"
    l1 = np.abs(a - b).sum() / denom
    assert l1 < l1_budget, (
        f"relative L1 distance {l1:.3e} exceeds {l1_budget:.1e} "
        f"(more than a few deposits moved bins)")


def box_room(size=(10.0, 10.0, 10.0), center=(0.0, 0.0, 0.0)):
    """A closed axis-aligned box room (12 triangles, normals inward as in
    the JAX package's ``testing.box_room``). Returns (vertices [8, 3],
    triangles [12, 3])."""
    sx, sy, sz = [s / 2.0 for s in size]
    cx, cy, cz = center
    verts = np.array([
        [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
        [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
        [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
        [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz],
    ], np.float32)
    tris = np.array([
        [0, 1, 2], [0, 2, 3],  # z-
        [4, 6, 5], [4, 7, 6],  # z+
        [0, 4, 5], [0, 5, 1],  # y-
        [3, 2, 6], [3, 6, 7],  # y+
        [0, 3, 7], [0, 7, 4],  # x-
        [1, 5, 6], [1, 6, 2],  # x+
    ], np.int32)
    return verts, tris


def scene_from_arrays(vertices, triangles, absorption) -> Scene:
    """A Scene with a uniform or per-triangle absorption."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
    mesh = MeshData(vertices=vertices, triangles=triangles,
                    tri_material=np.full(triangles.shape[0], -1, np.int32),
                    material_names=[])
    absorption = np.asarray(absorption, np.float32)
    if absorption.ndim == 0:
        absorption = np.full(mesh.n_triangles, float(absorption), np.float32)
    return build_scene(mesh, absorption)


def write_box_obj(path, size=(14.0, 9.0, 11.0), material: str = "walls"):
    """Write ``box_room(size)`` as ``path`` (.obj) plus a sibling .mtl that
    names one material. Returns the .obj path."""
    from pathlib import Path

    path = Path(path)
    verts, tris = box_room(size)
    mtl = path.with_suffix(".mtl")
    mtl.write_text(f"newmtl {material}\nKd 0.8 0.8 0.8\n")
    lines = [f"mtllib {mtl.name}", f"usemtl {material}"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")
    return path
