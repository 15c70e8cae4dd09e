"""Test helpers of the port: procedural rooms and the IR comparison bar.

``box_room``, ``icosphere``, ``quad``, ``mesh_from_arrays`` and
``scene_from_arrays`` build the same meshes and scenes as the JAX package's
``testing`` module, and ``office_scene`` the large scene of
``benchmarks/large_scene.py``; ``assert_ir_close`` is its comparison bar.
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


def quad(center, u_axis, v_axis):
    """Two triangles spanning center +- u_axis +- v_axis.

    Returns (vertices [4, 3], triangles [2, 3])."""
    c = np.asarray(center, np.float32)
    u = np.asarray(u_axis, np.float32)
    v = np.asarray(v_axis, np.float32)
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, tris


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


def icosphere(radius=1.0, center=(0.0, 0.0, 0.0), subdivisions=2):
    """Subdivided icosahedron. Returns (vertices, triangles)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]
    cache: dict = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = np.add(verts[i], verts[j]) / 2.0
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, np.float32) * radius + np.asarray(center, np.float32)
    return v, np.asarray(faces, np.int32)


def office_mesh(n_tris_target: int):
    """The office of ``benchmarks/large_scene.py``: a 40 x 12 x 40 m box
    room and a grid of radius-0.9 icospheres (320 triangles each) at seeded
    heights, about ``n_tris_target`` triangles in all. Returns (vertices,
    triangles)."""
    room = (40.0, 12.0, 40.0)
    bv, bt = box_room(room)
    verts = [bv]
    tris = [bt]
    base = len(bv)
    rng = np.random.default_rng(7)
    k = max(1, (n_tris_target - len(bt)) // 320)
    side = int(np.ceil(np.sqrt(k)))
    i = 0
    for gx in range(side):
        for gz in range(side):
            if i >= k:
                break
            cx = -room[0] / 2 + (gx + 0.5) * room[0] / side
            cz = -room[2] / 2 + (gz + 0.5) * room[2] / side
            cy = rng.uniform(-room[1] / 2 + 1.5, room[1] / 2 - 1.5)
            sv, st = icosphere(radius=0.9, center=(cx, cy, cz),
                               subdivisions=2)
            verts.append(sv)
            tris.append(st + base)
            base += len(sv)
            i += 1
    return np.vstack(verts), np.vstack(tris)


def office_scene(n_tris_target: int) -> Scene:
    """``office_mesh`` as a Scene with absorption 0.3 everywhere
    (``benchmarks/large_scene.py:office_scene``)."""
    v, t = office_mesh(n_tris_target)
    return scene_from_arrays(v, t, np.full(len(t), 0.3, np.float32))


def mesh_from_arrays(vertices, triangles, tri_material=None,
                     material_names=None) -> MeshData:
    """A MeshData of ``vertices`` [V, 3] and ``triangles`` [T, 3]; every
    triangle of material -1 (the default absorption) unless
    ``tri_material`` [T] says otherwise."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
    if tri_material is None:
        tri_material = np.full(triangles.shape[0], -1, np.int32)
    return MeshData(
        vertices=vertices,
        triangles=triangles,
        tri_material=np.asarray(tri_material, np.int32),
        material_names=list(material_names or []),
    )


def scene_from_arrays(vertices, triangles, absorption) -> Scene:
    """A Scene with a uniform or per-triangle absorption."""
    mesh = mesh_from_arrays(vertices, triangles)
    absorption = np.asarray(absorption, np.float32)
    if absorption.ndim == 0:
        absorption = np.full(mesh.n_triangles, float(absorption), np.float32)
    return build_scene(mesh, absorption)


def write_obj(path, vertices, triangles, material: str = "walls"):
    """Write a triangle mesh as ``path`` (.obj) plus a sibling .mtl that
    names one material. Returns the .obj path."""
    from pathlib import Path

    path = Path(path)
    mtl = path.with_suffix(".mtl")
    mtl.write_text(f"newmtl {material}\nKd 0.8 0.8 0.8\n")
    lines = [f"mtllib {mtl.name}", f"usemtl {material}"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in vertices]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in triangles]
    path.write_text("\n".join(lines) + "\n")
    return path


def write_box_obj(path, size=(14.0, 9.0, 11.0), material: str = "walls"):
    """Write ``box_room(size)`` with :func:`write_obj`."""
    return write_obj(path, *box_room(size), material=material)
