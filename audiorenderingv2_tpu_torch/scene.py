"""[Copy of audiorenderingv2_tpu/scene.py: numpy only, kept equal to it by tests/test_torch_host.py.]

Scene representation: packed, TPU-friendly triangle arrays.

The reference keeps per-(shape, material) mesh objects and rebuilds an OptiX
GAS whenever geometry changes (OptixModel.cpp:37-141, AudioRenderer.cpp:95-218).
Here a scene is a set of flat arrays, padded to a lane-aligned triangle count,
with intersection quantities precomputed once per scene:

* Baldwin–Weber-style plane + barycentric rows reduce the per-(ray,
  triangle) Möller–Trumbore test to six broadcast dot products plus
  elementwise math — uniform vector work with no per-pair cross products
  (see core/tracer.py for why these stay off the MXU's default precision).
* The receiver (listener head) is NOT geometry. The reference re-tessellates
  two hemisphere meshes into the scene and rebuilds the BVH on every listener
  move (OptixModel.cpp:153-257); here the receiver is an analytic sphere test
  parameterized by (center, yaw), which makes listener pose a differentiable
  input and makes re-render after movement free of any geometry rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .io import obj as obj_io

_LANE = 128


def _pad_axis0(x: np.ndarray, n: int, value=0) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, width, constant_values=value)


@dataclass
class Scene:
    """Packed scene arrays. All arrays are padded to ``t_padded`` triangles;
    padding triangles have ``normal=0`` so their plane test never produces a
    finite hit time.

    Shapes (float32 unless noted):
      v0/v1/v2:    [T, 3]  triangle vertices (v1/v2 kept for the CPU oracle
                           and for BVH construction)
      normal:      [T, 3]  geometric normal, UNIT length (devicePrograms.cu:75-77)
      plane_n:     [T, 3]  unnormalized normal e1 x e2 (plane equation row)
      plane_d:     [T]     plane offset, -plane_n . v0
      bary_u:      [T, 3]  row a_u: u(P) = (P - v0) . a_u for P on the plane
      bary_v:      [T, 3]  row a_v
      absorption:  [T]     per-triangle material absorption
      valid:       [T]     1.0 for real triangles, 0.0 for padding/degenerate
      n_triangles: real triangle count (int)
    """

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    normal: np.ndarray
    plane_n: np.ndarray
    plane_d: np.ndarray
    bary_u: np.ndarray
    bary_v: np.ndarray
    absorption: np.ndarray
    valid: np.ndarray
    n_triangles: int
    material_names: list
    tri_material: np.ndarray
    bounds_min: np.ndarray
    bounds_max: np.ndarray

    @property
    def t_padded(self) -> int:
        return int(self.v0.shape[0])

    def with_absorption(self, per_material: np.ndarray) -> "Scene":
        """Rebuild the per-triangle absorption from a per-material table
        (float [n_materials + 1], last slot = faces without material).
        Used by the differentiable path so absorption can be a traced value."""
        tri_abs = np.asarray(per_material)[self.tri_material]
        tri_abs = _pad_axis0(tri_abs.astype(np.float32), self.t_padded)
        out = Scene(**{**self.__dict__})
        out.absorption = tri_abs
        return out


def build_scene(mesh: obj_io.MeshData, tri_absorption: np.ndarray,
                pad_to_multiple: int = _LANE) -> Scene:
    """Precompute intersection arrays from a triangle soup.

    ``tri_absorption``: float [T] per-triangle absorption (see
    :func:`audiorenderingv2_tpu.io.obj.tri_absorption`).
    """
    v = mesh.vertices.astype(np.float64)
    tris = mesh.triangles
    t_real = tris.shape[0]

    p0 = v[tris[:, 0]]
    p1 = v[tris[:, 1]]
    p2 = v[tris[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0

    n = np.cross(e1, e2)  # unnormalized plane normal
    n_len = np.linalg.norm(n, axis=1)
    # Threshold aligned with the barycentric inv_det cutoff below
    # (det_g == n_len^2, so 1e-30 there is n_len 1e-15): a sliver in
    # between would keep valid=1 with zeroed bary rows, i.e. u=v=0
    # passes the inside test EVERYWHERE on its infinite plane.
    degenerate = n_len < 1e-15
    unit_n = np.where(degenerate[:, None], 0.0, n / np.maximum(n_len, 1e-30)[:, None])

    # Barycentric rows from the Gram matrix of (e1, e2):
    #   [u; v] = G^-1 [e1.(P-v0); e2.(P-v0)],  G = [[e1.e1, e1.e2], [e1.e2, e2.e2]]
    a = np.einsum("ij,ij->i", e1, e1)
    b = np.einsum("ij,ij->i", e1, e2)
    c = np.einsum("ij,ij->i", e2, e2)
    det_g = a * c - b * b
    inv_det = np.where(np.abs(det_g) < 1e-30, 0.0, 1.0 / np.where(det_g == 0, 1.0, det_g))
    a_u = (c[:, None] * e1 - b[:, None] * e2) * inv_det[:, None]
    a_v = (a[:, None] * e2 - b[:, None] * e1) * inv_det[:, None]

    plane_n = np.where(degenerate[:, None], 0.0, n)
    plane_d = -np.einsum("ij,ij->i", plane_n, p0)

    t_padded = max(pad_to_multiple,
                   ((t_real + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple)
    valid = np.zeros(t_padded, dtype=np.float32)
    valid[:t_real] = (~degenerate).astype(np.float32)

    f32 = lambda x: _pad_axis0(np.asarray(x, dtype=np.float32), t_padded)
    bmin, bmax = mesh.bounds() if t_real else (np.zeros(3), np.zeros(3))

    return Scene(
        v0=f32(p0),
        v1=f32(p1),
        v2=f32(p2),
        normal=f32(unit_n),
        plane_n=f32(plane_n),
        plane_d=f32(plane_d),
        bary_u=f32(a_u),
        bary_v=f32(a_v),
        absorption=f32(tri_absorption),
        valid=valid,
        n_triangles=t_real,
        material_names=list(mesh.material_names),
        tri_material=_pad_axis0(mesh.tri_material, t_padded, value=-1),
        bounds_min=np.asarray(bmin, dtype=np.float32),
        bounds_max=np.asarray(bmax, dtype=np.float32),
    )


def load_scene(obj_path: str | Path, materials_cfg: list | None = None,
               pad_to_multiple: int = _LANE) -> Scene:
    """Load an .obj scene and resolve material absorptions from the config
    material table (name-matched, 0.5 default — AudioRenderer.cpp:34-56)."""
    mesh = obj_io.load_obj(obj_path)
    tri_abs = obj_io.tri_absorption(mesh, materials_cfg or [])
    return build_scene(mesh, tri_abs, pad_to_multiple)
