"""[Copy of audiorenderingv2_tpu/io/obj.py: numpy only, kept equal to it by tests/test_torch_host.py.]

Wavefront .obj / .mtl parsing into packed numpy arrays.

Replaces the reference's two C++ OBJ loaders (tiny_obj_loader used by
OptixModel.cpp:75-151 and OBJ_Loader.h used by the GL view) with a single
pure-Python parser that emits flat arrays ready for the TPU tracer: the
tracer wants one packed triangle soup with a per-triangle material id, not
per-(shape, material) mesh objects.

Supported syntax: v, vn, vt, f (polygons fan-triangulated, a/b/c and negative
indices), o/g, usemtl, mtllib, s (ignored). MTL files are parsed for material
names (absorption coefficients come from the renderer config's material
table, matched by name — reference: AudioRenderer.cpp:34-56).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .. import constants


@dataclass
class MeshData:
    """A packed triangle soup.

    Attributes:
      vertices: float32 [V, 3] positions.
      triangles: int32 [T, 3] vertex indices.
      tri_material: int32 [T] index into ``material_names`` (-1 if the face
        had no ``usemtl`` in scope).
      material_names: material name per material id, in first-use order.
      obj_path: source file, for diagnostics.
    """

    vertices: np.ndarray
    triangles: np.ndarray
    tri_material: np.ndarray
    material_names: list[str] = field(default_factory=list)
    obj_path: str = ""

    @property
    def n_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Axis-aligned scene bounds (reference: OptixModel.cpp:145-147)."""
        used = self.vertices[np.unique(self.triangles)]
        return used.min(axis=0), used.max(axis=0)


def _resolve_index(token: str, count: int) -> int:
    """Resolve an obj index token (1-based; negative = from end) to 0-based."""
    idx = int(token)
    return idx - 1 if idx > 0 else count + idx


def parse_mtl(path: str | Path) -> list[str]:
    """Return the material names (``newmtl``) declared in an .mtl file."""
    names: list[str] = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line.startswith("newmtl"):
                    parts = line.split(None, 1)
                    if len(parts) == 2:
                        names.append(parts[1].strip())
    except FileNotFoundError:
        pass
    return names


def load_obj(path: str | Path) -> MeshData:
    """Parse an .obj file into a :class:`MeshData` triangle soup."""
    path = Path(path)
    vertices: list[tuple[float, float, float]] = []
    triangles: list[tuple[int, int, int]] = []
    tri_material: list[int] = []
    material_names: list[str] = []
    material_ids: dict[str, int] = {}
    current_material = -1

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "f" and len(parts) >= 4:
                # Face vertices may be v, v/vt, v//vn, or v/vt/vn.
                idxs = [
                    _resolve_index(tok.split("/")[0], len(vertices))
                    for tok in parts[1:]
                ]
                # Fan triangulation of polygons.
                for k in range(1, len(idxs) - 1):
                    triangles.append((idxs[0], idxs[k], idxs[k + 1]))
                    tri_material.append(current_material)
            elif tag == "usemtl":
                name = line.split(None, 1)[1].strip() if len(parts) > 1 else ""
                if name not in material_ids:
                    material_ids[name] = len(material_names)
                    material_names.append(name)
                current_material = material_ids[name]
            elif tag == "mtllib" and len(parts) > 1:
                # Register declared materials so ids exist even for unused
                # ones. An mtllib line may list SEVERAL libraries
                # (whitespace-separated, valid OBJ); spaces inside one
                # filename are not supported (nor by the reference's
                # tinyobj usage).
                for lib in line.split(None, 1)[1].strip().split():
                    for name in parse_mtl(path.parent / lib):
                        if name not in material_ids:
                            material_ids[name] = len(material_names)
                            material_names.append(name)
            # vn/vt/o/g/s/l ignored — the acoustic tracer only needs geometry;
            # normals are recomputed from winding like the reference does
            # (devicePrograms.cu:75-77 uses the geometric normal, not vn).

    return MeshData(
        vertices=np.asarray(vertices, dtype=np.float32).reshape(-1, 3),
        triangles=np.asarray(triangles, dtype=np.int32).reshape(-1, 3),
        tri_material=np.asarray(tri_material, dtype=np.int32),
        material_names=material_names,
        obj_path=str(path),
    )


def resolve_absorption(
    material_names: list[str],
    materials_cfg: list,
    default: float = constants.DEFAULT_MATERIAL_ABSORPTION,
) -> np.ndarray:
    """Per-material-id absorption from the config's material table.

    Names not present in the table get ``default`` (=0.5), matching the
    reference (AudioRenderer.cpp:47-55). Returns float32 [n_materials + 1]
    (broadband) or [n_materials + 1, n_bands] when any config material
    declares per-band coefficients; scalar materials broadcast across bands.
    The final slot is the absorption for faces with no material (id -1),
    also ``default``.

    Config material names that match NO scene material emit a
    ``ConfigWarning``: the reference stays silent here, which is how its
    shipped config (low/med/high/red/blue) runs every shipped scene
    (Amarillo/Luz/Rojo) at the 0.5 default without anyone noticing. The
    resolution behavior itself is unchanged.
    """
    unmatched = [m.name for m in materials_cfg
                 if m.name not in set(material_names)]
    if unmatched and material_names:
        import warnings

        from ..config import ConfigWarning

        warnings.warn(
            f"config materials {unmatched} match no scene material "
            f"(scene has {material_names}); they fall back to the "
            f"{default} default", ConfigWarning, stacklevel=2)
    lens = [len(m.mat_absorption) for m in materials_cfg
            if isinstance(m.mat_absorption, (tuple, list))]
    n_bands = max(lens) if lens else 1

    def as_bands(a):
        if isinstance(a, (tuple, list)):
            if len(a) != n_bands:
                raise ValueError(
                    f"material with {len(a)} bands in a {n_bands}-band table")
            return np.asarray(a, np.float32)
        return np.full(n_bands, float(a), np.float32)

    table = {m.name: as_bands(m.mat_absorption) for m in materials_cfg}
    out = np.full((len(material_names) + 1, n_bands), default, dtype=np.float32)
    for i, name in enumerate(material_names):
        if name in table:
            out[i] = table[name]
    return out[:, 0] if n_bands == 1 else out


def tri_absorption(mesh: MeshData, materials_cfg: list,
                   default: float = constants.DEFAULT_MATERIAL_ABSORPTION) -> np.ndarray:
    """Per-triangle absorption, float32 [T]."""
    per_mat = resolve_absorption(mesh.material_names, materials_cfg, default)
    # id -1 maps to the final "no material" slot.
    return per_mat[mesh.tri_material]
