"""BASELINE config #2: 3 bounces, 100k rays, frequency-dependent absorption
(4 bands).

The counterpart of ``examples/demo_2_banded.py``, on its fallback scene: an
icosphere of radius 3 m (1,280 triangles, built through
``testing.mesh_from_arrays``) with concrete-like absorption per band
(0.05, 0.15, 0.4, 0.7), 3 bounces, 100,000 rays, a 1 s IR at 16 kHz, the
receiver at (1.2, 0.3, 0) with yaw 0. It prints each band's energy and the
late/early energy ratio. The scene is unclustered, so the trace runs K1 over
its 1,280 rows in chunks.

Usage: python -m audiorenderingv2_tpu_torch.examples.demo_2_banded
           [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from .. import testing
from ..core.params import TraceParams
from ..core.tracer import TracerOptions, scene_to_arrays, trace_ir
from ..scene import build_scene
from . import parser, seeded_directions

SR = 16000
N_RAYS = 100_000
SEED = 0
# Concrete-like: reflective lows, absorbent highs.
BAND_ABSORPTION = np.array([0.05, 0.15, 0.4, 0.7], np.float32)
EMITTER = np.zeros(3, np.float32)
RECEIVER = np.array([1.2, 0.3, 0.0], np.float32)
YAW = 0.0
OPTS = TracerOptions()


def scene():
    v, t = testing.icosphere(radius=3.0, subdivisions=3)
    mesh = testing.mesh_from_arrays(v, t)
    return build_scene(mesh, np.tile(BAND_ABSORPTION, (mesh.n_triangles, 1)))


def trace_params() -> TraceParams:
    return TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                       max_bounces=3, n_bands=len(BAND_ABSORPTION))


def main(device="cuda", directions=None) -> dict:
    """Render the banded IR (of ``directions`` [N, 3] if given, else of
    N_RAYS seeded ones). Returns the printed numbers and the IR
    [2, 4, SR] on the host."""
    device = torch.device(device)
    sc_scene = scene()
    print(f"scene: {sc_scene.n_triangles} triangles, "
          f"{len(BAND_ABSORPTION)} absorption bands")
    sc = scene_to_arrays(sc_scene, device=device)
    if directions is None:
        directions = seeded_directions(N_RAYS, SEED, device)
    ir = trace_ir(sc, torch.as_tensor(directions).to(device), EMITTER,
                  RECEIVER, YAW, trace_params(), OPTS).cpu().numpy()
    print(f"banded IR {ir.shape}; per-band energy:")
    energy = ir.sum(axis=(0, 2))
    for b, e in enumerate(energy):
        print(f"  band {b} (absorption {BAND_ABSORPTION[b]}): {e:.4e}")
    # reverberation decays faster in the absorbent bands
    late = ir[:, :, SR // 2:].sum(axis=(0, 2))
    early = ir[:, :, :SR // 2].sum(axis=(0, 2)) + 1e-12
    ratio = late / early
    print("late/early ratio per band:", np.round(ratio, 4))
    return {"n_triangles": sc_scene.n_triangles, "band_energy": energy,
            "late_early": ratio, "ir": ir}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
