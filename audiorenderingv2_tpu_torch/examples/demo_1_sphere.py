"""BASELINE config #1: sphere scene, single bounce, 10k rays, 16 kHz IR.

The counterpart of ``examples/demo_1_sphere.py``: the icosphere of radius
2.5 m (320 triangles, absorption 0.5), one bounce, 10,000 rays, a 1 s IR at
16 kHz, the receiver at (0.5, 0, 0) with yaw 30. The JAX demo runs its
portable XLA tracer; here the kernels run on the card, their plain versions
on the CPU. Given a WAV (the JAX demo's guitar sample, when present), it
convolves it with the IR.

Usage: python -m audiorenderingv2_tpu_torch.examples.demo_1_sphere
           [--audio in.wav] [--device cpu] [output.wav]
"""
from __future__ import annotations

import numpy as np
import torch

from .. import testing
from ..core.params import TraceParams
from ..core.tracer import TracerOptions, scene_to_arrays, trace_ir
from ..io import wav as wav_io
from ..ops import convolve
from . import parser, seeded_directions

SR = 16000
N_RAYS = 10_000
SEED = 0
EMITTER = np.zeros(3, np.float32)
RECEIVER = np.array([0.5, 0.0, 0.0], np.float32)
YAW = 30.0
OPTS = TracerOptions()


def scene():
    v, t = testing.icosphere(radius=2.5, subdivisions=2)
    return testing.scene_from_arrays(v, t, 0.5)


def trace_params() -> TraceParams:
    return TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                       max_bounces=1)


def main(out_path="demo_sphere.wav", audio_path=None, device="cuda",
         directions=None) -> dict:
    """Render the IR (of ``directions`` [N, 3] if given, else of N_RAYS
    seeded ones) and, with ``audio_path``, write the convolved WAV.
    Returns the printed numbers and the IR [2, SR] on the host."""
    device = torch.device(device)
    sc_scene = scene()
    print(f"scene: {sc_scene.n_triangles} triangles")
    sc = scene_to_arrays(sc_scene, device=device)
    if directions is None:
        directions = seeded_directions(N_RAYS, SEED, device)
    ir_dev = trace_ir(sc, torch.as_tensor(directions).to(device), EMITTER,
                      RECEIVER, YAW, trace_params(), OPTS)
    ir = ir_dev.cpu().numpy()
    nonzero = int((ir != 0).sum())
    print(f"IR: {nonzero} nonzero bins, peak {ir.max():.3e}")
    out = {"n_triangles": sc_scene.n_triangles, "nonzero": nonzero,
           "peak": float(ir.max()), "ir": ir}
    if audio_path is not None:
        audio = wav_io.read_wav(audio_path)
        y = convolve.convolve_file_stereo(audio.mono(), ir_dev,
                                          audio.sample_rate).cpu().numpy()
        y = np.stack([wav_io.normalize_minus_one_to_one(c) for c in y])
        wav_io.write_wav(out_path, y, audio.sample_rate)
        print(f"wrote {out_path} ({y.shape[1] / audio.sample_rate:.1f}s)")
        out["seconds"] = y.shape[1] / audio.sample_rate
    return out


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("out_path", nargs="?", default="demo_sphere.wav")
    ap.add_argument("--audio", default=None,
                    help="a WAV to convolve with the IR")
    args = ap.parse_args()
    main(args.out_path, args.audio, args.device)
