"""BASELINE config #3: full-room scene, 1M rays, 8 bounces, real-time
moving-listener auralization (scripted trajectory + re-render policy).

The counterpart of ``examples/demo_3_realtime.py``, on its fallback scene: a
20 x 10 x 14 m box (absorption 0.25), ``AudioRenderer`` at 1M rays on the
card (50,000 on the CPU, as the JAX demo off the TPU), 8 bounces, a 2 s IR
at 16 kHz, the JAX demo's three-point walk over 10 s and
``ReRenderPolicy(2.0, 5.0)``. It auralizes 10 s of seeded noise and reports
the renders, the wall time and the real-time factor.

The walk is the JAX demo's, kept so that both stay comparable: it starts at
(2.5, 9.9, 0), outside the box (y spans -5..5), so the first renders, until
the receiver sphere reaches the wall near t = 4 s, see an empty IR.

Usage: python -m audiorenderingv2_tpu_torch.examples.demo_3_realtime
           [--device cpu] [walkthrough.wav]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import testing
from ..core.tracer import TracerOptions
from ..io import wav as wav_io
from ..renderer import AudioRenderer
from ..streaming import (Auralizer, ListenerTrajectory, ReRenderPolicy,
                         TrajectoryPoint)
from . import parser

SR = 16000
ROOM = (20.0, 10.0, 14.0)
SECONDS = 10
MAX_BOUNCES = 8
IR_SECONDS = 2
SEED = 0


def scene():
    v, t = testing.box_room(ROOM)
    return testing.scene_from_arrays(v, t, 0.25)


def n_rays(device) -> int:
    return 1_000_000 if torch.device(device).type == "cuda" else 50_000


def trajectory() -> ListenerTrajectory:
    """Walk across the room over 10 s while turning (the JAX demo's)."""
    return ListenerTrajectory([
        TrajectoryPoint(0.0, np.array([2.5, 9.9, 0.0], np.float32), 0.0),
        TrajectoryPoint(5.0, np.array([0.0, 5.0, 2.0], np.float32), 90.0),
        TrajectoryPoint(10.0, np.array([-3.0, 2.0, -2.0], np.float32),
                        200.0),
    ])


def renderer(device, seed: int = SEED) -> AudioRenderer:
    """The demo's renderer: explicit kernel options, as the JAX demo passes
    its backend's; its renders draw their directions in turn from a
    generator seeded with ``seed``."""
    return AudioRenderer(scene(), ir_seconds=IR_SECONDS, sample_rate=SR,
                         n_rays=n_rays(device), base_power=3.62,
                         max_bounces=MAX_BOUNCES, opts=TracerOptions(),
                         seed=seed, device=device)


def main(out_path="demo_walkthrough.wav", device="cuda",
         seed: int = SEED) -> dict:
    """Auralize 10 s along the walk and write the WAV (the renderer's
    directions from ``seed``). Returns the renders, the wall and audio
    seconds, the real-time factor (wall over audio) and the output
    [2, SR * 10]."""
    device = torch.device(device)
    r = renderer(device, seed)
    samples = (np.random.default_rng(0).normal(size=SR * SECONDS)
               * 0.1).astype(np.float32)
    traj = trajectory()
    aur = Auralizer(r, traj,
                    ReRenderPolicy(distance_threshold=2.0,
                                   angle_threshold=5.0))
    # The first cycle builds the kernels and the cuFFT plans (the
    # reference's OptiX pipeline build), so the timing below is steady.
    t0 = time.perf_counter()
    r.full_render_cycle(np.asarray(traj.points[0].position), 0.0, samples)
    startup = time.perf_counter() - t0
    print(f"startup (build + first render): {startup:.1f}s")
    t0 = time.perf_counter()
    out = aur.run(samples)
    wall = time.perf_counter() - t0
    audio_s = len(samples) / SR
    pace = ("REAL-TIME" if wall < audio_s
            else f"{wall / audio_s:.1f}x slower than RT")
    print(f"auralized {audio_s:.1f}s with {aur.renders} IR renders "
          f"({r.n_rays} rays each) in {wall:.1f}s wall -> {pace}")
    peak = np.abs(out).max()
    wav_io.write_wav(out_path, out / peak if peak > 0 else out, SR)
    print(f"wrote {out_path}")
    return {"renders": aur.renders, "n_rays": r.n_rays, "startup_s": startup,
            "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
            "out": out}


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("out_path", nargs="?", default="demo_walkthrough.wav")
    args = ap.parse_args()
    main(args.out_path, args.device)
