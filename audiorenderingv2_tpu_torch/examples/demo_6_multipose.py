"""Fused multi-pose rendering + multi-source auralization.

The counterpart of ``examples/demo_6_multipose.py``. The reference renders
one (emitter, receiver) pair per launch; this demo renders the whole 2 x 4
source x listener IR matrix of an 18 x 10 x 14 m box (absorption 0.25, 40
bounces in rounds (8, 32), a 2 s IR at 16 kHz, HRTF absorption 0.9) with
``multi.render_ir_matrix`` at ``pair_batch=8``, one launch per round for all
eight pairs (1M rays a pair on the card, 4,096 on the CPU). Then it mixes a
click train and a tone burst at every listener with ``multi.mix_sources``
and writes one WAV per listener.

Usage: python -m audiorenderingv2_tpu_torch.examples.demo_6_multipose
           [--device cpu] [out_dir]
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .. import multi, testing
from ..core.params import TraceParams
from ..core.tracer import TracerOptions, scene_to_arrays
from ..io import wav as wav_io
from . import parser

SR = 16000
ROOM = (18.0, 10.0, 14.0)
SEED = 0
PAIR_BATCH = 8
OPTS = TracerOptions(round_budgets=(8, 32))
# 2 sources x 4 listeners along a walk line
EMITTERS = np.array([[-5.0, 0.0, -4.0], [6.0, 1.0, 5.0]], np.float32)
LISTENERS = np.stack([np.linspace(-6.0, 6.0, 4), np.zeros(4),
                      np.linspace(4.0, -4.0, 4)], axis=1).astype(np.float32)
YAWS = np.linspace(0.0, 270.0, 4).astype(np.float32)


def scene():
    v, t = testing.box_room(ROOM)
    return testing.scene_from_arrays(v, t, 0.25)


def trace_params() -> TraceParams:
    return TraceParams(sample_rate=SR, ir_length=2 * SR, base_power=3.62,
                       max_bounces=40, hrtf_absorption_rate=0.9)


def n_rays(device) -> int:
    return 1_000_000 if torch.device(device).type == "cuda" else 4096


def dry_signals() -> list:
    """Two dry sources, 2 s each: a click train and a tone burst."""
    tt = np.arange(2 * SR) / SR
    click = (np.sin(2 * np.pi * 6 * tt) > 0.995).astype(np.float32)
    tone = (np.sin(2 * np.pi * 440 * tt)
            * np.exp(-((tt - 0.5) ** 2) / 0.02)).astype(np.float32)
    return [click, tone]


def main(out_dir="demo_multipose", device="cuda", seed: int = SEED) -> dict:
    """Render the matrix (pair ``i`` from ``sampling.pose_generator(seed,
    i)``), mix, write ``listener_<l>.wav`` under ``out_dir``. Returns the
    matrix [2, 4, 2, 32000], the mixes [4, 2, 32000], the WAV paths and
    the matrix's wall seconds."""
    device = torch.device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sc = scene_to_arrays(scene(), 128, device=device)
    rays = n_rays(device)
    t0 = time.perf_counter()
    irs = multi.render_ir_matrix(sc, seed, EMITTERS, LISTENERS, YAWS, rays,
                                 trace_params(), OPTS, pair_batch=PAIR_BATCH)
    wall = time.perf_counter() - t0
    print(f"IR matrix {irs.shape} in {wall:.2f}s ({rays} rays/pair, fused "
          f"pose batches)")

    out = multi.mix_sources(irs, dry_signals(), SR, device=device)
    paths = []
    for li in range(out.shape[0]):
        y = out[li] / max(np.abs(out[li]).max(), 1e-9)
        path = out_dir / f"listener_{li}.wav"
        wav_io.write_wav(path, y, SR)
        print(f"wrote {path}")
        paths.append(path)
    return {"irs": irs, "out": out, "paths": paths, "matrix_s": wall,
            "n_rays": rays}


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("out_dir", nargs="?", default="demo_multipose")
    args = ap.parse_args()
    main(args.out_dir, args.device)
