"""Live full-duplex auralization — the reference's microphone path
(audioHandlerWithMic, main.cpp:99-135) with a signal standing in for the mic.

The counterpart of ``examples/demo_live_duplex.py``: a 12 x 9 x 10 m box
(absorption 0.3), ``AudioRenderer`` at 20,000 rays and 8 bounces, a 1 s IR
at 16 kHz, the listener at (3, 1, -2) with yaw 20. Six seconds of seeded
noise (or a WAV) are fed in blocks of 4,096 frames through
``LiveConvolver``; the interleaved output streams through the native engine
(``native/``, built with g++ at first use; its paced pump) into a raw sink,
then is rewritten as a WAV.

Usage: python -m audiorenderingv2_tpu_torch.examples.demo_live_duplex
           [--mic in.wav] [--device cpu] [out.wav]
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import native, testing
from ..io import wav as wav_io
from ..renderer import AudioRenderer
from ..streaming import LiveConvolver
from . import parser

SR = 16000
BLOCK = 4096  # input frames per callback (main.cpp mic path)
SECONDS = 6
RECEIVER = np.array([3.0, 1.0, -2.0], np.float32)
YAW = 20.0


def scene():
    v, t = testing.box_room((12.0, 9.0, 10.0))
    return testing.scene_from_arrays(v, t, 0.3)


def main(out_path="demo_live.wav", mic_path=None, device="cuda",
         seed: int = 0) -> dict:
    """Render the IR (its directions from ``seed``), stream the blocks and
    write the WAV. Returns the frames written, the seconds, whether the
    native engine ran, its streamed frames and underruns, and the output
    [2, frames]."""
    renderer = AudioRenderer(scene(), ir_seconds=1, sample_rate=SR,
                             n_rays=20_000, base_power=3.62, max_bounces=8,
                             seed=seed, device=torch.device(device))
    renderer.set_receiver(RECEIVER, YAW)
    renderer.render()
    print("IR rendered; streaming input blocks through the live path")

    if mic_path is not None:
        mic = wav_io.read_wav(mic_path).mono()[: SR * SECONDS]
    else:
        rng = np.random.default_rng(0)
        mic = (rng.normal(size=SR * SECONDS) * 0.1).astype(np.float32)

    conv = LiveConvolver(renderer, volume=1.0)
    use_native = native.available()
    engine = None
    raw_sink = Path(out_path).with_suffix(".f64")
    if use_native:
        engine = native.NativeAudioEngine(
            str(raw_sink), ring_capacity=1 << 22, sample_rate=SR,
            channels=2, frames_per_buffer=256, realtime=False)

    outputs = []
    n_blocks = len(mic) // BLOCK
    for i in range(n_blocks):
        block_out = conv.process_block(mic[i * BLOCK:(i + 1) * BLOCK])
        outputs.append(block_out)
        if engine is not None:
            engine.add(block_out)
            engine.drain_ticks(BLOCK // 256)

    streamed = underruns = None
    if engine is not None:
        streamed, underruns = engine.frames_streamed, engine.underruns
        print(f"native engine: {streamed} frames streamed, {underruns} "
              f"underruns")
        engine.close()
        data = np.fromfile(raw_sink, dtype="<f8").reshape(-1, 2).T
        raw_sink.unlink()
    else:
        data = np.concatenate(outputs).reshape(-1, 2).T
    peak = np.abs(data).max()
    wav_io.write_wav(out_path, (data / peak if peak > 0 else data)
                     .astype(np.float32), SR)
    print(f"wrote {out_path} ({data.shape[1] / SR:.1f}s, native engine: "
          f"{use_native})")
    return {"frames": data.shape[1], "seconds": data.shape[1] / SR,
            "native": use_native, "frames_streamed": streamed,
            "underruns": underruns, "blocks": n_blocks, "data": data}


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("out_path", nargs="?", default="demo_live.wav")
    ap.add_argument("--mic", default=None,
                    help="a WAV that stands in for the microphone")
    args = ap.parse_args()
    main(args.out_path, args.mic, args.device)
