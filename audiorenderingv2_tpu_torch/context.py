"""Application context: config -> loaded scene, audio, renderer.

The counterpart of ``audiorenderingv2_tpu/context.py``: parses the config,
loads the scene and the source audio, and builds the renderer on an
explicit device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .config import Config, load_config
from .core.tracer import TracerOptions
from .io import wav as wav_io
from .renderer import AudioRenderer
from .scene import Scene, load_scene

DEFAULT_LIVE_SAMPLE_RATE = 16000


@dataclass
class AppContext:
    """Everything the export flow needs, built from one config."""

    config: Config
    scene: Scene
    renderer: AudioRenderer
    audio: wav_io.AudioData | None  # None in live-input mode
    volume: float = 1.0
    receiver_pos: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    receiver_yaw_deg: float = 0.0

    @property
    def is_live(self) -> bool:
        return self.audio is None

    @property
    def sample_rate(self) -> int:
        return self.renderer.params.sample_rate


def build_context(config: Config, base_dir: str | Path = ".",
                  opts: TracerOptions | None = None, seed: int = 0,
                  device: torch.device | str = "cuda") -> AppContext:
    """Construct scene, audio and renderer from a parsed config. Relative
    asset paths resolve against ``base_dir``."""
    base = Path(base_dir)

    def resolve(p: str) -> Path:
        path = Path(p)
        return path if path.is_absolute() else base / path

    scene = load_scene(resolve(config.scene.scene_file_path),
                       config.pathtracer.materials)
    audio = None
    sample_rate = DEFAULT_LIVE_SAMPLE_RATE
    if config.scene.audio_file_path:
        audio = wav_io.read_audio(resolve(config.scene.audio_file_path))
        sample_rate = audio.sample_rate

    renderer = AudioRenderer(
        scene,
        ir_seconds=config.renderer.ir_length_in_seconds,
        sample_rate=sample_rate,
        n_rays=config.pathtracer.n_rays,
        base_power=config.pathtracer.base_power,
        energy_threshold=config.pathtracer.ray_energy_threshold,
        max_bounces=config.pathtracer.ray_max_bounces,
        hrtf_absorption_rate=config.pathtracer.hrtf_absorption_rate,
        is_mono=config.scene.mono,
        opts=opts,
        seed=seed,
        band_edges=config.pathtracer.absorption_band_edges,
        device=device,
    )
    renderer.write_ir_to_file_flag = config.renderer.write_first_ir_to_file
    renderer.write_output_to_file_flag = \
        config.renderer.write_first_output_to_file
    renderer.set_emitter_pos(np.asarray(config.scene.initial_emitter_pos,
                                        np.float32))
    receiver_pos = np.asarray(config.scene.initial_receiver_pos, np.float32)
    renderer.set_receiver(receiver_pos, 0.0)
    return AppContext(config=config, scene=scene, renderer=renderer,
                      audio=audio, volume=config.renderer.initial_volume,
                      receiver_pos=receiver_pos, receiver_yaw_deg=0.0)


def load_context(config_path: str | Path, opts: TracerOptions | None = None,
                 seed: int = 0,
                 device: torch.device | str = "cuda") -> AppContext:
    """Load config.json and build the context; paths resolve relative to the
    config file's directory."""
    config_path = Path(config_path)
    return build_context(load_config(config_path), config_path.parent, opts,
                         seed, device)


def export_audio(ctx: AppContext, export_path: str | Path) -> np.ndarray:
    """Render at the initial pose, convolve the source, normalise each
    channel to [-1, 1] and write a stereo WAV (the reference's export mode,
    main.cpp:653-718). Returns the normalised stereo buffer [2, L]."""
    if ctx.audio is None:
        raise RuntimeError("export mode needs an audio file (not live input)")
    out = ctx.renderer.full_render_cycle(
        ctx.receiver_pos, ctx.receiver_yaw_deg, ctx.audio.mono())
    normalized = np.stack([wav_io.normalize_minus_one_to_one(out[0]),
                           wav_io.normalize_minus_one_to_one(out[1])])
    wav_io.write_wav(export_path, normalized, ctx.sample_rate)
    return normalized
