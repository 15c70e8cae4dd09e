"""[Copy of audiorenderingv2_tpu/config.py: numpy only, kept equal to it by tests/test_torch_host.py.]

Config schema and loader.

Mirrors the reference's ``config.json`` with its three sections and per-key
silent defaults (reference: prebuild/obj_raytracer/Context.cpp:15-165,
config.json:1-61). Unknown keys are ignored; missing keys fall back to the
same defaults the reference uses. Unlike the reference, unknown keys emit a
``ConfigWarning`` (stderr) so typos — the class of bug in the shipped
reference config, whose material names match nothing in its scenes
(config.json:36-50 vs assets/models/3D_U.mtl:4-24) — are at least visible;
the behavior itself stays reference-identical.
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from . import constants


class ConfigWarning(UserWarning):
    """Non-fatal config lint finding (unknown key / unmatched material)."""


def _warn_unknown_keys(section: str, data: dict, known: set[str]) -> None:
    for k in data:
        if k not in known:
            warnings.warn(
                f"config: unknown key {section}.{k!r} ignored "
                f"(known: {sorted(known)})", ConfigWarning, stacklevel=3)


@dataclass
class MaterialSpec:
    """Named material absorption (reference: Context.cpp:146-163).

    ``mat_absorption`` is a scalar for broadband behavior (the reference's
    model) or a tuple of per-band coefficients for frequency-dependent
    absorption (paired with ``absorption_band_edges``).
    """

    name: str
    mat_absorption: float | tuple


@dataclass
class RendererParams:
    """``renderer_parameters`` section (reference: Context.cpp:17-61)."""

    initial_volume: float = 1.0
    ir_length_in_seconds: int = 2
    width: int = 1366
    height: int = 768
    write_first_ir_to_file: bool = False
    write_first_output_to_file: bool = False
    # The reference round()s both thresholds on load (Context.cpp:55-61).
    re_render_distance_threshold: float = 3.0
    re_render_angle_threshold: float = 5.0


@dataclass
class SceneParams:
    """``scene_parameters`` section (reference: Context.cpp:63-110)."""

    mono: bool = False
    # Empty audio path == live-input mode (reference: Context.cpp:220-223).
    audio_file_path: str = ""
    scene_file_path: str = "assets/models/1D_U.obj"
    materials_file_path: str = ""
    initial_receiver_pos: tuple[float, float, float] = (-2.5, 10.0, 0.0)
    initial_emitter_pos: tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass
class PathtracerParams:
    """``pathtracer_parameters`` section (reference: Context.cpp:112-165).

    ``rays`` is kept as a 3-tuple for config parity with the reference's 3-D
    launch grid; the tracer flattens it to ``n_rays = x*y*z``.
    """

    base_power: float = 100.0
    rays: tuple[int, int, int] = (100, 100, 100)
    ray_energy_threshold: float = 0.0
    ray_max_bounces: int = 10
    # NOTE: the reference round()s this to 0/1 on load (Context.cpp:143-145),
    # a quirk we deliberately do NOT copy — the configured float is used as-is,
    # which is what the device code expects (devicePrograms.cu:126).
    hrtf_absorption_rate: float = constants.DEFAULT_HRTF_ABSORPTION
    materials: list[MaterialSpec] = field(default_factory=list)
    # Crossover frequencies [Hz] for banded absorption; n_bands = len + 1.
    # Only consulted when some material declares per-band coefficients.
    absorption_band_edges: tuple = (250.0, 1000.0, 4000.0)

    @property
    def n_rays(self) -> int:
        x, y, z = self.rays
        return int(x) * int(y) * int(z)

    @property
    def n_bands(self) -> int:
        lens = [len(m.mat_absorption) for m in self.materials
                if isinstance(m.mat_absorption, (tuple, list))]
        return max(lens) if lens else 1


@dataclass
class Config:
    renderer: RendererParams = field(default_factory=RendererParams)
    scene: SceneParams = field(default_factory=SceneParams)
    pathtracer: PathtracerParams = field(default_factory=PathtracerParams)

    @property
    def is_live(self) -> bool:
        return not self.scene.audio_file_path


def _vec3(obj: Any, default: tuple[float, float, float]) -> tuple[float, float, float]:
    if isinstance(obj, dict) and all(k in obj for k in ("x", "y", "z")):
        return (float(obj["x"]), float(obj["y"]), float(obj["z"]))
    if isinstance(obj, (list, tuple)) and len(obj) == 3:
        return tuple(float(v) for v in obj)
    return default


def parse_config(data: dict) -> Config:
    """Build a :class:`Config` from a parsed JSON dict with reference defaults."""
    cfg = Config()
    _warn_unknown_keys("<root>", data, {
        "renderer_parameters", "scene_parameters", "pathtracer_parameters"})

    rp = data.get("renderer_parameters") or {}
    _warn_unknown_keys("renderer_parameters", rp, {
        "initial_volume", "ir_length_in_seconds", "width", "height",
        "write_first_ir_to_file", "write_first_output_to_file",
        "re_render_distance_threshold", "re_render_angle_threshold"})
    r = cfg.renderer
    r.initial_volume = float(rp.get("initial_volume", r.initial_volume))
    r.ir_length_in_seconds = int(round(float(rp.get("ir_length_in_seconds", r.ir_length_in_seconds))))
    r.width = int(round(float(rp.get("width", r.width))))
    r.height = int(round(float(rp.get("height", r.height))))
    r.write_first_ir_to_file = bool(rp.get("write_first_ir_to_file", r.write_first_ir_to_file))
    r.write_first_output_to_file = bool(rp.get("write_first_output_to_file", r.write_first_output_to_file))
    # round() on load mirrors Context.cpp:55-61.
    r.re_render_distance_threshold = float(round(float(rp.get("re_render_distance_threshold", r.re_render_distance_threshold))))
    r.re_render_angle_threshold = float(round(float(rp.get("re_render_angle_threshold", r.re_render_angle_threshold))))

    sp = data.get("scene_parameters") or {}
    _warn_unknown_keys("scene_parameters", sp, {
        "mono", "audio_file_path", "scene_file_path", "materials_file_path",
        "initial_receiver_pos", "initial_emitter_pos"})
    s = cfg.scene
    s.mono = bool(sp.get("mono", s.mono))
    s.audio_file_path = str(sp.get("audio_file_path", s.audio_file_path))
    s.scene_file_path = str(sp.get("scene_file_path", s.scene_file_path))
    # Parsed but unused — faithful to the reference, which reads this key
    # and never consumes it either (SURVEY §5 config note); materials come
    # from the .obj's own mtllib lines + the config material table.
    s.materials_file_path = str(sp.get("materials_file_path", s.materials_file_path))
    s.initial_receiver_pos = _vec3(sp.get("initial_receiver_pos"), s.initial_receiver_pos)
    s.initial_emitter_pos = _vec3(sp.get("initial_emitter_pos"), s.initial_emitter_pos)

    pp = data.get("pathtracer_parameters") or {}
    _warn_unknown_keys("pathtracer_parameters", pp, {
        "base_power", "rays", "ray_energy_threshold", "ray_max_bounces",
        "hrtf_absorption_rate", "materials", "absorption_band_edges",
        # Present in the shipped reference config but never read by the
        # reference either (SURVEY §5): accepted silently for parity.
        "ray_distance_threshold"})
    p = cfg.pathtracer
    p.base_power = float(pp.get("base_power", p.base_power))
    rays = pp.get("rays")
    if isinstance(rays, dict) and all(k in rays for k in ("x", "y", "z")):
        p.rays = (int(rays["x"]), int(rays["y"]), int(rays["z"]))
    elif isinstance(rays, (list, tuple)) and len(rays) == 3:
        # the [x, y, z] list form (the {x,y,z} dict is the reference's
        # shape; silently ignoring a list would trace the 1M default)
        p.rays = tuple(int(r) for r in rays)
    elif rays is not None:
        raise ValueError(f"pathtracer_parameters.rays must be "
                         f"{{x,y,z}} or a 3-list, got {rays!r}")
    p.ray_energy_threshold = float(pp.get("ray_energy_threshold", p.ray_energy_threshold))
    p.ray_max_bounces = int(round(float(pp.get("ray_max_bounces", p.ray_max_bounces))))
    p.hrtf_absorption_rate = float(pp.get("hrtf_absorption_rate", p.hrtf_absorption_rate))
    edges = pp.get("absorption_band_edges")
    if isinstance(edges, list) and edges:
        p.absorption_band_edges = tuple(float(e) for e in edges)
    mats = pp.get("materials")
    if isinstance(mats, list):
        parsed = []
        for m in mats:
            if not (isinstance(m, dict) and "name" in m and "mat_absorption" in m):
                continue
            a = m["mat_absorption"]
            a = tuple(float(x) for x in a) if isinstance(a, list) else float(a)
            parsed.append(MaterialSpec(name=str(m["name"]), mat_absorption=a))
        p.materials = parsed
    n_bands_needed = len(p.absorption_band_edges) + 1
    for m in p.materials:
        if (isinstance(m.mat_absorption, tuple)
                and len(m.mat_absorption) not in (1, n_bands_needed)):
            # Caught here, at load time: a mismatched per-band table would
            # otherwise surface as a cryptic vmap axis error inside the
            # first jitted convolve (the filterbank splits the dry signal
            # into len(edges)+1 bands and zips them against the IR bands).
            raise ValueError(
                f"material {m.name!r} has {len(m.mat_absorption)} absorption "
                f"bands but absorption_band_edges defines {n_bands_needed} "
                f"(len(edges)+1)")
    return cfg


def load_config(path: str | Path) -> Config:
    """Load and parse a config.json file."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_config(json.load(f))
