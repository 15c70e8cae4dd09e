"""Command-line entry point.

    python -m audiorenderingv2_tpu_torch <config_path> [main] [export_path]
        [--duration S] [--trajectory traj.json] [--device cuda|cpu]
    python -m audiorenderingv2_tpu_torch <config_path> export [export_path]
        [--device cuda|cpu]
    python -m audiorenderingv2_tpu_torch <config_path> experimentation
        [--rounds N] [--device cuda|cpu] [--layout rows|group]
        [--kernel-version 2|1] [--precision highest|high]
    python -m audiorenderingv2_tpu_torch <config_path> walkthrough
        [out.html] [--embed-audio some.wav]

``main`` (the default) auralizes the source along a listener trajectory:
the one in ``--trajectory`` (JSON of ``times``, ``positions`` and
``yaws_deg``, what the walkthrough page records), or a half orbit of 9 keys
around the emitter; the config's re-render thresholds decide when the IR is
rendered again (main.cpp:470-498, ``streaming.Auralizer``), and the result
is peak-normalised into a stereo WAV. ``export`` renders at the initial
pose, convolves the source, normalises and writes a stereo WAV
(main.cpp:653-718). ``experimentation`` times ``--rounds`` render +
convolve rounds and prints the stage times and the Monte-Carlo statistics
of the IR's peak (main.cpp:531-626, ``experiment.py``). These three run on
``--device`` (CUDA by default: the kernels; ``cpu`` runs their plain
versions) and do not fall back from one to the other. ``walkthrough``
writes an interactive HTML view of the scene (``utils/webview.py``); it
loads the config and the scene only, with no renderer and no device.

``--layout``, ``--kernel-version`` and ``--precision`` belong to
``experimentation``, the mode that times a renderer under options its caller
chose. Without them the renderer picks its options from the scene
(``tuned.auto_options``). Any of them makes the options explicit,
``TracerOptions(layout=, version=, precision=)``: an unclustered scene then
runs K1 (``rows``), K6 (``group``, its product at ``--precision``) or K7
(``--kernel-version 1``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _options(args):
    """Explicit tracer options when the command line names any, else None
    (the renderer then picks them from the scene)."""
    if args.layout is None and args.kernel_version is None \
            and args.precision is None:
        return None
    from .core.tracer import TracerOptions

    return TracerOptions(layout=args.layout or "rows",
                         version=args.kernel_version or 2,
                         precision=args.precision or "highest")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="audiorenderingv2_tpu_torch",
        description="Acoustic renderer on PyTorch + CUDA")
    parser.add_argument("config", help="path to config.json")
    parser.add_argument("mode", nargs="?", default="main",
                        choices=["main", "export", "experimentation",
                                 "walkthrough"])
    parser.add_argument("export_path", nargs="?", default="output.wav")
    parser.add_argument("--rounds", type=int, default=100,
                        help="experimentation rounds (reference: 100)")
    parser.add_argument("--duration", type=float, default=None,
                        help="main mode: seconds of audio to auralize")
    parser.add_argument("--trajectory", default=None,
                        help="main mode: trajectory JSON (times/positions/"
                             "yaws_deg, the walkthrough recorder's export)"
                             " instead of the default orbit")
    parser.add_argument("--embed-audio", default=None,
                        help="walkthrough mode: WAV to embed as a player")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default: cuda)")
    parser.add_argument("--layout", choices=["rows", "group"], default=None,
                        help="triangle layout of an unclustered scene: rows "
                             "(K1) or group (K6)")
    parser.add_argument("--kernel-version", type=int, choices=[1, 2],
                        default=None,
                        help="2, or 1 for the rays-in-rows kernel (K7)")
    parser.add_argument("--precision", choices=["highest", "high"],
                        default=None,
                        help="precision of the group layout's product")
    args = parser.parse_args(argv)

    opts = _options(args)
    if opts is not None and args.mode != "experimentation":
        parser.error("--layout, --kernel-version and --precision belong to "
                     "the experimentation mode")
    if args.mode == "walkthrough":
        return _walkthrough(args)

    from . import context as ctx_mod

    ctx = ctx_mod.load_context(args.config, opts=opts, device=args.device)

    if args.mode == "export":
        ctx_mod.export_audio(ctx, args.export_path)
        print(f"exported {args.export_path} on {ctx.renderer.device}")
        return 0

    if args.mode == "experimentation":
        from .experiment import run_experiment

        ctx.renderer.set_receiver(ctx.receiver_pos, ctx.receiver_yaw_deg)
        samples = ctx.audio.mono() if ctx.audio is not None else None
        results = run_experiment(ctx.renderer, samples, rounds=args.rounds)
        print(results.summary())
        return 0

    return _auralize(ctx, args)


def _walkthrough(args) -> int:
    """Geometry-only export: the config and the scene, no renderer (which
    would put tensors on a device and need the audio file) for an HTML file
    that needs neither."""
    from .config import load_config
    from .scene import load_scene
    from .utils.webview import write_walkthrough_html

    cfg = load_config(args.config)
    scene_path = Path(cfg.scene.scene_file_path)
    if not scene_path.is_absolute():
        scene_path = Path(args.config).parent / scene_path
    scene = load_scene(scene_path, cfg.pathtracer.materials)
    out = args.export_path
    if out == "output.wav":  # mode-appropriate default
        out = "walkthrough.html"
    write_walkthrough_html(scene, out,
                           emitter=cfg.scene.initial_emitter_pos,
                           receiver=cfg.scene.initial_receiver_pos,
                           receiver_yaw_deg=0.0,
                           audio_wav_path=args.embed_audio)
    print(f"walkthrough {out}")
    return 0


def default_trajectory(receiver_pos, emitter_pos, duration: float,
                       n_keys: int = 9) -> list:
    """Half an orbit of ``n_keys`` keys around the emitter from the
    receiver, evenly spaced over ``duration``, the listener facing the
    emitter: ``streaming.TrajectoryPoint``s."""
    from .streaming import TrajectoryPoint

    emitter = np.asarray(emitter_pos, np.float32)
    radius_vec = np.asarray(receiver_pos, np.float32) - emitter
    points = []
    for i in range(n_keys):
        ang = 2.0 * np.pi * i / (n_keys - 1) * 0.5  # half orbit
        c, s = np.cos(ang), np.sin(ang)
        offset = np.array([
            c * radius_vec[0] + s * radius_vec[2],
            radius_vec[1],
            -s * radius_vec[0] + c * radius_vec[2],
        ], np.float32)
        yaw = float(np.degrees(np.arctan2(-offset[2], -offset[0])))
        points.append(TrajectoryPoint(duration * i / (n_keys - 1),
                                      emitter + offset, yaw))
    return points


def _auralize(ctx, args) -> int:
    """The main mode: the source auralized along the trajectory, the policy
    from the config's thresholds, peak-normalised into a WAV."""
    from .io import wav as wav_io
    from .streaming import Auralizer, ListenerTrajectory, ReRenderPolicy

    if ctx.audio is None:
        print("main mode without an audio file (live mode) needs an input "
              "device; use the streaming.LiveConvolver API instead.",
              file=sys.stderr)
        return 1
    samples = ctx.audio.mono()
    if args.duration is not None:
        samples = samples[: int(args.duration * ctx.sample_rate)]
    duration = len(samples) / ctx.sample_rate
    if args.trajectory is not None:
        with open(args.trajectory) as f:
            rec = json.load(f)
        points = ListenerTrajectory.from_arrays(
            rec["times"], rec["positions"], rec["yaws_deg"]).points
    else:
        points = default_trajectory(ctx.receiver_pos,
                                    ctx.config.scene.initial_emitter_pos,
                                    duration)
    policy = ReRenderPolicy(
        distance_threshold=ctx.config.renderer.re_render_distance_threshold,
        angle_threshold=ctx.config.renderer.re_render_angle_threshold)
    aur = Auralizer(ctx.renderer, ListenerTrajectory(points), policy,
                    volume=ctx.volume)
    out = aur.run(samples)
    peak = np.abs(out).max()
    if peak > 0:
        out = out / peak
    wav_io.write_wav(args.export_path, out, ctx.sample_rate)
    print(f"auralized {duration:.1f}s with {aur.renders} IR renders "
          f"-> {args.export_path} on {ctx.renderer.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
