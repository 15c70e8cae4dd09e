"""Command-line entry point.

    python -m audiorenderingv2_tpu_torch <config_path> export [export_path]
        [--device cuda|cpu]
    python -m audiorenderingv2_tpu_torch <config_path> experimentation
        [--rounds N] [--device cuda|cpu] [--layout rows|group]
        [--kernel-version 2|1] [--precision highest|high]

``export`` renders at the initial pose, convolves the source, normalises
and writes a stereo WAV (main.cpp:653-718). ``experimentation`` times
``--rounds`` render + convolve rounds and prints the stage times and the
Monte-Carlo statistics of the IR's peak (main.cpp:531-626,
``experiment.py``). Both run on ``--device`` (CUDA by default: the kernels;
``cpu`` runs their plain versions) and do not fall back from one to the
other.

``--layout``, ``--kernel-version`` and ``--precision`` belong to
``experimentation``, the mode that times a renderer under options its caller
chose. Without them the renderer picks its options from the scene
(``tuned.auto_options``). Any of them makes the options explicit,
``TracerOptions(layout=, version=, precision=)``: an unclustered scene then
runs K1 (``rows``), K6 (``group``, its product at ``--precision``) or K7
(``--kernel-version 1``).

The JAX package's other modes are not ported yet and raise, naming their
ROADMAP.md item.
"""
from __future__ import annotations

import argparse

_NOT_PORTED = {
    "main": "Queue 1 item 10 (streaming: Auralizer, trajectories)",
    "walkthrough": "Queue 1 item 13 (utilities: webview.py)",
}


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
    if args.mode in _NOT_PORTED:
        raise NotImplementedError(
            f"mode {args.mode!r} is not ported to audiorenderingv2_tpu_torch "
            f"yet: ROADMAP.md {_NOT_PORTED[args.mode]}")

    from . import context as ctx_mod

    ctx = ctx_mod.load_context(args.config, opts=opts, device=args.device)

    if args.mode == "export":
        ctx_mod.export_audio(ctx, args.export_path)
        print(f"exported {args.export_path} on {ctx.renderer.device}")
        return 0

    from .experiment import run_experiment

    ctx.renderer.set_receiver(ctx.receiver_pos, ctx.receiver_yaw_deg)
    samples = ctx.audio.mono() if ctx.audio is not None else None
    results = run_experiment(ctx.renderer, samples, rounds=args.rounds)
    print(results.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
