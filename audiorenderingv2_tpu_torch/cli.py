"""Command-line entry point.

    python -m audiorenderingv2_tpu_torch <config_path> export [export_path]
        [--device cuda|cpu]

``export`` renders at the initial pose, convolves the source, normalises
and writes a stereo WAV (main.cpp:653-718). It runs on ``--device`` (CUDA
by default: the kernels; ``cpu`` runs their plain versions) and does not
fall back from one to the other. The JAX package's other modes are not
ported yet and raise, naming their ROADMAP.md item.
"""
from __future__ import annotations

import argparse

_NOT_PORTED = {
    "main": "Queue 1 item 10 (streaming: Auralizer, trajectories)",
    "experimentation": "Queue 1 item 5 (experiment.py)",
    "walkthrough": "Queue 1 item 13 (utilities: webview.py)",
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="audiorenderingv2_tpu_torch",
        description="Acoustic renderer on PyTorch + CUDA")
    parser.add_argument("config", help="path to config.json")
    parser.add_argument("mode", nargs="?", default="main",
                        choices=["main", "export", "experimentation",
                                 "walkthrough"])
    parser.add_argument("export_path", nargs="?", default="output.wav")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default: cuda)")
    args = parser.parse_args(argv)

    if args.mode != "export":
        raise NotImplementedError(
            f"mode {args.mode!r} is not ported to audiorenderingv2_tpu_torch "
            f"yet: ROADMAP.md {_NOT_PORTED[args.mode]}")

    from . import context as ctx_mod

    ctx = ctx_mod.load_context(args.config, device=args.device)
    ctx_mod.export_audio(ctx, args.export_path)
    print(f"exported {args.export_path} on {ctx.renderer.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
