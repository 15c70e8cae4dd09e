"""The repository's seven demos on the port.

The counterparts of ``examples/*.py``, which drive the JAX package: demos 1-5
are the five configurations of ``BASELINE.json``, ``demo_6_multipose`` the
fused S x L matrix and its mix, ``demo_live_duplex`` the live path through
the native engine. Each runs as

    python -m audiorenderingv2_tpu_torch.examples.<demo> [--device cpu]

on the card by default (nothing falls back to the CPU when it is missing),
prints the JAX demo's lines, and its ``main(..., device=...)`` returns what
it printed as a dict, for the tests and ``chip_smoke.py``. The scenes are the
JAX demos' procedural fallbacks (a repository holds no reference assets);
each module keeps its scene, pose and parameters at module level so that a
check can trace the same configuration.
"""
from __future__ import annotations

import argparse

import torch

from ..core import sampling


def seeded_directions(n: int, seed: int, device) -> torch.Tensor:
    """``n`` uniform directions on ``device`` from a generator seeded with
    ``seed``: the directions of demos 1 and 2."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return sampling.sample_directions(n, gen, device)


def parser(doc: str) -> argparse.ArgumentParser:
    """A demo's argument parser with ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs the kernels' "
                         "plain versions")
    return ap
