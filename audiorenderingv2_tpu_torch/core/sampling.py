"""Ray direction sampling.

The same uniform-sphere mapping as ``audiorenderingv2_tpu/core/sampling.py``
(theta = 2*pi*u1, cos(phi) = 2*u2 - 1), fed by uniforms from an explicit
``torch.Generator`` (Philox on a CUDA device). The stream differs from
``jax.random``, so tests hand both packages the same numpy directions.
"""
from __future__ import annotations

import math

import torch


def sample_directions(n: int, generator: torch.Generator,
                      device: torch.device | str) -> torch.Tensor:
    """Uniform unit directions, float32 [n, 3], drawn on ``device`` from
    ``generator`` (which must live on the same device)."""
    u = torch.rand((n, 2), generator=generator, device=device,
                   dtype=torch.float32)
    theta = 2.0 * math.pi * u[:, 0]
    cos_phi = 2.0 * u[:, 1] - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    return torch.stack([sin_phi * torch.cos(theta),
                        sin_phi * torch.sin(theta), cos_phi], dim=-1)


def fold_seed(seed: int, index: int) -> int:
    """``seed`` and ``index`` mixed with the splitmix64 finaliser into one
    63-bit seed: the counterpart of ``jax.random.fold_in(key, index)``."""
    mask = (1 << 64) - 1
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z ^= z >> 31
    return z >> 1


def pose_generator(seed: int, index: int, device: torch.device | str,
                   rank: int | None = None) -> torch.Generator:
    """The generator of pose (or pair, or rank) ``index`` under ``seed``,
    on ``device``, seeded with ``fold_seed(seed, index)``, so the fused
    pose batch, a per-pair loop and a single render of one pair all draw
    the same directions for it. With ``rank``: that rank's share of the
    pose when its rays are sharded over ranks, seeded with
    ``fold_seed(fold_seed(seed, index), rank)`` (the pose first, then the
    rank, as the JAX package folds the pair's key and then the axis
    index), which is the stream ``parallel.render_ir_sharded`` of the
    pose's seed ``fold_seed(seed, index)`` draws on that rank."""
    if rank is not None:
        seed, index = fold_seed(seed, index), rank
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, index))
    return gen
