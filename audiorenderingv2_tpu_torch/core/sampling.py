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
