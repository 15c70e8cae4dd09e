"""IR histogram accumulation by direct summation.

The counterpart of ``audiorenderingv2_tpu/core/binning.py``. A CUDA tensor
goes to the K3 kernel (``ops/histogram_cuda.py``) at any event count; a CPU
tensor to its plain version, ``index_add_``. Both add every deposit straight
into its bin. The JAX package's sort/cumsum path is not ported: its f32
running sum swamps small deposits at millions of events (binning.py:13-20
there).

``histogram_sum_banded`` is differentiable in the weights: a
``torch.autograd.Function`` whose forward is K3 and whose backward is K3-bwd,
the gather ``g_w[e] = g[bins[e]]`` (the JAX package's custom VJP,
``ops/histogram_pallas.py:124-143``). On a CPU tensor both run their plain
versions. The bins are integers and get no gradient; delay gradients reach
the arrival time through the soft-binning fractions, which are part of the
weights (``core/tracer.py:_soft_flat_bins``).
"""
from __future__ import annotations

import torch

from ..ops import histogram_cuda


class _HistogramSum(torch.autograd.Function):
    """K3 forward, K3-bwd backward. ``bins`` int32 [E] and ``weights`` f32
    [E, n_bands] are contiguous."""

    @staticmethod
    def forward(ctx, bins, weights, n_bins):
        ctx.save_for_backward(bins)
        return histogram_cuda.histogram_sum_banded(bins, weights, n_bins)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # Autograd hands over whatever layout the loss made (``.sum()``
        # gives an expanded tensor of stride 0): the kernel reads a dense
        # f32 [n_bins, n_bands]. This runs on autograd's thread, where the
        # wrapper takes the device's current stream, as the forward does.
        (bins,) = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        return None, histogram_cuda.histogram_bwd(bins, g), None


def histogram_sum(bins: torch.Tensor, weights: torch.Tensor,
                  n_bins: int) -> torch.Tensor:
    """Sum ``weights`` into ``n_bins`` buckets keyed by integer ``bins``.

    ``bins`` and ``weights`` may have any (equal) shape; they are
    flattened. Entries with bin < 0 or bin >= n_bins are dropped. Returns
    f32 [n_bins]; gradients flow to ``weights``. The one-band case of
    :func:`histogram_sum_banded`, through the same Function (K3 forward,
    K3-bwd backward on the card), so there is one implementation."""
    return histogram_sum_banded(bins.reshape(-1), weights.reshape(-1, 1),
                                n_bins)[:, 0]


def histogram_sum_banded(bins: torch.Tensor, weights: torch.Tensor,
                         n_bins: int) -> torch.Tensor:
    """Sum ``weights`` [E, n_bands] into ``n_bins`` buckets keyed by
    ``bins`` [E]; entries with bin < 0 or bin >= n_bins are dropped.
    Returns f32 [n_bins, n_bands]; gradients flow to ``weights``."""
    bins = bins.reshape(-1)
    if bins.shape[0] != weights.shape[0]:
        raise ValueError(f"{bins.shape[0]} bins but {weights.shape[0]} "
                         f"weight rows")
    return _HistogramSum.apply(bins.to(torch.int32).contiguous(),
                               weights.to(torch.float32).contiguous(),
                               n_bins)
