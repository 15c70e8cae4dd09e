"""IR histogram accumulation by direct summation.

The counterpart of ``audiorenderingv2_tpu/core/binning.py``. A CUDA tensor
goes to the K3 kernel (``ops/histogram_cuda.py``) at any event count; a CPU
tensor to its plain version, ``index_add_``. Both add every deposit straight
into its bin. The JAX package's sort/cumsum path is not ported: its f32
running sum swamps small deposits at millions of events (binning.py:13-20
there).
"""
from __future__ import annotations

import torch

from ..ops import histogram_cuda


def histogram_sum_banded(bins: torch.Tensor, weights: torch.Tensor,
                         n_bins: int) -> torch.Tensor:
    """Sum ``weights`` [E, n_bands] into ``n_bins`` buckets keyed by
    ``bins`` [E]; entries with bin < 0 or bin >= n_bins are dropped.
    Returns f32 [n_bins, n_bands]."""
    bins = bins.reshape(-1)
    if bins.shape[0] != weights.shape[0]:
        raise ValueError(f"{bins.shape[0]} bins but {weights.shape[0]} "
                         f"weight rows")
    return histogram_cuda.histogram_sum_banded(
        bins.to(torch.int32).contiguous(),
        weights.to(torch.float32).contiguous(), n_bins)
