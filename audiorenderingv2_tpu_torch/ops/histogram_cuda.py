"""K3, the IR histogram: sum event weights into bins.

Kernel: ``csrc/histogram.cu`` (CUDA C++, one thread per event, f32
``atomicAdd`` into a device-memory accumulator). It replaces the TPU kernel
``audiorenderingv2_tpu/ops/histogram_pallas.py:_hist_kernel`` (launched by
``_hist_pallas_raw``, :59), which scatters through one-hot matrix
products into an accumulator held in VMEM. What bounds the kernel on the card is the
event read and the atomics the L2 resolves; the 250 KiB stereo accumulator
does not fit a block's shared memory, so it stays in device memory, and
events that are out of range or weigh nothing return before any atomic
(the TPU's sentinel slot would serialise them on one address). More in the
source's header. Forward only: the gather backward of the TPU version's
custom VJP is ROADMAP work.

``histogram_sum_banded`` launches the kernel for a CUDA tensor and runs the
plain version, ``histogram_plain`` (``index_add_``), for a CPU tensor. It
never falls back from one to the other. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def histogram_plain(bins: torch.Tensor, weights: torch.Tensor,
                    n_bins: int) -> torch.Tensor:
    """Plain PyTorch version: direct ``index_add_`` accumulation.

    bins int [E], weights f32 [E, n_bands] -> f32 [n_bins, n_bands]; events
    with bin < 0 or bin >= n_bins are dropped."""
    keep = (bins >= 0) & (bins < n_bins)
    out = torch.zeros((n_bins, weights.shape[1]), dtype=torch.float32,
                      device=weights.device)
    return out.index_add_(0, bins[keep].long(), weights[keep])


def _check(bins: torch.Tensor, weights: torch.Tensor, n_bins: int) -> None:
    if bins.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"histogram needs int32 bins and float32 weights, "
                        f"got {bins.dtype} and {weights.dtype}")
    if bins.dim() != 1 or weights.dim() != 2 or \
            bins.shape[0] != weights.shape[0]:
        raise ValueError(f"histogram needs bins [E] and weights [E, n_bands],"
                         f" got {tuple(bins.shape)} and "
                         f"{tuple(weights.shape)}")
    if bins.device != weights.device:
        raise ValueError(f"bins on {bins.device}, weights on "
                         f"{weights.device}")
    if not (bins.is_contiguous() and weights.is_contiguous()):
        raise ValueError("histogram needs contiguous bins and weights")
    if not 0 < n_bins < 2**31:
        raise ValueError(f"n_bins={n_bins} out of the int32 range")


def histogram_sum_banded(bins: torch.Tensor, weights: torch.Tensor,
                         n_bins: int) -> torch.Tensor:
    """Sum ``weights`` [E, n_bands] into ``n_bins`` bins keyed by int32
    ``bins`` [E]; out-of-range events are dropped. Returns f32
    [n_bins, n_bands] on the input's device."""
    global launches
    _check(bins, weights, n_bins)
    if bins.device.type == "cpu":
        return histogram_plain(bins, weights, n_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {bins.device}")
    lib = _build.library()
    out = torch.zeros((n_bins, weights.shape[1]), dtype=torch.float32,
                      device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    err = lib.ar2_histogram(bins.data_ptr(), weights.data_ptr(),
                            bins.shape[0], n_bins, weights.shape[1],
                            out.data_ptr(), stream)
    launches += 1
    _build.check(err, "ar2_histogram")
    return out
