"""K3, the IR histogram: sum event weights into bins; and K3-bwd, its
backward pass.

Kernel: ``csrc/histogram.cu`` (CUDA C++, one thread per event, f32
``atomicAdd`` into a device-memory accumulator). It replaces the TPU kernel
``audiorenderingv2_tpu/ops/histogram_pallas.py:_hist_kernel`` (launched by
``_hist_pallas_raw``, :59), which scatters through one-hot matrix
products into an accumulator held in VMEM. What bounds the kernel on the card is the
event read and the atomics the L2 resolves; the 250 KiB stereo accumulator
does not fit a block's shared memory, so it stays in device memory, and
events that are out of range or weigh nothing return before any atomic
(the TPU's sentinel slot would serialise them on one address). More in the
source's header.

K3-bwd (the second entry point of the same source) is the gather
``g_w[e] = g[bins[e]]``, 0 where ``bins[e]`` is out of range: the backward
of the TPU version's custom VJP (``histogram_pallas.py:124-143``). It has no
atomics and equals its plain version, ``histogram_bwd_plain``, bit for bit.
At one band its pace is the gather's: where at least half of ``g`` fits,
each SM's block copies that part into shared memory and gathers it from
there; at 4 and 8 bands a row is a 16-byte gather and store.
``core/binning.py`` joins the two in a ``torch.autograd.Function``.

``histogram_sum_banded`` and ``histogram_bwd`` launch their kernels for a
CUDA tensor and run the plain versions, ``histogram_plain``
(``index_add_``) and ``histogram_bwd_plain``, for a CPU tensor. They never
fall back from one to the other. ``launches`` and ``bwd_launches`` count
kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

# Kernel launches since import (or since a caller reset it to 0).
launches = 0
bwd_launches = 0


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
    err = lib.ar2_histogram(bins.data_ptr(), weights.data_ptr(),
                            bins.shape[0], n_bins, weights.shape[1],
                            out.data_ptr(), _build.stream(bins.device))
    launches += 1
    _build.check(err, "ar2_histogram")
    return out


def histogram_bwd_plain(bins: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3-bwd: ``g`` f32 [n_bins, n_bands] gathered
    at ``bins`` int [E] -> f32 [E, n_bands], rows of zeros where the bin is
    out of range."""
    n_bins = g.shape[0]
    keep = (bins >= 0) & (bins < n_bins)
    rows = g[torch.where(keep, bins, 0).long()]
    return torch.where(keep[:, None], rows, 0.0)


def histogram_bwd(bins: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K3-bwd: the gradient of ``histogram_sum_banded`` with respect to its
    weights, given the gradient ``g`` f32 [n_bins, n_bands] of its result:
    ``g_w[e, b] = g[bins[e], b]``, 0 for an out-of-range bin. Returns f32
    [E, n_bands] on the input's device. The checks read each property once:
    at the gradient path's shapes the host's path into the launch (15-25 us
    beside an H100) takes about as long as the kernel."""
    global bwd_launches
    dev = bins.device
    if bins.dtype != torch.int32 or g.dtype != torch.float32:
        raise TypeError(f"histogram_bwd needs int32 bins and a float32 "
                        f"gradient, got {bins.dtype} and {g.dtype}")
    if bins.dim() != 1 or g.dim() != 2 or not 0 < g.shape[0] < 2**31:
        raise ValueError(f"histogram_bwd needs bins [E] and a gradient "
                         f"[n_bins, n_bands], got {tuple(bins.shape)} and "
                         f"{tuple(g.shape)}")
    if g.device != dev:
        raise ValueError(f"bins on {dev}, gradient on {g.device}")
    if not (bins.is_contiguous() and g.is_contiguous()):
        raise ValueError("histogram_bwd needs contiguous bins and gradient")
    if dev.type == "cpu":
        return histogram_bwd_plain(bins, g)
    if dev.type != "cuda":
        raise ValueError(f"no histogram kernel for device {dev}")
    n_events, (n_bins, n_bands) = bins.shape[0], g.shape
    g_w = g.new_empty((n_events, n_bands))
    err = _build.library().ar2_histogram_bwd(
        bins.data_ptr(), g.data_ptr(), n_events, n_bins, n_bands,
        g_w.data_ptr(), _build.stream(dev))
    bwd_launches += 1
    _build.check(err, "ar2_histogram_bwd")
    return g_w
