"""Frequency-band filterbank for banded auralization, on ``torch.fft``.

The counterpart of ``audiorenderingv2_tpu/ops/filterbank.py``. A scene with
per-band absorption gives one IR per band; auralization splits the dry
signal into the same bands, convolves each with its IR and sums. The
splitter is a zero-phase FFT-domain filterbank with raised-cosine
crossovers whose gains sum to 1 at every frequency, so the bands sum to the
input. The band axis is a batch axis of one FFT where the JAX package
maps over it.

``band_gains`` is the JAX package's numpy function, copied (that module
imports JAX); ``tests/test_torch_host.py`` pins the copy. On a CPU tensor
``split_bands`` multiplies the spectrum by those gains (``_split_bands``,
the plain version); on a CUDA tensor ``csrc/band_split.cu`` computes the
same float32 gains from their definition on the card and applies them in
one launch (``band_spectra``), so no gain is built on the host or uploaded.

While a profiler records, a banded convolution names its two phases:
``ar2.convolve.split`` (the split: rfft, the band spectra, irfft) and
``ar2.convolve.bands`` (the per-band convolutions and their sum). One band
takes neither.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import profiling
from . import _build, convolve

# Default 4-band octave-style split [Hz] (interior crossover frequencies).
DEFAULT_BAND_EDGES = (250.0, 1000.0, 4000.0)
# Crossovers the band-split kernel takes: its launch parameters hold them.
MAX_KERNEL_EDGES = 31
# The crossovers' fractional width: band_gains' default, which the split
# uses.
TRANSITION = 0.25

band_split_launches = 0


def band_gains(n_freqs: int, sample_rate: int,
               edges=DEFAULT_BAND_EDGES, transition: float = 0.25) -> np.ndarray:
    """Complementary band gains [n_bands, n_freqs] over rfft bins.

    Each crossover is a raised-cosine with ``transition`` fractional width;
    gains sum to 1 at every frequency.
    """
    freqs = np.linspace(0, sample_rate / 2, n_freqs)
    edges = list(edges)
    n_bands = len(edges) + 1
    # lowpass response rolling off around each crossover
    lp = np.ones((len(edges), n_freqs))
    for i, f0 in enumerate(edges):
        width = f0 * transition
        lo, hi = f0 - width, f0 + width
        ramp = np.clip((freqs - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
        lp[i] = 0.5 * (1.0 + np.cos(np.pi * ramp))
    # band b = lp[b] - lp[b-1]; ends are lp[0] and 1 - lp[-1]; sums to 1.
    gains = np.empty((n_bands, n_freqs))
    gains[0] = lp[0]
    for b in range(1, n_bands - 1):
        gains[b] = lp[b] - lp[b - 1]
    gains[n_bands - 1] = 1.0 - lp[-1]
    return gains.astype(np.float32)


def _split_bands(x: torch.Tensor, sample_rate: int,
                 edges=DEFAULT_BAND_EDGES) -> torch.Tensor:
    """The plain version of :func:`split_bands`: the gains built by
    :func:`band_gains` on the host, moved to ``x``'s device and broadcast
    against the spectrum."""
    x = torch.as_tensor(x, dtype=torch.float32)
    spec = torch.fft.rfft(x)
    gains = torch.from_numpy(
        band_gains(spec.shape[0], sample_rate, edges)).to(x.device)
    return torch.fft.irfft(spec[None, :] * gains, n=x.shape[0], dim=-1)


def _kernel_edges(edges) -> tuple:
    """The crossovers as floats, refused where the kernel cannot take
    them."""
    edges = tuple(float(f) for f in edges)
    if not 1 <= len(edges) <= MAX_KERNEL_EDGES:
        raise ValueError(f"the band-split kernel takes 1 to "
                         f"{MAX_KERNEL_EDGES} crossovers, got {len(edges)}")
    return edges


def band_spectra(spec: torch.Tensor, sample_rate: int,
                 edges=DEFAULT_BAND_EDGES) -> torch.Tensor:
    """``spec[None] * band_gains(F, sample_rate, edges)`` for a contiguous
    complex64 CUDA spectrum [F], complex64 [n_bands, F], in one
    launch of ``csrc/band_split.cu``: the gains computed on the card with
    band_gains' float64 arithmetic and float32 rounding."""
    global band_split_launches
    if spec.dtype != torch.complex64 or spec.dim() != 1 \
            or not spec.is_contiguous():
        raise ValueError(f"spec must be a contiguous complex64 [F], got "
                         f"{spec.dtype} {tuple(spec.shape)}")
    edges = _kernel_edges(edges)
    if spec.device.type != "cuda":
        raise ValueError(f"no band-split kernel for device {spec.device}")
    out = torch.empty((len(edges) + 1, spec.shape[0]), dtype=torch.complex64,
                      device=spec.device)
    err = _build.library().ar2_band_split(
        spec.data_ptr(), spec.shape[0], float(sample_rate),
        (ctypes.c_double * len(edges))(*edges), len(edges), TRANSITION,
        out.data_ptr(), _build.stream(spec.device))
    band_split_launches += 1
    _build.check(err, "ar2_band_split")
    return out


def split_bands(x: torch.Tensor, sample_rate: int,
                edges=DEFAULT_BAND_EDGES) -> torch.Tensor:
    """Split a signal [L] into complementary bands f32 [n_bands, L] on its
    device (zero-phase FFT filtering; the bands sum to ``x``). A CPU tensor
    (or array) takes :func:`_split_bands`; any other, cast to float32 as
    there, takes rfft, :func:`band_spectra` and irfft, the same bands with
    no host work."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type == "cpu":
        return _split_bands(x, sample_rate, edges)
    if x.dim() != 1:
        raise ValueError(f"x must be a signal [L], got shape "
                         f"{tuple(x.shape)}")
    edges = _kernel_edges(edges)  # before the rfft is launched
    spec = band_spectra(torch.fft.rfft(x), sample_rate, edges)
    return torch.fft.irfft(spec, n=x.shape[0], dim=-1)


def convolve_file_banded(samples: torch.Tensor, ir_banded: torch.Tensor,
                         sample_rate: int,
                         edges=DEFAULT_BAND_EDGES) -> torch.Tensor:
    """Banded overlap-add auralization: ``ir_banded`` [2, n_bands,
    ir_length] (any leading count C works) -> f32 [C, L] on the IR's
    device. The dry signal is split with the matching filterbank, each band
    is convolved with its band IR (``convolve.convolve_file_multi``) and the
    bands are summed. One band returns ``convolve_file_stereo``'s result."""
    if ir_banded.shape[1] == 1:
        return convolve.convolve_file_stereo(samples, ir_banded[:, 0],
                                             sample_rate)
    samples = torch.as_tensor(samples, dtype=torch.float32,
                              device=ir_banded.device)
    with profiling.span("ar2.convolve.split"):
        bands = split_bands(samples, sample_rate, edges)    # [B, L]
    with profiling.span("ar2.convolve.bands"):
        out = convolve.convolve_file_multi(
            bands, ir_banded.transpose(0, 1), sample_rate)  # [B, C, L]
        return out.sum(dim=0)


def convolve_live_banded(block: torch.Tensor, ir_banded: torch.Tensor,
                         sample_rate: int,
                         edges=DEFAULT_BAND_EDGES) -> torch.Tensor:
    """Banded live-block circular convolution: ``block`` [n] against
    ``ir_banded`` [2, n_bands, n]; returns f32 [2, n]."""
    if ir_banded.shape[1] == 1:
        return convolve.convolve_live(block, ir_banded[:, 0])
    block = torch.as_tensor(block, dtype=torch.float32,
                            device=ir_banded.device)
    with profiling.span("ar2.convolve.split"):
        bands = split_bands(block, sample_rate, edges)      # [B, n]
    with profiling.span("ar2.convolve.bands"):
        spec = torch.fft.rfft(bands, dim=-1)[None] \
            * torch.fft.rfft(ir_banded.to(torch.float32), dim=-1)
        out = torch.fft.irfft(spec, n=block.shape[0], dim=-1) * 2.0
        return out.sum(dim=1)
