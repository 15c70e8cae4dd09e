"""K3, the IR histogram: sum event weights into bins; the hard-binning
stage of the tracer in one launch; and K3-bwd, the histogram's backward
pass.

Kernel: ``csrc/histogram.cu`` (CUDA C++, f32 atomics into a device-memory
accumulator that the C entry zero-fills on the stream). It replaces the
TPU kernel ``audiorenderingv2_tpu/ops/histogram_pallas.py:_hist_kernel``
(launched by ``_hist_pallas_raw``, :59), which scatters through one-hot
matrix products into an accumulator held in VMEM. What bounds the kernel on
the card is the event read and the atomics the L2 resolves; the 250 KiB
stereo accumulator does not fit a block's shared memory, so it stays in
device memory, and events that are out of range or weigh nothing return
before any atomic (the TPU's sentinel slot would serialise them on one
address). A 4- or 8-band row is added by one or two vector reductions
(``atomicAdd`` on a float4, sm_90); one band takes 4 events a thread from
16-byte loads. More in the source's header.

``histogram_binned`` is the hard-binning stage of
``core/tracer.py:_histogram_from_events_posed`` as one launch of the same
source (``ar2_histogram_binned``): each event's bin rounded, its weights
added at its ear and, unless mono, scaled at the other ear ``delay`` bins
later (at the same bin past the IR's end). Its plain version,
``histogram_binned_plain``, is the two-step PyTorch stage: the same-ear
sum, then the cross-ear deposits from a shift of the finished histogram.

K3-bwd (``ar2_histogram_bwd``) is the gather ``g_w[e] = g[bins[e]]``, 0
where ``bins[e]`` is out of range: the backward of the TPU version's custom
VJP (``histogram_pallas.py:124-143``). It has no atomics and equals its
plain version, ``histogram_bwd_plain``, bit for bit. At one band its pace
is the gather's: where at least half of ``g`` fits, each SM's block copies
that part into shared memory and gathers it from there; at 4 and 8 bands a
row is a 16-byte gather and store. ``core/binning.py`` joins K3 and K3-bwd
in a ``torch.autograd.Function``.

``histogram_sum_banded``, ``histogram_binned`` and ``histogram_bwd`` launch
their kernels for a CUDA tensor and run the plain versions
(``histogram_plain``: ``index_add_``) for a CPU tensor. They never fall
back from one to the other. ``launches``, ``binned_launches`` and
``bwd_launches`` count kernel launches. Each wrapper reads every property
it checks once: at the main path's shapes the host's path into the launch
takes about as long as the kernel.
"""
from __future__ import annotations

import torch

from . import _build

# Kernel launches since import (or since a caller reset it to 0).
launches = 0
binned_launches = 0
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


def histogram_sum_banded(bins: torch.Tensor, weights: torch.Tensor,
                         n_bins: int) -> torch.Tensor:
    """Sum ``weights`` [E, n_bands] into ``n_bins`` bins keyed by int32
    ``bins`` [E]; out-of-range events are dropped. Returns f32
    [n_bins, n_bands] on the input's device."""
    global launches
    dev = bins.device
    if bins.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"histogram needs int32 bins and float32 weights, "
                        f"got {bins.dtype} and {weights.dtype}")
    n_events = bins.shape[0] if bins.dim() == 1 else -1
    if weights.dim() != 2 or weights.shape[0] != n_events:
        raise ValueError(f"histogram needs bins [E] and weights [E, n_bands],"
                         f" got {tuple(bins.shape)} and "
                         f"{tuple(weights.shape)}")
    if weights.device != dev:
        raise ValueError(f"bins on {dev}, weights on {weights.device}")
    if not (bins.is_contiguous() and weights.is_contiguous()):
        raise ValueError("histogram needs contiguous bins and weights")
    if not 0 < n_bins < 2**31:
        raise ValueError(f"n_bins={n_bins} out of the int32 range")
    if dev.type == "cpu":
        return histogram_plain(bins, weights, n_bins)
    if dev.type != "cuda":
        raise ValueError(f"no histogram kernel for device {dev}")
    n_bands = weights.shape[1]
    out = torch.empty((n_bins, n_bands), dtype=torch.float32, device=dev)
    err = _build.library().ar2_histogram(
        bins.data_ptr(), weights.data_ptr(), n_events, n_bins, n_bands,
        out.data_ptr(), _build.stream(dev))
    launches += 1
    _build.check(err, "ar2_histogram")
    return out


def histogram_binned_plain(ev_bin_f: torch.Tensor, ev_w: torch.Tensor,
                           ev_ear: torch.Tensor, ir_length: int,
                           is_mono: bool, cross_ear_delay: int,
                           hrtf_absorption_rate: float,
                           summed=histogram_plain) -> torch.Tensor:
    """Plain PyTorch version of the hard-binning stage: pose-batched events
    (``ev_bin_f`` [P, E], ``ev_w`` [P, E, n_bands], ``ev_ear`` [P, E], 0
    left and 1 right) -> f32 [P, 2, ir_length, n_bands].

    One flat histogram per chunk of poses (flat bin = (pose * 2 + ear) *
    ir_length + round(bin_f)), summed by ``summed(bins, weights, n_bins)``
    (``index_add_`` here; the tracer passes the differentiable K3). A chunk
    holds as many poses as keep its flat bins inside int32. Only the
    same-ear deposits are summed; the cross-ear ones follow from the
    finished histogram by a shift over the pose axis: cross[j] = (1 - hrtf)
    * (same[j - delay] + same[j] for the last ``delay`` bins, the
    reference's overflow fallback, devicePrograms.cu:124-168)."""
    nb, dev = ir_length, ev_bin_f.device
    n_bands = ev_w.shape[-1]
    pose_chunk = max(1, (2**31 - 1) // (2 * nb) - 1)
    outs = []
    for start in range(0, ev_bin_f.shape[0], pose_chunk):
        pb = ev_bin_f[start:start + pose_chunk]
        pw = ev_w[start:start + pose_chunk]
        pe = ev_ear[start:start + pose_chunk].to(torch.int32)
        pc = pb.shape[0]
        active = torch.any(pw != 0.0, dim=-1)
        b = torch.round(pb).to(torch.int32)
        pose = torch.arange(pc, dtype=torch.int32, device=dev)[:, None]
        flat = torch.where(active & (b >= 0) & (b < nb),
                           (pose * 2 + pe) * nb + b, pc * 2 * nb)
        hist = summed(flat.reshape(-1), pw.reshape(-1, n_bands),
                      pc * 2 * nb)
        hist = hist.reshape(pc, 2, nb, n_bands)
        if not is_mono:
            scale = 1.0 - hrtf_absorption_rate
            j = torch.arange(nb, device=dev)
            shifted = torch.roll(hist, cross_ear_delay, dims=2)
            mask = (j >= cross_ear_delay)[None, None, :, None]
            tail = (j >= nb - cross_ear_delay)[None, None, :, None]
            cross = scale * (torch.where(mask, shifted, 0.0)
                             + torch.where(tail, hist, 0.0))
            hist = hist + cross.flip(1)  # each ear receives the OTHER's
        outs.append(hist)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def histogram_binned(ev_bin_f: torch.Tensor, ev_w: torch.Tensor,
                     ev_ear: torch.Tensor, ir_length: int, is_mono: bool,
                     cross_ear_delay: int,
                     hrtf_absorption_rate: float) -> torch.Tensor:
    """The hard-binning stage in one launch: ``ev_bin_f`` f32 [P, E],
    ``ev_w`` f32 [P, E, n_bands] and ``ev_ear`` int32 [P, E] (0 or 1) ->
    f32 [P, 2, ir_length, n_bands] on the input's device. Each active event (a non-zero weight) whose rounded
    bin is in range adds its weights at its ear and, unless ``is_mono``,
    ``(1 - hrtf_absorption_rate)`` times them at the other ear,
    ``cross_ear_delay`` bins later or at the same bin when that passes the
    IR's end. A CPU tensor runs :func:`histogram_binned_plain`. Forward
    only: the tracer takes the two-step stage through the differentiable
    K3 when the weights need a gradient."""
    global binned_launches
    dev = ev_bin_f.device
    if ev_bin_f.dtype != torch.float32 or ev_w.dtype != torch.float32 \
            or ev_ear.dtype != torch.int32:
        raise TypeError(f"histogram_binned needs float32 arrival bins and "
                        f"weights and int32 ears, got "
                        f"{ev_bin_f.dtype}, {ev_w.dtype}, {ev_ear.dtype}")
    shape = tuple(ev_bin_f.shape)
    if len(shape) != 2 or tuple(ev_ear.shape) != shape \
            or ev_w.dim() != 3 or tuple(ev_w.shape[:2]) != shape:
        raise ValueError(f"histogram_binned needs ev_bin_f and ev_ear [P, E]"
                         f" and ev_w [P, E, n_bands], got {shape}, "
                         f"{tuple(ev_ear.shape)}, {tuple(ev_w.shape)}")
    if ev_w.device != dev or ev_ear.device != dev:
        raise ValueError(f"events on {dev}, {ev_w.device}, {ev_ear.device}")
    if not (ev_bin_f.is_contiguous() and ev_w.is_contiguous()
            and ev_ear.is_contiguous()):
        raise ValueError("histogram_binned needs contiguous events")
    if not 0 < ir_length < 2**31 or cross_ear_delay < 0:
        raise ValueError(f"ir_length={ir_length}, cross_ear_delay="
                         f"{cross_ear_delay}: need 0 < ir_length < 2^31 "
                         f"and a delay >= 0")
    if dev.type == "cpu":
        return histogram_binned_plain(ev_bin_f, ev_w, ev_ear, ir_length,
                                      is_mono, cross_ear_delay,
                                      hrtf_absorption_rate)
    if dev.type != "cuda":
        raise ValueError(f"no histogram kernel for device {dev}")
    (n_poses, per_pose), n_bands = shape, ev_w.shape[2]
    out = torch.empty((n_poses, 2, ir_length, n_bands), dtype=torch.float32,
                      device=dev)
    err = _build.library().ar2_histogram_binned(
        ev_bin_f.data_ptr(), ev_w.data_ptr(), ev_ear.data_ptr(), n_poses,
        per_pose, n_bands, ir_length, bool(is_mono), cross_ear_delay,
        1.0 - hrtf_absorption_rate,
        out.data_ptr(), _build.stream(dev))
    binned_launches += 1
    _build.check(err, "ar2_histogram_binned")
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
