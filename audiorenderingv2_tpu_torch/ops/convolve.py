"""FFT convolution (auralization) on ``torch.fft``.

The counterpart of ``audiorenderingv2_tpu/ops/convolve.py``. These are
plain tensor operations, as in the JAX package, where ``jnp.fft`` computes
them outside any Pallas kernel:

* ``convolve_file``: the reference's overlap-add. The signal is cut into
  1 s segments, each zero-padded to ir_length and circularly convolved with
  the IR at FFT size ir_length (so each segment aliases its last second
  exactly as the reference does), then overlap-added. The net scale is x2:
  the reference's unnormalised cuFFT round trip scales by ir_length and it
  divides by ir_length/2. Only whole seconds are processed; the output has
  the input's length.
* ``convolve_file_multi``: the same for a batch of signals, each with its
  own IRs (the filterbank's bands, the listeners of ``multi.mix_sources``).
* ``convolve_live``: one circular convolution at ir_length, same x2 scale.
* ``interleave_stereo``: LRLR interleave.
* ``convolve_linear``: a true linear convolution through one zero-padded
  FFT, with no time aliasing and no scale.
"""
from __future__ import annotations

import torch


def _ola_segments(samples: torch.Tensor, sample_rate: int,
                  ir_length: int) -> torch.Tensor:
    """Cut the signals [..., L] into their whole 1 s segments, each
    zero-padded to ir_length: [..., S, ir_length]."""
    n_seconds = samples.shape[-1] // sample_rate
    segs = samples[..., :n_seconds * sample_rate].reshape(
        *samples.shape[:-1], n_seconds, sample_rate)
    return torch.nn.functional.pad(segs, (0, ir_length - sample_rate))


def _overlap_add(y: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Overlap-add of the segments' circular results ``y`` [..., S,
    ir_length]: segment s starts at second s and spans ir_length /
    sample_rate = k seconds. Returns the seconds [..., S + k - 1,
    sample_rate]."""
    *lead, n_seg, ir_length = y.shape
    k = ir_length // sample_rate
    yk = y.reshape(*lead, n_seg, k, sample_rate)
    total = torch.zeros((*lead, n_seg + k - 1, sample_rate),
                        dtype=torch.float32, device=y.device)
    for m in range(k):
        total[..., m:m + n_seg, :] += yk[..., :, m, :]
    return total


def _to_length(out: torch.Tensor, length: int) -> torch.Tensor:
    """``out`` [..., n] cut, or zero-padded, to [..., length]: the
    reference's output has the input's length."""
    if out.shape[-1] >= length:
        return out[..., :length]
    return torch.nn.functional.pad(out, (0, length - out.shape[-1]))


def convolve_file(samples: torch.Tensor, ir: torch.Tensor,
                  sample_rate: int) -> torch.Tensor:
    """Overlap-add convolution of ``samples`` [L] with one IR [ir_length];
    returns f32 [L]."""
    return convolve_file_stereo(samples, ir[None, :], sample_rate)[0]


def convolve_file_stereo(samples: torch.Tensor, ir_stereo: torch.Tensor,
                         sample_rate: int) -> torch.Tensor:
    """Both ears at once: ``ir_stereo`` [2, ir_length] (any leading count
    C works) -> f32 [C, L] on the IR's device."""
    samples = torch.as_tensor(samples, dtype=torch.float32,
                              device=ir_stereo.device)
    return convolve_file_multi(samples[None], ir_stereo[None],
                               sample_rate)[0]


def convolve_file_multi(samples: torch.Tensor, irs: torch.Tensor,
                        sample_rate: int) -> torch.Tensor:
    """G signals, each against its own C IRs, in one batched FFT:
    ``samples`` [G, L], ``irs`` [G, C, ir_length] -> f32 [G, C, L] on the
    IRs' device. The batch axis stands where the JAX package maps
    ``convolve_file_stereo`` over bands or listeners."""
    samples = torch.as_tensor(samples, dtype=torch.float32,
                              device=irs.device)
    irs = irs.to(torch.float32)
    n_sig, length = samples.shape
    n_ch, ir_length = irs.shape[1:]
    if ir_length % sample_rate != 0:
        raise ValueError("ir_length must be a multiple of sample_rate")
    if length // sample_rate == 0:  # no whole second: silence, as in JAX
        return torch.zeros((n_sig, n_ch, length), dtype=torch.float32,
                           device=irs.device)
    segs = _ola_segments(samples, sample_rate, ir_length)  # [G, S, irl]
    spec = torch.fft.rfft(segs, dim=-1)[:, None] \
        * torch.fft.rfft(irs, dim=-1)[:, :, None, :]
    y = torch.fft.irfft(spec, n=ir_length, dim=-1)  # [G, C, S, ir_length]
    out = _overlap_add(y, sample_rate).reshape(n_sig, n_ch, -1)
    return _to_length(out, length) * 2.0


def convolve_live(block: torch.Tensor, ir_stereo: torch.Tensor,
                  double_precision: bool = False) -> torch.Tensor:
    """Live-input block convolution: ``block`` [ir_length] (the input
    frames zero-padded to ir_length) against ``ir_stereo`` [2, ir_length];
    returns f32 [2, ir_length]. ``double_precision`` runs the FFT in
    float64, as the reference's live path does."""
    dtype = torch.float64 if double_precision else torch.float32
    block = torch.as_tensor(block, device=ir_stereo.device).to(dtype)
    ir_stereo = ir_stereo.to(dtype)
    ir_length = block.shape[0]
    spec = torch.fft.rfft(block)[None, :] * torch.fft.rfft(ir_stereo, dim=-1)
    out = torch.fft.irfft(spec, n=ir_length, dim=-1) * 2.0
    return out.to(torch.float32)


def interleave_stereo(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[n], [n] -> [2n] interleaved LRLR."""
    return torch.stack([left, right], dim=-1).reshape(-1)


def convolve_linear(samples: torch.Tensor, ir: torch.Tensor,
                    out_length: int | None = None) -> torch.Tensor:
    """Linear convolution of ``samples`` [L] with ``ir`` [K] through one FFT
    of the next power of two >= L + K - 1 (no time aliasing), on the IR's
    device; returns f32 [out_length], by default L + K - 1, truncated or
    zero-padded to it."""
    ir = torch.as_tensor(ir, dtype=torch.float32)
    samples = torch.as_tensor(samples, dtype=torch.float32, device=ir.device)
    full = samples.shape[0] + ir.shape[0] - 1
    nfft = 1 << (full - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(samples, n=nfft)
                        * torch.fft.rfft(ir, n=nfft), n=nfft)[:full]
    if out_length is not None:
        y = (y[:out_length] if full >= out_length
             else torch.nn.functional.pad(y, (0, out_length - full)))
    return y
