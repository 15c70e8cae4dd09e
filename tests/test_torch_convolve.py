"""The port's FFT convolutions against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiorenderingv2_tpu.ops import convolve as j_conv
from audiorenderingv2_tpu_torch.ops import convolve as t_conv

torch.set_num_threads(1)

SR = 1000


def _signal_and_ir(seconds, ir_seconds, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=int(seconds * SR)).astype(np.float32)
    ir = (rng.random((2, ir_seconds * SR)) ** 8 * 1e-3).astype(np.float32)
    return x, ir


def _close(got, ref):
    """Both are float32 FFTs (pocketfft and XLA's) of the same data: agree
    to 1e-5 of the signal's peak."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seconds,ir_seconds", [(5.5, 2), (3.0, 1),
                                                (1.5, 3), (0.5, 2)])
def test_convolve_file_stereo_matches(seconds, ir_seconds):
    """Overlap-add with the x2 scale and the per-segment aliasing; the tail
    past the last whole second is zero in both (a signal shorter than one
    second is all tail)."""
    x, ir = _signal_and_ir(seconds, ir_seconds, seed=ir_seconds)
    ref = j_conv.convolve_file_stereo(jnp.asarray(x), jnp.asarray(ir), SR)
    got = t_conv.convolve_file_stereo(torch.from_numpy(x),
                                      torch.from_numpy(ir), SR).numpy()
    _close(got, ref)
    one = t_conv.convolve_file(torch.from_numpy(x), torch.from_numpy(ir[1]),
                               SR).numpy()
    _close(one, j_conv.convolve_file(jnp.asarray(x), jnp.asarray(ir[1]), SR))


def test_convolve_file_needs_whole_seconds():
    with pytest.raises(ValueError):
        t_conv.convolve_file_stereo(torch.zeros(3000), torch.zeros(2, 1500),
                                    SR)


@pytest.mark.parametrize("double", [False, True])
def test_convolve_live_matches(double):
    x, ir = _signal_and_ir(2.0, 2, seed=7)
    x[1500:] = 0.0  # one block, zero-padded to ir_length
    ref = j_conv.convolve_live(jnp.asarray(x), jnp.asarray(ir))
    got = t_conv.convolve_live(torch.from_numpy(x), torch.from_numpy(ir),
                               double_precision=double)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_interleave_stereo_matches():
    rng = np.random.default_rng(1)
    left, right = rng.random((2, 257)).astype(np.float32)
    got = t_conv.interleave_stereo(torch.from_numpy(left),
                                   torch.from_numpy(right)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_conv.interleave_stereo(jnp.asarray(left),
                                                 jnp.asarray(right))))
    np.testing.assert_array_equal(got[0::2], left)


@pytest.mark.parametrize("seconds,ir_seconds,out_length", [
    (2.5, 1, None), (1.0, 2, 1000), (0.3, 1, 5000)])
def test_convolve_linear_matches(seconds, ir_seconds, out_length):
    """One zero-padded FFT, truncated or padded to ``out_length``: against
    the JAX function and a float64 ``np.convolve`` (1e-5 of the peak)."""
    x, ir = _signal_and_ir(seconds, ir_seconds, seed=7)
    ref = j_conv.convolve_linear(jnp.asarray(x), jnp.asarray(ir[0]),
                                 out_length=out_length)
    got = t_conv.convolve_linear(torch.from_numpy(x), torch.from_numpy(ir[0]),
                                 out_length=out_length).numpy()
    _close(got, ref)
    exact = np.convolve(x.astype(np.float64), ir[0].astype(np.float64))
    n = got.shape[0]
    want = np.pad(exact, (0, max(0, n - exact.shape[0])))[:n]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
