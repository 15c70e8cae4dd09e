"""The port's filterbank and banded auralization against the JAX package's,
and a banded scene through both renderers' export on shared directions."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import context as j_context
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.ops import filterbank as j_fb
from audiorenderingv2_tpu_torch import context as t_context
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import sampling as t_sampling
from audiorenderingv2_tpu_torch.io import wav as t_wav
from audiorenderingv2_tpu_torch.ops import convolve as t_conv
from audiorenderingv2_tpu_torch.ops import filterbank as t_fb
from audiorenderingv2_tpu_torch.renderer import AudioRenderer

torch.set_num_threads(1)

SR = 8000


def _close(got, ref):
    """Two float32 FFT pipelines (pocketfft, XLA's) on the same data."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=max(1e-6, 1e-5 * np.abs(ref).max()))


def _banded_ir(n_bands, ir_seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((2, n_bands, ir_seconds * SR)) ** 8 * 1e-3).astype(
        np.float32)


@pytest.mark.parametrize("edges", [t_fb.DEFAULT_BAND_EDGES, (500.0, 2000.0)])
def test_split_bands_matches_and_sums_to_input(edges):
    x = np.random.default_rng(0).uniform(-1, 1, 3 * SR + 17).astype(
        np.float32)
    got = t_fb.split_bands(torch.from_numpy(x), SR, edges)
    assert got.shape == (len(edges) + 1, x.shape[0])
    assert got.dtype == torch.float32
    _close(got.numpy(), j_fb.split_bands(jnp.asarray(x), SR, edges))
    np.testing.assert_allclose(got.sum(dim=0).numpy(), x, atol=2e-6)
    assert all(float(b.abs().max()) > 1e-2 for b in got)  # no empty band


@pytest.mark.parametrize("seconds,ir_seconds,n_bands", [(3.5, 2, 4),
                                                        (2.0, 1, 3),
                                                        (1.5, 2, 4)])
def test_convolve_file_banded_matches(seconds, ir_seconds, n_bands):
    x = np.random.default_rng(1).uniform(-1, 1, int(seconds * SR)).astype(
        np.float32)
    ir = _banded_ir(n_bands, ir_seconds, seed=n_bands)
    edges = t_fb.DEFAULT_BAND_EDGES[:n_bands - 1]
    ref = j_fb.convolve_file_banded(jnp.asarray(x), jnp.asarray(ir), SR,
                                    edges)
    got = t_fb.convolve_file_banded(torch.from_numpy(x),
                                    torch.from_numpy(ir), SR, edges)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    # equal band IRs: the bands sum to the input, so the broadband result
    same = np.repeat(ir[:, :1], n_bands, axis=1)
    broad = t_conv.convolve_file_stereo(torch.from_numpy(x),
                                        torch.from_numpy(ir[:, 0]), SR)
    _close(t_fb.convolve_file_banded(torch.from_numpy(x),
                                     torch.from_numpy(same), SR,
                                     edges).numpy(), broad.numpy())


def test_one_band_is_the_stereo_convolution_exactly():
    x = np.random.default_rng(2).uniform(-1, 1, 2 * SR + 5).astype(np.float32)
    ir = _banded_ir(1, 2, seed=9)
    xt, irt = torch.from_numpy(x), torch.from_numpy(ir)
    assert torch.equal(t_fb.convolve_file_banded(xt, irt, SR),
                       t_conv.convolve_file_stereo(xt, irt[:, 0], SR))
    block = torch.from_numpy(np.pad(x[:SR], (0, SR)))
    assert torch.equal(t_fb.convolve_live_banded(block, irt, SR),
                       t_conv.convolve_live(block, irt[:, 0]))


def test_convolve_file_multi_is_the_batched_stereo_convolution():
    """Each signal of the batch against its own IRs equals one
    convolve_file_stereo per signal."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 2 * SR + 40)).astype(
        np.float32))
    irs = torch.from_numpy((rng.random((3, 4, SR)) ** 8).astype(np.float32))
    got = t_conv.convolve_file_multi(x, irs, SR)
    assert got.shape == (3, 4, 2 * SR + 40)
    for g in range(3):
        torch.testing.assert_close(
            got[g], t_conv.convolve_file_stereo(x[g], irs[g], SR),
            rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="multiple of sample_rate"):
        t_conv.convolve_file_multi(x, irs[:, :, :SR - 1], SR)


@pytest.mark.parametrize("n_bands", [3, 4])
def test_convolve_live_banded_matches(n_bands):
    x = np.random.default_rng(4).uniform(-1, 1, 2 * SR).astype(np.float32)
    x[SR + 500:] = 0.0  # one block, zero-padded to ir_length
    ir = _banded_ir(n_bands, 2, seed=5)
    edges = t_fb.DEFAULT_BAND_EDGES[:n_bands - 1]
    ref = j_fb.convolve_live_banded(jnp.asarray(x), jnp.asarray(ir), SR,
                                    edges)
    got = t_fb.convolve_live_banded(torch.from_numpy(x),
                                    torch.from_numpy(ir), SR, edges)
    assert got.shape == (2, 2 * SR) and got.dtype == torch.float32
    _close(got.numpy(), ref)


def _write_banded_config(tmp_path, mono):
    tt.write_box_obj(tmp_path / "room.obj", (9.0, 6.0, 7.0),
                     material="walls")
    dry = np.random.default_rng(0).uniform(-0.5, 0.5, 2 * SR + 300).astype(
        np.float32)
    t_wav.write_wav(tmp_path / "dry.wav", dry[None, :], SR)
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "renderer_parameters": {"ir_length_in_seconds": 1},
        "scene_parameters": {
            "mono": mono, "audio_file_path": "dry.wav",
            "scene_file_path": "room.obj",
            "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0},
            "initial_receiver_pos": {"x": 2.0, "y": 1.0, "z": 1.5}},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": {"x": 16, "y": 16, "z": 16},
            "ray_max_bounces": 12, "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls",
                           "mat_absorption": [0.1, 0.25, 0.4, 0.6]}]}}))
    return path


@pytest.mark.parametrize("mono", [False, True])
def test_banded_export_matches_jax_renderer(tmp_path, monkeypatch, mono):
    """A 4-band scene through config.json -> load_context -> export_audio
    in both packages, the port drawing the directions of the JAX
    renderer's first render: the IR on the reference's statistical bar,
    the normalised WAV within 1e-2 (relative L2; the convolution is
    linear in the IR)."""
    cfg = _write_banded_config(tmp_path, mono)
    j_ctx = j_context.load_context(cfg, opts=ar.TracerOptions(
        block_size=4096, tri_chunk=128), seed=0)
    ref = j_context.export_audio(j_ctx, tmp_path / "j.wav")
    d = np.asarray(j_sampling.sample_directions(
        jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(0)), 4096))
    monkeypatch.setattr(t_sampling, "sample_directions",
                        lambda n, generator, device: torch.tensor(d))
    t_ctx = t_context.load_context(cfg, device="cpu")
    got = t_context.export_audio(t_ctx, tmp_path / "t.wav")
    r = t_ctx.renderer
    assert r.params.n_bands == 4 and r.ir.shape == (2, 4, SR)
    assert r.ir_device.shape == (2, 4, SR)
    jt.assert_ir_close(r.ir.reshape(8, SR),
                       j_ctx.renderer.ir.reshape(8, SR), exact=False)
    assert (r.ir[:, 0].sum() > r.ir[:, 3].sum() * 1.5)  # band 3 absorbs most
    if mono:
        np.testing.assert_array_equal(r.ir[0], r.ir[1])
    assert got.shape == ref.shape == (2, 2 * SR + 300)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-2, rel
    audio = t_wav.read_wav(tmp_path / "t.wav")
    assert audio.n_channels == 2 and audio.sample_rate == SR


def test_banded_renderer_takes_its_band_edges():
    """Three bands need two crossover frequencies: the renderer hands its
    ``band_edges`` to the filterbank."""
    v, t = tt.box_room((6.0, 4.0, 5.0))
    scene = tt.scene_from_arrays(v, t, np.tile(
        np.array([[0.1, 0.3, 0.6]], np.float32), (12, 1)))
    r = AudioRenderer(scene, 1, SR, 1024, max_bounces=8, device="cpu",
                      band_edges=(400.0, 2500.0))
    r.set_receiver((1.0, 0.5, 1.0), 20.0)
    ir = r.render()
    assert ir.shape == (2, 3, SR) and ir.sum() > 0
    x = np.random.default_rng(6).uniform(-1, 1, SR + 200).astype(np.float32)
    got = r.convolve_audio_file(x)
    want = t_fb.convolve_file_banded(torch.from_numpy(x), r.ir_device, SR,
                                     (400.0, 2500.0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, SR + 200) and np.abs(got).max() > 0
    assert r.band_edges == (400.0, 2500.0)


# The octave office's crossovers (ISO 266 centres 63 Hz-8 kHz, edges at the
# geometric midpoints), at 48 kHz.
OCTAVE_EDGES = (88.4, 176.8, 353.6, 707.1, 1414.2, 2828.4, 5656.9)


def _kernel_gains_model(n_freqs, sample_rate, edges, transition):
    """csrc/band_split.cu's arithmetic over every bin at once: the bin's
    frequency as i * step with the last bin the Nyquist rate itself, each
    crossover's clipped raised cosine, the band recurrence, one float32
    rounding."""
    nyquist = sample_rate / 2
    f = np.arange(n_freqs) * (nyquist / (n_freqs - 1))
    f[-1] = nyquist
    below = None
    gains = []
    for f0 in [*edges, None]:
        lp = None
        if f0 is not None:
            lo, hi = f0 - f0 * transition, f0 + f0 * transition
            ramp = np.clip((f - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
            lp = 0.5 * (1.0 + np.cos(np.pi * ramp))
        gains.append(lp if below is None else
                     (lp - below if lp is not None else 1.0 - below))
        below = lp
    return np.stack(gains).astype(np.float32)


@pytest.mark.parametrize("n_freqs,rate,edges", [
    (120_001, 48000, OCTAVE_EDGES), (48_001, 48000, OCTAVE_EDGES),
    (40_001, 16000, t_fb.DEFAULT_BAND_EDGES), (12_001, 8000, (500.0, 2000.0)),
    (2, 8000, (1000.0,))])
def test_kernel_arithmetic_equals_band_gains(n_freqs, rate, edges):
    """The kernel's order of float64 operations, modelled in numpy, gives
    band_gains' float32 gains bit for bit at the shapes the port runs."""
    want = t_fb.band_gains(n_freqs, rate, edges)
    got = _kernel_gains_model(n_freqs, rate, edges, t_fb.TRANSITION)
    assert got.shape == want.shape == (len(edges) + 1, n_freqs)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_promoted_product_keeps_the_broadcast_products_bits():
    """complex64 * float32 promotes the gain to (g, 0): the kernel's
    (re * g - im * 0, re * 0 + im * g) matches PyTorch's product in every
    bit, signed zeros included, where (re * g, im * g) does not."""
    rng = np.random.default_rng(7)
    s = (rng.standard_normal(4000)
         + 1j * rng.standard_normal(4000)).astype(np.complex64)
    s[:40] = 0
    s[40:80].real = -0.0
    s[80:120].imag = -0.0
    g = rng.standard_normal((3, 4000)).astype(np.float32)
    g[:, ::7] = 0.0
    g[:, ::11] = -0.0
    want = torch.view_as_real(torch.from_numpy(s)[None]
                              * torch.from_numpy(g)).numpy()
    zero = np.float32(0.0)
    model = np.stack([s.real * g - s.imag * zero,
                      s.real * zero + s.imag * g], axis=-1)
    np.testing.assert_array_equal(model.view(np.int32), want.view(np.int32))
    naive = np.stack([s.real * g, s.imag * g], axis=-1)
    assert (naive.view(np.int32) != want.view(np.int32)).any()


@pytest.mark.parametrize("edges", [t_fb.DEFAULT_BAND_EDGES, (500.0, 2000.0),
                                   OCTAVE_EDGES])
def test_cpu_tensor_takes_the_plain_path(monkeypatch, edges):
    """On a CPU tensor split_bands is band_gains times the spectrum, bit
    for bit, and never reaches the kernel library."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(t_fb._build, "library", no_library)
    before = t_fb.band_split_launches
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, 2 * SR + 31).astype(np.float32))
    spec = torch.fft.rfft(x)
    gains = torch.from_numpy(t_fb.band_gains(spec.shape[0], SR, edges))
    want = torch.fft.irfft(spec[None, :] * gains, n=x.shape[0], dim=-1)
    got = t_fb.split_bands(x, SR, edges)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(t_fb.split_bands(x.numpy(), SR, edges), got)
    assert t_fb.band_split_launches == before


@pytest.mark.parametrize("bad", ["edges_32", "edges_0", "float64", "two_d",
                                 "meta", "spec_float", "spec_edges_32",
                                 "spec_meta"])
def test_band_split_wrappers_refuse_before_any_launch(monkeypatch, bad):
    """What the kernel does not take raises a ValueError before a launch
    or a build: more than 31 crossovers (or none), a signal that is not
    [L], a spectrum that is not a complex64 [F], a device with no kernel.
    A float64 signal is cast to float32, as the plain path casts it, and
    goes on to the spectrum wrapper."""
    def no_library():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(t_fb._build, "library", no_library)
    before = t_fb.band_split_launches
    x = torch.zeros(64, device="meta")
    spec = torch.zeros(33, dtype=torch.complex64, device="meta")
    many = tuple(100.0 * (k + 1) for k in range(32))
    call, match = {
        "edges_32": (lambda: t_fb.split_bands(x, SR, many), "1 to 31"),
        "edges_0": (lambda: t_fb.split_bands(x, SR, ()), "got 0"),
        "float64": (lambda: t_fb.split_bands(x.double(), SR),
                    "no band-split kernel"),
        "two_d": (lambda: t_fb.split_bands(x.view(2, 32), SR), r"\[L\]"),
        "meta": (lambda: t_fb.split_bands(x, SR), "no band-split kernel"),
        "spec_float": (lambda: t_fb.band_spectra(spec.real.contiguous(), SR),
                       "complex64"),
        "spec_edges_32": (lambda: t_fb.band_spectra(spec, SR, many),
                          "1 to 31"),
        "spec_meta": (lambda: t_fb.band_spectra(spec, SR),
                      "no band-split kernel"),
    }[bad]
    with pytest.raises(ValueError, match=match):
        call()
    assert t_fb.band_split_launches == before


def test_band_split_kernel_is_declared_and_launched():
    """The C entry is defined in its source, declared in _build's
    signatures with its 8 arguments, and launched by the wrapper."""
    import inspect

    from audiorenderingv2_tpu_torch.ops import _build

    cu = (_build.CSRC / "band_split.cu").read_text()
    assert 'extern "C" int ar2_band_split(' in cu
    assert len(_build._SIGNATURES["ar2_band_split"]) == 8
    assert ".ar2_band_split(" in inspect.getsource(t_fb.band_spectra)
    assert t_fb.TRANSITION == inspect.signature(
        t_fb.band_gains).parameters["transition"].default
    assert "band_spectra(" in inspect.getsource(t_fb.split_bands)
