"""K3's plain version and the events-to-IR step against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu.core import binning as j_binning
from audiorenderingv2_tpu.core import tracer as j_tracer
from audiorenderingv2_tpu.ops import histogram_pallas
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch.core import binning as t_binning
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.ops import histogram_cuda

torch.set_num_threads(1)


def _events(e, n_bins, n_bands, seed, scale=1e-3):
    """Bins with ~10% below 0 or past n_bins (to be dropped)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(-n_bins // 20, n_bins + n_bins // 20,
                        size=e).astype(np.int32)
    w = (rng.random((e, n_bands)) * scale).astype(np.float32)
    return bins, w


def _sort_path_atol(w):
    """The JAX sort path reads each bin as the difference of two f32 prefix
    sums, so its error is a few ulp of the running total, not of the bin:
    4 ulp of the largest band total."""
    return 4 * np.finfo(np.float32).eps * float(w.sum(axis=0).max())


@pytest.mark.parametrize("n_bands", [1, 3])
def test_plain_matches_pallas_and_sort_path(n_bands):
    """Against float64, the Pallas kernel (interpret mode) and the JAX sort
    path. Direct f32 sums in another order agree to rtol 1e-5 (a few ulp
    over the ~3 deposits per bin here); the sort path to its own bound."""
    n_bins = 2000
    bins, w = _events(5000, n_bins, n_bands, seed=n_bands)
    got = histogram_cuda.histogram_sum_banded(
        torch.from_numpy(bins), torch.from_numpy(w), n_bins).numpy()
    pallas = np.asarray(histogram_pallas.histogram_sum_banded_pallas(
        jnp.asarray(bins), jnp.asarray(w), n_bins, True))
    sort = np.asarray(j_binning.histogram_sum_banded(
        jnp.asarray(bins), jnp.asarray(w), n_bins, use_pallas=False))
    keep = (bins >= 0) & (bins < n_bins)
    ref = np.zeros((n_bins, n_bands))
    np.add.at(ref, bins[keep], w[keep].astype(np.float64))
    assert got.shape == (n_bins, n_bands) and got.dtype == np.float32
    for other in (pallas, ref):
        np.testing.assert_allclose(got, other, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got, sort, rtol=1e-5,
                               atol=_sort_path_atol(w[keep]))
    assert (~keep).sum() > 100  # the drop path was exercised


def test_no_swamping_at_a_million_tiny_events():
    """1M deposits of ~1e-9 over a 2 s stereo IR, against float64: direct
    accumulation keeps every deposit (the JAX sort path's f32 cumsum lost
    75% of occupied bins at this scale)."""
    n_bins = 64000
    rng = np.random.default_rng(9)
    bins = rng.integers(0, n_bins, size=1_000_000).astype(np.int32)
    w = (rng.random((1_000_000, 1)) * 2e-9).astype(np.float32)
    got = t_binning.histogram_sum_banded(
        torch.from_numpy(bins), torch.from_numpy(w), n_bins).numpy()[:, 0]
    ref = np.bincount(bins, weights=w[:, 0].astype(np.float64),
                      minlength=n_bins)
    occ = ref > 0
    rel = np.abs(got[occ] - ref[occ]) / ref[occ]
    assert np.median(rel) < 1e-6 and rel.max() < 1e-5
    assert np.count_nonzero(got) == np.count_nonzero(ref)


def _random_events(n, nb, n_bands, seed):
    rng = np.random.default_rng(seed)
    bin_f = rng.uniform(-5, nb + 20, size=n).astype(np.float32)
    w = (rng.random((n, n_bands)) * 1e-4).astype(np.float32)
    w[rng.random(n) < 0.3] = 0.0  # inactive slots
    ear = rng.integers(0, 2, size=n).astype(np.int32)
    return bin_f, w, ear


@pytest.mark.parametrize("mode", ["stereo", "mono", "soft", "banded"])
def test_histogram_from_events_matches(mode):
    """Hard binning with the cross-ear shift, mono (the flat-bins path),
    soft binning, and three bands, against the JAX function on its CPU
    histogram (the sort path, hence its tolerance)."""
    nb = 3000
    n_bands = 3 if mode == "banded" else 1
    params = ar.TraceParams(sample_rate=8000, ir_length=nb,
                            hrtf_absorption_rate=0.8,
                            is_mono=(mode == "mono"), n_bands=n_bands)
    bin_f, w, ear = _random_events(6000, nb, n_bands, seed=len(mode))
    soft = mode == "soft"
    ref = np.asarray(j_tracer._histogram_from_events(
        jnp.asarray(bin_f), jnp.asarray(w), jnp.asarray(ear), params, soft,
        use_pallas_hist=False))
    got = t_tracer._histogram_from_events(
        torch.from_numpy(bin_f), torch.from_numpy(w), torch.from_numpy(ear),
        convert.trace_params_from_jax(params), soft).numpy()
    assert got.shape == ref.shape
    # soft binning and the cross-ear slot at most double the summed weight
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=2 * _sort_path_atol(w))
    # the last cross_ear_delay bins carry the overflow fallback
    assert params.cross_ear_delay > 0 and ref.sum() > 0


def test_histogram_wrapper_checks():
    bins = torch.zeros(4, dtype=torch.int32)
    w = torch.ones(4, 1)
    with pytest.raises(TypeError):
        histogram_cuda.histogram_sum_banded(bins.long(), w, 8)
    with pytest.raises(ValueError, match="bins \\[E\\]"):
        histogram_cuda.histogram_sum_banded(bins, w[:3], 8)
    with pytest.raises(ValueError, match="no histogram kernel"):
        histogram_cuda.histogram_sum_banded(bins.to("meta"), w.to("meta"), 8)
    with pytest.raises(ValueError, match="weight rows"):
        t_binning.histogram_sum_banded(bins, w[:3], 8)


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("rem", [1, 2, 3])
@pytest.mark.parametrize("n_bands", [1, 4, 8])
def test_bwd_plain_equals_jax_bwd(n_bands, rem, view):
    """K3-bwd's plain version (and the wrapper on the CPU) against the JAX
    custom VJP's backward, bit for bit: E = 4k + rem events (the kernel
    takes 4 a thread and the rest one a thread), out-of-range bins on both
    sides and the sentinel n_bins among them, and a ``bins[1:]`` view that
    starts 4 bytes into its storage (the kernel's unaligned path)."""
    n_bins = 700
    e = 4 * 1500 + rem
    rng = np.random.default_rng(10 * n_bands + rem)
    bins = rng.integers(-n_bins // 5, n_bins + n_bins // 5,
                        size=e + view).astype(np.int32)
    bins[::37] = n_bins
    g = rng.standard_normal((n_bins, n_bands)).astype(np.float32)
    b_t = torch.from_numpy(bins)[int(view):]
    assert b_t.is_contiguous() and b_t.shape == (e,)
    _, ref = histogram_pallas._bwd(n_bins, True, jnp.asarray(bins[view:]),
                                   jnp.asarray(g))
    ref = np.asarray(ref)
    plain = histogram_cuda.histogram_bwd_plain(b_t, torch.from_numpy(g))
    assert plain.shape == ref.shape == (e, n_bands)
    np.testing.assert_array_equal(plain.numpy(), ref)
    np.testing.assert_array_equal(
        histogram_cuda.histogram_bwd(b_t, torch.from_numpy(g)).numpy(), ref)
    out = (bins[view:] < 0) | (bins[view:] >= n_bins)
    assert out.sum() > e // 10 and not ref[out].any()


def _hard_events(p, e, nb, n_bands, delay, seed):
    """Pose-batched events for the hard-binning stage: arrival bins across
    [-5, nb + 20) (out of range on both sides), a tenth at exact halves
    (round half to even), a tenth in the last ``delay`` bins (the cross-ear
    bin overflows), 30% inactive (every band zero), some active events with
    a zero band, ears 0 and 1."""
    rng = np.random.default_rng(seed)
    bin_f = rng.uniform(-5, nb + 20, size=(p, e)).astype(np.float32)
    halves = rng.random((p, e)) < 0.1
    bin_f[halves] = rng.integers(-2, nb + 2, size=halves.sum()) + 0.5
    tail = rng.random((p, e)) < 0.1
    bin_f[tail] = rng.uniform(nb - delay - 1, nb - 0.5, size=tail.sum())
    w = (rng.random((p, e, n_bands)) * 1e-4).astype(np.float32)
    w[rng.random((p, e)) < 0.3] = 0.0
    if n_bands > 1:
        w[rng.random((p, e)) < 0.1, 0] = 0.0
    ear = rng.integers(0, 2, size=(p, e)).astype(np.int32)
    return bin_f, w, ear


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("n_bands", [1, 4, 8])
@pytest.mark.parametrize("mono", [False, True])
def test_hard_binning_plain_route_matches_jax(mono, n_bands, p):
    """The hard-binning stage as the port runs it on a CPU tensor (the
    fused entry's plain route) against the JAX function on its CPU
    histogram, pose by pose (the sort path, hence the file's tolerance):
    stereo and mono, 1, 4 and 8 bands, events at exact halves, in the last
    ``delay`` bins, out of range, inactive, and P > 1."""
    nb = 3000
    params = ar.TraceParams(sample_rate=8000, ir_length=nb,
                            hrtf_absorption_rate=0.8, is_mono=mono,
                            n_bands=n_bands)
    delay = params.cross_ear_delay
    bin_f, w, ear = _hard_events(p, 2000, nb, n_bands, delay,
                                 seed=100 * n_bands + 10 * p + mono)
    got = t_tracer._histogram_from_events_posed(
        torch.from_numpy(bin_f), torch.from_numpy(w), torch.from_numpy(ear),
        convert.trace_params_from_jax(params)).numpy()
    if p == 1:
        ref = np.asarray(j_tracer._histogram_from_events(
            jnp.asarray(bin_f[0]), jnp.asarray(w[0]), jnp.asarray(ear[0]),
            params, False, use_pallas_hist=False))[None]
    else:
        ref = np.asarray(j_tracer._histogram_from_events_posed(
            jnp.asarray(bin_f), jnp.asarray(w), jnp.asarray(ear), params,
            use_pallas_hist=False))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=2 * _sort_path_atol(w.reshape(-1,
                                                                  n_bands)))
    assert delay > 0 and ref.sum() > 0
    # the overflow fallback and the halves were exercised
    b = np.rint(bin_f)
    assert ((b >= nb - delay) & (b < nb)).sum() > 50
    assert (bin_f == np.floor(bin_f) + 0.5).sum() > 50


def _deposit_model(bin_f, w, ear, nb, mono, delay, scale):
    """The fused kernel's rule, event by event in float64: an active event
    (a non-zero band) whose rint bin is in [0, nb) adds w at (pose, ear, b)
    and, unless mono, the float32 product scale * w at (pose, 1 - ear,
    b + delay), or at b when b + delay >= nb."""
    p, e, n_bands = w.shape
    out = np.zeros((p, 2, nb, n_bands))
    b = np.rint(bin_f)
    keep = (w != 0).any(axis=-1) & (b >= 0) & (b < nb)
    pose = np.broadcast_to(np.arange(p)[:, None], (p, e))[keep]
    side, bi, wk = ear[keep] != 0, b[keep].astype(np.int64), w[keep]
    np.add.at(out, (pose, side.astype(int), bi), wk.astype(np.float64))
    if not mono:
        cb = np.where(bi + delay < nb, bi + delay, bi)
        cross = (np.float32(scale) * wk).astype(np.float64)
        np.add.at(out, (pose, 1 - side.astype(int), cb), cross)
    return out


@pytest.mark.parametrize("delay", [0, 7, 3010])
@pytest.mark.parametrize("n_bands", [1, 4])
@pytest.mark.parametrize("mono", [False, True])
def test_deposit_rule_equals_the_two_step_stage(mono, n_bands, delay):
    """A numpy model of the fused kernel's per-event rule (two deposits an
    event) against the two-step PyTorch stage (same-ear sum, then the
    cross-ear shift of the finished histogram): the shift's overflow
    fallback is the per-event b + delay >= nb -> b, for a delay of 0, inside
    the IR and past its end. Sums in another order: rtol 1e-5."""
    nb, p = 500, 2
    bin_f, w, ear = _hard_events(p, 3000, nb, n_bands, max(delay, 10),
                                 seed=7 * delay + n_bands + mono)
    hrtf = 0.9
    got = histogram_cuda.histogram_binned(
        torch.from_numpy(bin_f), torch.from_numpy(w), torch.from_numpy(ear),
        nb, mono, delay, hrtf)
    want = _deposit_model(bin_f, w, ear, nb, mono, delay,
                          np.float32(1.0 - hrtf))
    assert got.shape == (p, 2, nb, n_bands) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-12)
    assert not got.numpy()[want == 0].any()  # no bin without a deposit
    assert want.sum() > 0


def test_hard_binning_gradient_takes_the_two_step_stage():
    """With weights that need a gradient the stage runs through the
    differentiable K3 (forward K3, backward K3-bwd): d(sum(R * hist)) / dw
    of a kept event is R at its same-ear bin plus (1 - hrtf) times R at its
    cross-ear bin, and 0 for a dropped event."""
    nb, hrtf = 400, 0.8
    tparams = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=8000, ir_length=nb, hrtf_absorption_rate=hrtf))
    delay = tparams.cross_ear_delay
    assert delay > 0
    bin_f, w, ear = _hard_events(2, 1500, nb, 1, delay, seed=5)
    w_t = torch.from_numpy(w).requires_grad_(True)
    ir = t_tracer._histogram_from_events_posed(
        torch.from_numpy(bin_f), w_t, torch.from_numpy(ear), tparams)
    r = torch.from_numpy(np.random.default_rng(6).standard_normal(
        ir.shape).astype(np.float32))
    (ir * r).sum().backward()
    rn = r.numpy()
    b = np.rint(bin_f)
    keep = (w[..., 0] != 0) & (b >= 0) & (b < nb)
    bi = np.clip(b, 0, nb - 1).astype(int)
    pose = np.broadcast_to(np.arange(2)[:, None], bin_f.shape)
    cb = np.where(bi + delay < nb, bi + delay, bi)
    want = rn[pose, ear, bi] + np.float32(1 - hrtf) * rn[pose, 1 - ear, cb]
    got = w_t.grad.numpy()[..., 0]
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-6)
    assert not got[~keep].any()
    assert keep.sum() > 1000 and (~keep).sum() > 100


def test_histogram_binned_checks():
    """The fused entry's wrapper checks before it dispatches; on the CPU it
    runs the plain version and launches nothing."""
    f = torch.zeros(2, 8)
    w = torch.ones(2, 8, 1)
    ear = torch.zeros(2, 8, dtype=torch.int32)
    args = (100, False, 3, 0.9)
    with pytest.raises(TypeError, match="float32 arrival bins"):
        histogram_cuda.histogram_binned(f.double(), w, ear, *args)
    with pytest.raises(TypeError, match="int32 ears"):
        histogram_cuda.histogram_binned(f, w, ear.long(), *args)
    with pytest.raises(TypeError, match="int32 ears"):
        histogram_cuda.histogram_binned(f, w, ear.float(), *args)
    with pytest.raises(ValueError, match=r"ev_w \[P, E, n_bands\]"):
        histogram_cuda.histogram_binned(f, w[:, :5], ear, *args)
    with pytest.raises(ValueError, match=r"ev_w \[P, E, n_bands\]"):
        histogram_cuda.histogram_binned(f[0], w[0], ear[0], *args)
    with pytest.raises(ValueError, match="contiguous"):
        histogram_cuda.histogram_binned(f.T.contiguous().T, w, ear, *args)
    with pytest.raises(ValueError, match="delay >= 0"):
        histogram_cuda.histogram_binned(f, w, ear, 100, False, -1, 0.9)
    with pytest.raises(ValueError, match="no histogram kernel"):
        histogram_cuda.histogram_binned(f.to("meta"), w.to("meta"),
                                        ear.to("meta"), *args)
    before = histogram_cuda.binned_launches
    out = histogram_cuda.histogram_binned(f, w, ear, *args)
    assert out.shape == (2, 2, 100, 1)
    assert histogram_cuda.binned_launches == before


@pytest.mark.parametrize("shape", [(6000,), (40, 150), (3, 20, 100)])
def test_histogram_sum_matches_jax(shape):
    """``binning.histogram_sum`` (the one-band case of the banded Function)
    against JAX's on the same bins of any shape, 30% of them out of range:
    rtol 1e-5 of float64 as above; JAX's sort path to its own bound."""
    n_bins = 1500
    rng = np.random.default_rng(sum(shape))
    bins = rng.integers(0, n_bins, size=shape)
    out = rng.random(shape) < 0.3
    bins[out] = np.where(rng.random(out.sum()) < 0.5,
                         -rng.integers(1, 50, size=out.sum()),
                         n_bins + rng.integers(0, 50, size=out.sum()))
    bins = bins.astype(np.int32)
    w = (rng.random(shape) * 1e-3).astype(np.float32)
    got = t_binning.histogram_sum(torch.from_numpy(bins),
                                  torch.from_numpy(w), n_bins)
    ref = np.asarray(j_binning.histogram_sum(jnp.asarray(bins),
                                             jnp.asarray(w), n_bins))
    keep = (bins >= 0) & (bins < n_bins)
    ref64 = np.bincount(bins[keep], weights=w[keep].astype(np.float64),
                        minlength=n_bins)
    assert got.shape == ref.shape == (n_bins,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref64, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=_sort_path_atol(w[keep][:, None]))
    assert out.mean() > 0.25


def test_histogram_sum_gradient_against_finite_differences():
    """d(sum of g * hist)/d(weights) through the Function's backward (the
    gather g[bins], zero for a dropped event) against central differences
    of ``histogram_sum`` itself, one weight at a time, as
    torch.autograd.gradcheck takes them. The forward is float32 and linear
    in the weights, so a wide step (0.05) is exact but for rounding: atol
    2e-5 (the loss's float32 rounding, ~1e-6, over the 0.1 step)."""
    n_bins = 40
    rng = np.random.default_rng(9)
    bins = torch.from_numpy(rng.integers(-5, n_bins + 5, size=(7, 9))
                            .astype(np.int32))
    w = torch.from_numpy(rng.random((7, 9)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(n_bins).astype(np.float32))

    def loss(x):
        return (t_binning.histogram_sum(bins, x, n_bins) * g).sum()

    wg = w.clone().requires_grad_(True)
    loss(wg).backward()
    eps = 0.05
    fd = np.zeros(w.shape)
    with torch.no_grad():
        for idx in np.ndindex(*w.shape):
            up, dn = w.clone(), w.clone()
            up[idx] += eps
            dn[idx] -= eps
            fd[idx] = (float(loss(up)) - float(loss(dn))) / (2 * eps)
    np.testing.assert_allclose(wg.grad.numpy(), fd, rtol=0, atol=2e-5)
    dropped = ((bins < 0) | (bins >= n_bins)).numpy()
    assert dropped.any() and not wg.grad.numpy()[dropped].any()
    assert wg.grad.abs().sum() > 0
