"""The port's gradients against the JAX package: the histogram's backward
(K3-bwd's plain version) and the autograd tracer, on the same numpy inputs.
Directions come from JAX's sampler and cross over as numpy arrays."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.ops import histogram_pallas
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch.core import binning as t_binning
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.ops import histogram_cuda

torch.set_num_threads(1)

SR = 8000


def _np(sc):
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


# -------------------------------------------------- (a) the histogram's VJP

@pytest.mark.parametrize("n_bands", [1, 4])
def test_histogram_function_gradient_matches_jax_and_index_add(n_bands):
    """d(sum(hist * c))/d(weights) through the port's Function, the JAX
    custom VJP (Pallas kernel in interpret mode) and autograd through
    ``index_add_``: a gather of c, so all three are equal, zeros at the
    out-of-range bins included."""
    n_bins, e = 700, 3000
    rng = np.random.default_rng(n_bands)
    bins = rng.integers(-40, n_bins + 40, size=e).astype(np.int32)
    w = rng.random((e, n_bands)).astype(np.float32)
    c = rng.standard_normal((n_bins, n_bands)).astype(np.float32)

    wt = torch.tensor(w, requires_grad=True)
    hist = t_binning.histogram_sum_banded(torch.from_numpy(bins), wt, n_bins)
    (hist * torch.from_numpy(c)).sum().backward()

    g_jax = jax.grad(lambda x: jnp.sum(
        histogram_pallas.histogram_sum_banded_pallas(
            jnp.asarray(bins), x, n_bins, True) * c))(jnp.asarray(w))

    wa = torch.tensor(w, requires_grad=True)
    keep = (bins >= 0) & (bins < n_bins)
    ha = torch.zeros(n_bins, n_bands).index_add(
        0, torch.from_numpy(bins[keep]).long(), wa[torch.from_numpy(keep)])
    (ha * torch.from_numpy(c)).sum().backward()

    assert (~keep).sum() > 50
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(g_jax))
    np.testing.assert_array_equal(wt.grad.numpy(), wa.grad.numpy())
    assert not wt.grad[torch.from_numpy(~keep)].any()


def test_histogram_backward_takes_any_gradient_layout():
    """``.sum()`` hands the backward an expanded gradient of stride 0, a
    permuted loss a strided one; both reach the gather as dense f32."""
    bins = torch.tensor([0, 2, 2, 5, -1, 1], dtype=torch.int32)
    w = torch.rand(6, 3, requires_grad=True)
    t_binning.histogram_sum_banded(bins, w, 4).sum().backward()
    expect = torch.ones(6, 3)
    expect[3:5] = 0.0
    assert torch.equal(w.grad, expect)
    w.grad = None
    weights = torch.arange(12.0).reshape(3, 4)
    (t_binning.histogram_sum_banded(bins, w, 4).T * weights).sum().backward()
    assert torch.equal(w.grad[0], weights[:, 0])
    assert torch.equal(w.grad[1], weights[:, 2])
    assert not w.grad[3:5].any()


def test_histogram_bwd_wrapper_checks_and_cpu_route():
    bins = torch.tensor([0, 3, 9], dtype=torch.int32)
    g = torch.rand(4, 2)
    before = histogram_cuda.bwd_launches
    out = histogram_cuda.histogram_bwd(bins, g)
    assert torch.equal(out, histogram_cuda.histogram_bwd_plain(bins, g))
    assert torch.equal(out[1], g[3]) and not out[2].any()
    assert histogram_cuda.bwd_launches == before  # no kernel on the CPU
    with pytest.raises(TypeError, match="int32 bins"):
        histogram_cuda.histogram_bwd(bins.long(), g)
    with pytest.raises(ValueError, match="contiguous"):
        histogram_cuda.histogram_bwd(bins, g.T.contiguous().T)
    with pytest.raises(ValueError, match="no histogram kernel for device"):
        histogram_cuda.histogram_bwd(bins.to("meta"), g.to("meta"))


# ---------------------------------------------------- (b) the autograd tracer

def _box_setup(n_rays=128, max_bounces=5):
    """tests/test_gradients.py's setup, in both packages."""
    v, t = jt.box_room((10.0, 8.0, 9.0))
    scene = jt.scene_from_arrays(v, t, 0.3)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=max_bounces)
    dirs = np.array(j_sampling.sample_directions(jax.random.PRNGKey(2),
                                                 n_rays))  # writable copy
    sc = ar.scene_to_arrays(scene, 128)
    sct = convert.scene_arrays_from_jax(_np(sc), device="cpu")
    return sc, sct, params, convert.trace_params_from_jax(params), dirs


J_OPTS = ar.TracerOptions(block_size=128, tri_chunk=128, early_exit=False,
                          soft_binning=True)
REC = np.array([1.5, 0.5, -2.0], np.float32)


@pytest.mark.parametrize("soft,early_exit,remat,block", [
    (True, False, False, 128), (False, True, False, 48),
    (True, False, True, 128)])
def test_autograd_tracer_ir_matches_jax(soft, early_exit, remat, block):
    """The autograd backend's IR against the JAX XLA tracer's, soft and
    hard binning, a ragged last block included. The port does not contract
    multiply-adds, XLA on the CPU does, so the bar is the statistical one
    (a deposit may cross a bin edge); per-ear energy within 1e-3."""
    sc, sct, params, tparams, dirs = _box_setup(n_rays=200)
    jo = dataclasses.replace(J_OPTS, soft_binning=soft, early_exit=early_exit,
                             remat=remat, block_size=block)
    ref = np.asarray(ar.trace_ir(sc, jnp.asarray(dirs), jnp.zeros(3),
                                 jnp.asarray(REC), 10.0, params, jo))
    to = convert.tracer_options_from_jax(jo)
    assert to.backend == "autograd" and to.block_size == block
    got = t_tracer.trace_ir(sct, torch.from_numpy(dirs), np.zeros(3), REC,
                            10.0, tparams, to).numpy()
    assert got.shape == ref.shape == (2, SR) and got.sum() > 0
    jt.assert_ir_close(got, ref, exact=False)
    # and the kernels' backend (K1's plain version here) on the same rays
    kern = t_tracer.trace_ir(sct, torch.from_numpy(dirs), np.zeros(3), REC,
                             10.0, tparams, dataclasses.replace(
                                 to, backend="kernels")).numpy()
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-12)


def _t_opts():
    return convert.tracer_options_from_jax(J_OPTS)


def test_absorption_gradient_matches_jax_and_finite_difference():
    sc, sct, params, tparams, dirs = _box_setup()

    def j_loss(a):
        sc_a = sc._replace(absorption=jnp.full_like(sc.absorption, a))
        ir = ar.trace_ir(sc_a, jnp.asarray(dirs), jnp.zeros(3),
                         jnp.asarray(REC), 10.0, params, J_OPTS)
        return jnp.sum(ir ** 2)

    def t_loss(a):
        sc_a = sct._replace(absorption=torch.ones_like(sct.absorption) * a)
        ir = t_tracer.trace_ir(sc_a, torch.from_numpy(dirs), np.zeros(3),
                               REC, 10.0, tparams, _t_opts())
        return (ir ** 2).sum()

    a = torch.tensor(0.3, requires_grad=True)
    t_loss(a).backward()
    g_jax = float(jax.grad(j_loss)(jnp.float32(0.3)))
    # Same paths, same deposits: rounding only (found 2e-6).
    assert float(a.grad) == pytest.approx(g_jax, rel=1e-3)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(t_loss(torch.tensor(0.3 + eps)))
              - float(t_loss(torch.tensor(0.3 - eps)))) / (2 * eps)
    assert float(a.grad) == pytest.approx(fd, rel=5e-2)


@pytest.mark.parametrize("what", ["emitter", "receiver"])
def test_pose_gradients_match_jax(what):
    """Emitter and receiver gradients of a smooth functional of the IR (the
    weighted arrival time of tests/test_gradients.py) against jax.grad and
    against the port's own central differences, each within 1e-2 of the
    gradient's norm. Found: 4e-3 to JAX, 1e-3 to the differences. The slack
    is JAX's: on the CPU its histogram is the sort / cumsum path, whose VJP
    reads each event's cotangent as a difference of two f32 running sums of
    the ramp (up to 6e7), while the port gathers it exactly (K3-bwd); JAX's
    gradient is as far from its own differences."""
    sc, sct, params, tparams, dirs = _box_setup()
    w = np.arange(SR, dtype=np.float32)
    em0 = np.array([0.1, 0.2, -0.1], np.float32)

    def j_loss(x):
        em, rec = (x, jnp.asarray(REC)) if what == "emitter" else \
            (jnp.asarray(em0), x)
        ir = ar.trace_ir(sc, jnp.asarray(dirs), em, rec, 0.0, params, J_OPTS)
        return jnp.sum(ir * w[None, :]) / (jnp.sum(ir) + 1e-9)

    def t_loss(x):
        em, rec = (x, torch.from_numpy(REC)) if what == "emitter" else \
            (torch.from_numpy(em0), x)
        ir = t_tracer.trace_ir(sct, torch.from_numpy(dirs), em, rec, 0.0,
                               tparams, _t_opts())
        return (ir * torch.from_numpy(w)[None, :]).sum() / (ir.sum() + 1e-9)

    x0 = em0 if what == "emitter" else REC
    x = torch.tensor(x0, requires_grad=True)
    t_loss(x).backward()
    g_jax = np.asarray(jax.grad(j_loss)(jnp.asarray(x0)))
    g = x.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, g_jax, rtol=0,
                               atol=1e-2 * np.linalg.norm(g_jax))
    eps = 1e-3
    fd = np.zeros(3)
    with torch.no_grad():
        for axis in range(3):
            e = np.zeros(3, np.float32)
            e[axis] = eps
            fd[axis] = (float(t_loss(torch.tensor(x0 + e)))
                        - float(t_loss(torch.tensor(x0 - e)))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=0, atol=1e-2 * np.linalg.norm(fd))


def test_receiver_gradient_matches_finite_difference():
    _, sct, _, tparams, dirs = _box_setup()
    w = torch.arange(SR, dtype=torch.float32)

    def loss(x):
        rec = torch.stack([x, torch.tensor(0.5), torch.tensor(-2.0)])
        ir = t_tracer.trace_ir(sct, torch.from_numpy(dirs), np.zeros(3), rec,
                               0.0, tparams, _t_opts())
        return (ir * w[None, :]).sum() / (ir.sum() + 1e-9)

    x = torch.tensor(1.5, requires_grad=True)
    loss(x).backward()
    eps = 3e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(1.5 + eps)))
              - float(loss(torch.tensor(1.5 - eps)))) / (2 * eps)
    assert float(x.grad) == pytest.approx(fd, rel=1e-1, abs=1e-3)


def test_geometry_gradient_matches_jax_and_every_gradient_is_finite():
    """Gradients reach the plane rows, equal JAX's (relative 1e-3 of the
    norm), and none is NaN or inf: the double ``where``s keep the square
    root of a negative discriminant and 0 * inf out of the backward pass,
    with rays that miss the sphere, rays that start inside it and padding
    rows in the same block."""
    sc, sct, params, tparams, dirs = _box_setup()

    def j_loss(plane_n, plane_d):
        ir = ar.trace_ir(sc._replace(plane_n=plane_n, plane_d=plane_d),
                         jnp.asarray(dirs), jnp.zeros(3), jnp.asarray(REC),
                         0.0, params, J_OPTS)
        return jnp.sum(ir ** 2)

    leaves = {f: getattr(sct, f).clone().requires_grad_(True)
              for f in ("plane_n", "plane_d", "normal", "absorption")}
    em = torch.tensor([0.0, 0.0, 0.0], requires_grad=True)
    rec = torch.tensor(REC, requires_grad=True)
    ir = t_tracer.trace_ir(sct._replace(**leaves), torch.from_numpy(dirs),
                           em, rec, 0.0, tparams, _t_opts())
    (ir ** 2).sum().backward()
    for name, leaf in {**leaves, "emitter": em, "receiver": rec}.items():
        assert torch.isfinite(leaf.grad).all(), name
        assert leaf.grad.abs().sum() > 0, name
    gn, gd = jax.grad(j_loss, argnums=(0, 1))(sc.plane_n, sc.plane_d)
    for got, ref in ((leaves["plane_n"].grad, gn), (leaves["plane_d"].grad,
                                                    gd)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-3 * np.linalg.norm(ref))

    # An emitter inside the receiver sphere: every ray's first test is the
    # far crossing; still finite.
    em_in = torch.tensor(REC + 0.2, requires_grad=True)
    ir = t_tracer.trace_ir(sct, torch.from_numpy(dirs), em_in,
                           torch.from_numpy(REC), 0.0, tparams, _t_opts())
    (ir ** 2).sum().backward()
    assert torch.isfinite(em_in.grad).all() and ir.sum() > 0


def test_gradients_reach_events_through_soft_bins_and_k3_bwd():
    """``_histogram_from_events``: the arrival bin gets its gradient from
    the soft fractions, the weights theirs from the gather."""
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=400, hrtf_absorption_rate=0.9))
    rng = np.random.default_rng(0)
    bin_f = torch.tensor(rng.uniform(5, 390, 64).astype(np.float32),
                         requires_grad=True)
    w = torch.tensor(rng.random((64, 1)).astype(np.float32),
                     requires_grad=True)
    ear = torch.from_numpy(rng.integers(0, 2, 64).astype(np.int32))
    ramp = torch.arange(400.0)
    for soft in (True, False):
        bin_f.grad = w.grad = None
        ir = t_tracer._histogram_from_events(bin_f, w, ear, params, soft)
        (ir * ramp).sum().backward()
        assert torch.isfinite(w.grad).all() and (w.grad > 0).all()
        if soft:
            # d/d(bin) of sum(ir * ramp) = weight * (1 + cross-ear share)
            expect = w.detach()[:, 0] * (1.0 + 0.1)
            torch.testing.assert_close(bin_f.grad, expect, rtol=1e-4,
                                       atol=1e-6)
        else:
            assert bin_f.grad is None or not bin_f.grad.any()


def test_unknown_backend_raises():
    _, sct, _, tparams, dirs = _box_setup(n_rays=8)
    with pytest.raises(ValueError, match="unknown backend"):
        t_tracer.trace_ir(sct, torch.from_numpy(dirs), np.zeros(3), REC, 0.0,
                          tparams, t_tracer.TracerOptions(backend="xla"))


@pytest.mark.parametrize("entry", ["native_rng", "pose_batch", "matrix"])
def test_autograd_backend_never_runs_the_forward_kernels(monkeypatch, entry):
    """The entries that exist only on the forward kernels refuse
    ``backend="autograd"``; the matrix leaves its fused batch and renders
    pair by pair through the differentiable tracer, as the JAX package's
    gate does for its ``"xla"`` backend."""
    from audiorenderingv2_tpu_torch import multi as t_multi

    _, sct, _, tparams, _ = _box_setup(n_rays=8)
    gen = torch.Generator().manual_seed(0)
    if entry == "native_rng":
        opts = t_tracer.TracerOptions(backend="autograd", native_rng=True)
        with pytest.raises(ValueError, match="forward-only kernels"):
            t_tracer.render_ir(sct, gen, 128, np.zeros(3), REC, 0.0, tparams,
                               opts)
        return
    opts = t_tracer.TracerOptions(backend="autograd", block_size=128)
    if entry == "pose_batch":
        with pytest.raises(ValueError, match="forward-only kernels"):
            t_tracer.render_ir_pose_batch(sct, 0, 128, np.zeros((2, 3)),
                                          np.stack([REC, REC]), [0.0, 0.0],
                                          tparams, opts)
        return
    monkeypatch.setattr(
        t_multi, "render_ir_pose_batch",
        lambda *a, **k: pytest.fail("the gate let the fused batch run"))
    m = t_multi.render_ir_matrix(sct, 0, np.zeros((1, 3), np.float32),
                                 np.stack([REC, REC]).astype(np.float32), 0.0,
                                 128, tparams, opts, pair_batch=0)
    assert m.shape[:3] == (1, 2, 2) and np.isfinite(m).all() and m.sum() > 0
