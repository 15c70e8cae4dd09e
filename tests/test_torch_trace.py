"""The port's tracer (K1's plain version, the loop of rounds, trace_ir)
against the JAX package: the Pallas kernel in interpret mode and the XLA
tracer, on the same scene arrays and the same numpy directions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.ops import raytrace_pallas as rp
from audiorenderingv2_tpu.ops import raytrace_pallas_v2 as rp2
from audiorenderingv2_tpu_torch import constants, convert
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.ops import histogram_cuda
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

torch.set_num_threads(1)

SR = 16000
SCENES = {
    "box": (lambda: jt.box_room((12.0, 8.0, 10.0)), [2.0, 0.0, 1.0]),
    "ico": (lambda: jt.icosphere(radius=6.0, subdivisions=2),
            [1.5, 0.5, -1.0]),
}


def _setup(name, absorption=0.3):
    fn, rec = SCENES[name]
    v, t = fn()
    scene = jt.scene_from_arrays(v, t, absorption)
    sc = ar.scene_to_arrays(scene, 128)
    arrays = {k: None if x is None else np.asarray(x)
              for k, x in sc._asdict().items()}
    return sc, convert.scene_arrays_from_jax(arrays, device="cpu"), np.asarray(
        rec, np.float32)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _tparams(params):
    return convert.trace_params_from_jax(params)


# Tolerances against the Pallas kernel in interpret mode: XLA's CPU backend
# contracts multiply-adds into FMAs, the port rounds each operation, so the
# states drift by a few ulp per bounce; after one bounce they agree to
# 1e-5, after eight to 1e-4 (no ray changes its path at these sizes).
ROUND_TOL = {1: 1e-5, 8: 1e-4}


@pytest.mark.parametrize("budget", [1, 8])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_round_plain_matches_pallas_kernel(name, budget):
    sc, sct, rec = _setup(name)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=20)
    n = 512
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rp.init_state(jnp.asarray(_dirs(n, 1)), jnp.zeros(3), e0, n)
    scal = rp._scalars(jnp.zeros(3), jnp.asarray(rec),
                       jnp.deg2rad(jnp.float32(25.0)), e0, params)
    rows, _, _ = rp2.pack_tris_v2(sc, 1, layout="rows")
    ref = rp2.trace_round_v2(rp2.to_tiles(state), rows, None, None, scal,
                             params, budget, interpret=True)
    ref = np.asarray(rp2.from_tiles(ref)).T  # [ncols, N]

    got = rc.trace_round(torch.tensor(np.asarray(state).T.copy()),
                         rc.pack_tris_rows(sct), torch.tensor(
                             np.asarray(scal)[0]), _tparams(params), budget)
    assert got.shape == ref.shape == (16, n)
    tol = ROUND_TOL[budget]
    for c in range(16):  # every column, LTRI and RECVD included
        np.testing.assert_allclose(got[c].numpy(), ref[c], rtol=tol,
                                   atol=tol, err_msg=f"column {c}")
    assert (ref[rc._C_LTRI] > 0).any() and (ref[rc._C_DEPTH] > 0).any()


def test_trace_events_matches_pallas_rounds():
    """Rounds (2, 3, 3) with the alive-first partition between them."""
    sc, sct, rec = _setup("box")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=8)
    d = _dirs(1000, 2)  # pads to 1024: the last 24 rays are padding
    rows = rp2.pack_tris_v2(sc, 1, layout="rows")
    ref = rp.trace_events_pallas(
        rows, jnp.asarray(d), jnp.zeros(3), jnp.asarray(rec), 10.0, params,
        interpret=True, version=2, round_budgets=(2, 3, 3))
    got = rc.trace_events(rc.pack_tris_rows(sct), torch.from_numpy(d),
                          torch.zeros(3), torch.from_numpy(rec), 10.0,
                          _tparams(params), round_budgets=(2, 3, 3))
    # rtol 1e-4 as for trace_round at 8 bounces, with atol at 1e-4 of each
    # array's scale: a grazing receiver chord (t2 - t1 from a discriminant
    # near 0) turns those ulps into a larger relative change of a small
    # weight.
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert r.shape == tuple(g.shape)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())
    assert np.count_nonzero(np.asarray(ref[1])) > 50


@pytest.mark.parametrize("bounces,n_rays", [(4, 16384), (16, 16384),
                                            (100, 4096)])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_ir_matches_xla(name, bounces, n_rays):
    """The whole trace + histogram against the JAX XLA tracer, on the
    reference's statistical bar (exact=False): per-ear energy within 1e-3,
    relative L1 below 1e-2."""
    sc, sct, rec = _setup(name)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=bounces)
    d = _dirs(n_rays, bounces)
    ref = np.asarray(ar.trace_ir(sc, jnp.asarray(d), jnp.zeros(3),
                                 jnp.asarray(rec), 25.0, params,
                                 ar.TracerOptions(block_size=4096,
                                                  tri_chunk=128)))
    got = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), rec, 25.0,
                            _tparams(params)).numpy()
    assert ref.sum() > 0
    jt.assert_ir_close(got, ref, exact=False)


def test_trace_ir_banded_matches_xla():
    """Three absorption bands: the banded state columns of K1."""
    v, t = jt.box_room((9.0, 7.0, 8.0))
    absorb = np.tile(np.array([[0.1, 0.4, 0.7]], np.float32), (12, 1))
    scene = jt.scene_from_arrays(v, t, absorb)
    sc = ar.scene_to_arrays(scene, 128)
    sct = convert.scene_arrays_from_jax(
        {k: None if x is None else np.asarray(x)
         for k, x in sc._asdict().items()}, device="cpu")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=12, n_bands=3)
    d = _dirs(4096, 7)
    rec = np.array([1.0, 0.5, -1.0], np.float32)
    ref = np.asarray(ar.trace_ir(sc, jnp.asarray(d), jnp.zeros(3),
                                 jnp.asarray(rec), 0.0, params,
                                 ar.TracerOptions(block_size=4096,
                                                  tri_chunk=128)))
    got = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), rec, 0.0,
                            _tparams(params)).numpy()
    assert got.shape == ref.shape == (2, 3, SR)
    jt.assert_ir_close(got, ref, exact=False)
    e = got.sum(axis=(0, 2))
    assert e[0] > e[1] > e[2] > 0  # more absorption, less energy


def test_padding_rays_deposit_nothing():
    _, sct, rec = _setup("box")
    params = _tparams(ar.TraceParams(sample_rate=SR, ir_length=SR,
                                     base_power=3.62, max_bounces=10))
    d = torch.from_numpy(_dirs(200, 4))  # pads to 256
    rows = rc.pack_tris_rows(sct)
    args = (rows, d, torch.zeros(3), torch.from_numpy(rec), 0.0, params)
    ev_b, ev_w, ev_e = rc.trace_events(*args, route=rc.Route("k1", None))
    assert ev_w.shape == (256, 1)
    assert torch.all(ev_w[200:] == 0) and torch.all(ev_b[200:] == 0)
    assert torch.count_nonzero(ev_w[:200]) > 0
    # With compaction the slots are permuted, but the same events remain.
    _, ev_w2, _ = rc.trace_events(*args, route=rc.Route("k1", "partition"))
    assert torch.equal(torch.sort(ev_w2[:, 0]).values,
                       torch.sort(ev_w[:, 0]).values)
    state = rc.init_state(d, torch.zeros(3), 1.0, 256)
    assert torch.all(state[rc._C_DONE, 200:] == 1)
    assert torch.all(state[rc._C_EN, 200:] == 0)
    assert torch.all(state[rc._C_EN, :200] == 1)


def test_round_budget_guard():
    _, sct, rec = _setup("box")
    params = _tparams(ar.TraceParams(sample_rate=SR, ir_length=SR,
                                     max_bounces=8))
    with pytest.raises(ValueError, match="deep paths would be truncated"):
        rc.trace_events(rc.pack_tris_rows(sct),
                        torch.from_numpy(_dirs(128, 0)), torch.zeros(3),
                        torch.from_numpy(rec), 0.0, params,
                        round_budgets=(2, 3, 2))


@pytest.mark.parametrize("max_bounces", [1, 5, 6, 20, 32, 100])
def test_round_schedule_and_partition_match(max_bounces):
    assert rc._round_schedule(max_bounces) == rp._round_schedule(max_bounces)
    rng = np.random.default_rng(max_bounces)
    state = rng.normal(size=(300, 16)).astype(np.float32)
    state[:, rp._C_DONE] = rng.random(300) < 0.6
    ref = np.asarray(rp._partition_alive_first(jnp.asarray(state)))
    got = rc._partition_alive_first(torch.from_numpy(state.T.copy()))
    np.testing.assert_array_equal(got.numpy(), ref.T)


def test_cpu_call_launches_no_kernel():
    """On CPU tensors both wrappers run their plain versions."""
    _, sct, rec = _setup("box")
    params = _tparams(ar.TraceParams(sample_rate=SR, ir_length=SR,
                                     base_power=3.62, max_bounces=6))
    rc.launches = histogram_cuda.launches = 0
    ir = t_tracer.trace_ir(sct, torch.from_numpy(_dirs(1024, 3)),
                           np.zeros(3), rec, 0.0, params)
    assert ir.device.type == "cpu" and float(ir.sum()) > 0
    assert rc.launches == 0 and histogram_cuda.launches == 0


def test_trace_round_rejects_bad_inputs():
    """The wrapper checks before it dispatches; a device with no kernel
    raises instead of running the plain version."""
    _, sct, _ = _setup("box")
    params = _tparams(ar.TraceParams(sample_rate=SR, ir_length=SR))
    rows = rc.pack_tris_rows(sct)
    state = rc.init_state(torch.from_numpy(_dirs(128, 0)), torch.zeros(3),
                          1.0, 128)
    scal = torch.zeros(16)
    with pytest.raises(ValueError, match="state must be"):
        rc.trace_round(state[:8].contiguous(), rows, scal, params, 1)
    with pytest.raises(ValueError, match="contiguous float32"):
        rc.trace_round(state.double(), rows, scal, params, 1)
    with pytest.raises(ValueError, match="round budget"):
        rc.trace_round(state, rows, scal, params, 0)
    meta = [x.to("meta") for x in (state, rows, scal)]
    with pytest.raises(ValueError, match="no trace kernel for device meta"):
        rc.trace_round(*meta, params, 1)


def test_trace_round_routes_by_row_count():
    """Every scene of the rows route (fewer than 512 triangles) takes K1's
    one-chunk branch; more rows than one chunk holds take the multi-chunk
    branch; a negative count raises."""
    assert rc.k1_branch(0) == rc.k1_branch(16) == "one_chunk"
    assert rc.k1_branch(rc.K1_CHUNK_ROWS) == "one_chunk"
    assert rc.k1_branch(rc.K1_CHUNK_ROWS + 1) == "multi_chunk"
    assert rc.k1_branch(19856) == "multi_chunk"  # the office, every row
    # the rows route's largest scene, trimmed to whole blocks of 16 rows
    from audiorenderingv2_tpu_torch import tuned
    assert rc.k1_branch(-(-(tuned.CLUSTER_THRESHOLD - 1) // 16) * 16) \
        == "one_chunk"
    with pytest.raises(ValueError, match="row count"):
        rc.k1_branch(-1)


def test_trace_round_rejects_bad_rows_and_poses():
    """The wrapper refuses rows of the wrong width, scalar rows of the wrong
    shape and pose batches that do not tile the state, before it picks a
    branch or a device."""
    _, sct, _ = _setup("box")
    params = _tparams(ar.TraceParams(sample_rate=SR, ir_length=SR))
    rows = rc.pack_tris_rows(sct)
    state = rc.init_state(torch.from_numpy(_dirs(256, 0)), torch.zeros(3),
                          1.0, 256)
    with pytest.raises(ValueError, match="tris must be"):
        rc.trace_round(state, rows[:, :16].contiguous(), torch.zeros(16),
                       params, 1)
    with pytest.raises(ValueError, match="scal must be"):
        rc.trace_round(state, rows, torch.zeros(12), params, 1)
    with pytest.raises(ValueError, match="do not make"):
        rc.trace_round(state, rows, torch.zeros((3, 16)), params, 1, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        rc.trace_round(state, rows, torch.zeros((4, 16)), params, 1, 64)
    before = rc.launches, rc.posed_launches
    rc.trace_round(state, rows, torch.zeros((2, 16)), params, 1, 128)
    assert (rc.launches, rc.posed_launches) == before  # the CPU: no kernel


@pytest.mark.parametrize("backend", ["kernels", "autograd"])
@pytest.mark.parametrize("jax_route", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("bounces", [16, 100])
def test_trace_ir_with_stats_matches_jax(bounces, jax_route, backend):
    """``with_stats`` against JAX ``trace_ir(with_stats=True)`` on the box,
    1000 rays (the kernels route pads them to 1024): the same IR as
    without it, and each ray's completed bounces with an equal sum and an
    equal sorted vector (exact: these are counts). The rays are permuted by
    the alive-first partition, so the vectors are compared sorted, zero
    padded to one length (padding rays count 0)."""
    sc, sct, rec = _setup("box")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=bounces)
    n, n_pad = 1000, 1024
    d = _dirs(n, bounces)
    j_opts = (ar.TracerOptions(block_size=1024, tri_chunk=128)
              if jax_route == "xla" else
              ar.TracerOptions(backend="pallas", pallas_interpret=True,
                               pallas_version=2))
    _, j_stats = ar.trace_ir(sc, jnp.asarray(d), jnp.zeros(3),
                             jnp.asarray(rec), 25.0, params, j_opts,
                             with_stats=True)
    t_opts = t_tracer.TracerOptions(backend=backend)
    args = (sct, torch.from_numpy(d), np.zeros(3), rec, 25.0,
            _tparams(params), t_opts)
    ir, stats = t_tracer.trace_ir(*args, with_stats=True)
    assert torch.equal(ir, t_tracer.trace_ir(*args))
    got = stats["bounces"]
    assert got.dtype == torch.float32
    assert got.shape == ((n_pad,) if backend == "kernels" else (n,))
    ref = np.asarray(j_stats["bounces"])

    def padded_sorted(x):
        return np.sort(np.pad(x, (0, n_pad - x.shape[0])))

    assert float(got.sum()) == float(ref.sum()) > n
    np.testing.assert_array_equal(padded_sorted(got.numpy()),
                                  padded_sorted(ref))
    assert got.max() <= bounces


def test_render_ir_native_rng_with_stats_counts_its_own_directions():
    """The ``native_rng`` branch of ``render_ir`` returns the bounces too:
    the same vector as ``trace_ir`` with stats on the directions K4
    generated from the generator's seed (the CPU runs K4's plain
    version)."""
    _, sct, rec = _setup("box")
    params = _tparams(ar.TraceParams(sample_rate=SR, ir_length=SR,
                                     base_power=3.62, max_bounces=12))
    opts = t_tracer.TracerOptions(native_rng=True)
    n = 500
    ir, stats = t_tracer.render_ir(sct, torch.Generator().manual_seed(3), n,
                                   np.zeros(3), rec, 0.0, params, opts,
                                   with_stats=True)
    seed = torch.randint(0, 2**23, (), generator=torch.Generator()
                         .manual_seed(3))
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    scal = rc.scalars(torch.zeros(3), torch.from_numpy(rec), 0.0, e0, params)
    scal[rc._S_PAD14] = seed.to(torch.float32)
    d = rc.init_state_native(scal, 512, n)[rc._C_VX:rc._C_VZ + 1, :n].T
    ir2, want = t_tracer.trace_ir(sct, d.contiguous(), np.zeros(3), rec, 0.0,
                                  params, t_tracer.TracerOptions(),
                                  with_stats=True)
    assert torch.equal(ir, ir2)
    assert torch.equal(stats["bounces"], want["bounces"])
    assert stats["bounces"].shape == (512,)
    assert float(stats["bounces"].sum()) > n
