"""The port's version-1 path (K7: its triangle table, its plain version,
the row-major rounds and ``trace_ir`` with ``version=1``) against the JAX
package's version-1 kernel in interpret mode, on the same scene arrays and
the same numpy directions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import tracer as j_tracer
from audiorenderingv2_tpu.ops import raytrace_pallas as rp
from audiorenderingv2_tpu_torch import constants, convert
from audiorenderingv2_tpu_torch import multi as t_multi
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import v1_cuda
from audiorenderingv2_tpu_torch.renderer import AudioRenderer

torch.set_num_threads(1)

SR = 16000
K7 = rc.Route("k7")  # the version-1 kernel, the row partition
# name -> (mesh, receiver, triangle count the arrays are padded to)
SCENES = {
    "box": (lambda: jt.box_room((12.0, 8.0, 10.0)), [2.0, 0.0, 1.0], 128),
    "ico": (lambda: jt.icosphere(radius=6.0, subdivisions=2),
            [1.5, 0.5, -1.0], 384),                 # 320 -> 384 columns
    "ico512": (lambda: jt.icosphere(radius=6.0, subdivisions=2),
               [1.5, 0.5, -1.0], 512),              # four 128-column chunks
    # the same with every third valid flag zeroed: invalid columns inside
    # the table, not only after its last valid one
    "ico512_mid": (lambda: jt.icosphere(radius=6.0, subdivisions=2),
                   [1.5, 0.5, -1.0], 512),
}


def _np(sc):
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


def _setup(name, absorption=0.3):
    fn, rec, t_pad = SCENES[name]
    v, t = fn()
    sc = ar.scene_to_arrays(jt.scene_from_arrays(v, t, absorption), 128)
    extra = t_pad - sc.valid.shape[0]  # further padding triangles, all zero
    sc = sc._replace(**{
        k: jnp.pad(x, ((0, extra),) + ((0, 0),) * (x.ndim - 1))
        for k, x in sc._asdict().items() if x is not None})
    if name.endswith("_mid"):
        sc = sc._replace(valid=sc.valid.at[:t.shape[0]:3].set(0.0))
    return sc, convert.scene_arrays_from_jax(
        _np(sc), device="cpu"), np.asarray(rec, np.float32)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _popts(**kw):
    return ar.TracerOptions(backend="pallas", pallas_version=1,
                            pallas_interpret=True, rays_per_tile=128, **kw)


# --------------------------------------------------------------- packing

@pytest.mark.parametrize("name,n_cols", [("box", 128), ("ico", 384),
                                         ("ico512", 512)])
def test_pack_tris_v1_equals_jax(name, n_cols):
    """The [17, T] table bit for bit: no trim, absorption before valid."""
    sc, sct, _ = _setup(name)
    ref = np.asarray(rp.pack_tris(sc))
    got = rc.pack_tris_v1(sct)
    assert got.shape == ref.shape == (17, n_cols)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got[15], sct.absorption)
    assert torch.equal(got[16], sct.valid)
    packed, boxes = rc.pack_scene(sct, route=K7)
    assert boxes is None and torch.equal(packed, got)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_table_as_rows_equals_k1_rows(name):
    """The rows K7 stages from its table are K1's rows: ``_table_as_rows``
    of the [17, T] table equals ``pack_tris_rows`` (trimmed past the last
    valid triangle), and the table's later columns are all invalid."""
    _, sct, _ = _setup(name)
    rows = rc.pack_tris_rows(sct)
    staged = v1_cuda._table_as_rows(rc.pack_tris_v1(sct))
    assert torch.equal(staged[:rows.shape[0]], rows)
    assert not (staged[rows.shape[0]:, rc._R_VAL] > 0).any()
    if name.endswith("_mid"):
        assert not (rows[:-1:3, rc._R_VAL] > 0).any()


def _cut_after_last_valid(tris: torch.Tensor) -> torch.Tensor:
    return tris[:, :int(torch.nonzero(tris[16] > 0).max()) + 1].contiguous()


@pytest.mark.parametrize("budget", [6, 12])
@pytest.mark.parametrize("name", ["box", "ico512", "ico512_mid"])
def test_plain_over_the_cut_table_equals_untrimmed(name, budget):
    """K7 stops its search at the last valid column. That is exact: the
    plain version over the table cut right after that column equals the
    plain version over the whole table bit for bit, from the start state
    and from the state after a round and the partition."""
    _, sct, rec = _setup(name)
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=30))
    n = 768
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    tris = rc.pack_tris_v1(sct)
    cut = _cut_after_last_valid(tris)
    assert cut.shape[1] < tris.shape[1]
    state = rc.init_state(torch.from_numpy(_dirs(n, 6)), torch.zeros(3), e0,
                          n).T.contiguous()
    scal = rc.scalars(torch.zeros(3), torch.from_numpy(rec), 25.0, e0,
                      params)
    for _ in range(2):
        full = v1_cuda.trace_round_v1_plain(state.clone(), tris, scal, params,
                                            budget)
        trimmed = v1_cuda.trace_round_v1_plain(state.clone(), cut, scal,
                                               params, budget)
        assert torch.equal(full, trimmed)
        assert (full[:, rc._C_DEPTH] > state[:, rc._C_DEPTH]).any()
        state = rc._partition_alive_first(full, ray_dim=0)


@pytest.mark.parametrize("n_cols,branch", [
    (0, "one_chunk"), (128, "one_chunk"),        # the box's table
    (v1_cuda.V1_CHUNK_COLS, "one_chunk"),        # the icosphere at 512
    (v1_cuda.V1_CHUNK_COLS + 128, "multi_chunk"),
    (1280, "multi_chunk"),                       # 1,280-triangle icosphere
    (19968, "multi_chunk"),                      # the office, never clustered
    (-1, None),
])
def test_v1_branch_routes_by_column_count(n_cols, branch):
    """Tables up to K1's chunk take the one-chunk branch (staged once a
    block, the persistent grid in long rounds), larger ones the
    block-synchronous branch; a negative count raises."""
    assert v1_cuda.V1_CHUNK_COLS == rc.K1_CHUNK_ROWS
    if branch is None:
        with pytest.raises(ValueError, match="column count"):
            v1_cuda.v1_branch(n_cols)
    else:
        assert v1_cuda.v1_branch(n_cols) == branch


def test_pack_tris_v1_errors():
    _, sct, _ = _setup("box")
    cut = sct._replace(**{k: v[:96] for k, v in sct._asdict().items()
                          if v is not None})
    with pytest.raises(ValueError, match="not a multiple of 128"):
        rc.pack_tris_v1(cut)
    banded = sct._replace(absorption=sct.absorption[:, None].repeat(1, 3))
    with pytest.raises(ValueError, match="one absorption band"):
        rc.pack_tris_v1(banded)
    # a [T, 1] table is one band
    one = sct._replace(absorption=sct.absorption[:, None])
    assert torch.equal(rc.pack_tris_v1(one), rc.pack_tris_v1(sct))
    # version 1 ignores cluster boxes: it never culls
    boxed = sct._replace(cluster_boxes=torch.zeros((1, 8)))
    assert rc.pack_scene(boxed, route=K7)[1] is None
    params = convert.trace_params_from_jax(ar.TraceParams(sample_rate=SR,
                                                          ir_length=SR))
    assert t_tracer.packed_scene(boxed, params, rc.pack_tris_v1(sct),
                                 torch.zeros((1, 8)),
                                 t_tracer.TracerOptions(version=1))[1] is None


# ------------------------------------------------------------- one round

# Tolerances against the Pallas kernel in interpret mode, as
# tests/test_torch_trace.py measured them for K1: XLA's CPU backend
# contracts multiply-adds into FMAs, the port rounds each operation, so the
# states drift by a few ulp per bounce; 1e-5 after one bounce, 1e-4 after
# eight.
ROUND_TOL = {1: 1e-5, 8: 1e-4}


@pytest.mark.parametrize("budget", [1, 8])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_round_v1_plain_matches_pallas_kernel(name, budget):
    """Every column of the row-major state; columns 13-15 are zeros."""
    sc, sct, rec = _setup(name)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=20)
    n = 512
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rp.init_state(jnp.asarray(_dirs(n, 1)), jnp.zeros(3), e0, n)
    state = state.at[:, rp._C_RAYID].set(7.0)  # the kernel must zero it
    scal = rp._scalars(jnp.zeros(3), jnp.asarray(rec),
                       jnp.deg2rad(jnp.float32(25.0)), e0, params)
    ref = np.asarray(rp.trace_round(state, rp.pack_tris(sc), scal, params,
                                    128, budget, interpret=True))
    got = v1_cuda.trace_round_v1(
        torch.tensor(np.asarray(state)), rc.pack_tris_v1(sct),
        torch.tensor(np.asarray(scal)[0]),
        convert.trace_params_from_jax(params), budget).numpy()
    assert got.shape == ref.shape == (n, 16)
    tol = ROUND_TOL[budget]
    for c in range(13):
        np.testing.assert_allclose(got[:, c], ref[:, c], rtol=tol, atol=tol,
                                   err_msg=f"column {c}")
    assert not got[:, 13:].any() and not ref[:, 13:].any()
    assert (ref[:, rc._C_DEPTH] > 0).any() and (ref[:, rc._C_EVW] > 0).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_v1_round_equals_rows_round(name):
    """In the port K7's plain version equals K1's in columns 0-12, bit for
    bit: the same operations in the same order over another layout."""
    _, sct, rec = _setup(name)
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=20))
    n = 640
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(torch.from_numpy(_dirs(n, 2)), torch.zeros(3), e0,
                          n)
    scal = rc.scalars(torch.zeros(3), torch.from_numpy(rec), 25.0, e0,
                      params)
    rows = rc.trace_round(state.clone(), rc.pack_tris_rows(sct), scal,
                          params, 8)
    v1 = v1_cuda.trace_round_v1(state.T.contiguous(), rc.pack_tris_v1(sct),
                                scal, params, 8)
    assert torch.equal(v1[:, :13], rows[:13].T)
    assert not v1[:, 13:].any() and rows[rc._C_LTRI].any()


def test_partition_of_a_row_major_state_matches_jax():
    rng = np.random.default_rng(5)
    state = rng.normal(size=(300, 16)).astype(np.float32)
    state[:, rp._C_DONE] = rng.random(300) < 0.6
    ref = np.asarray(rp._partition_alive_first(jnp.asarray(state)))
    got = rc._partition_alive_first(torch.from_numpy(state), ray_dim=0)
    np.testing.assert_array_equal(got.numpy(), ref)
    cols = rc._partition_alive_first(torch.from_numpy(state.T.copy()))
    np.testing.assert_array_equal(cols.numpy(), ref.T)


# ------------------------------------------------------------ whole path

@pytest.mark.parametrize("name,n_rays,budgets", [
    ("box", 2048, None),            # default budgets (6, 2) at 8 bounces
    ("box", 1000, (2, 3, 3)),       # explicit budgets; 1000 pads to 1024
    ("ico", 2048, None),
    ("ico512", 1000, (3, 5)),       # four 128-column chunks
])
def test_trace_ir_v1_matches_jax(name, n_rays, budgets):
    """``trace_ir`` with ``version=1`` against the JAX package's, through
    the converted options, on the reference's statistical bar; and in the
    port the version-1 IR against the rows IR within 1e-6 relative L1
    (found: bit-equal on the CPU)."""
    sc, sct, rec = _setup(name)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=8)
    popts = _popts(pallas_round_budgets=budgets)
    topts = convert.tracer_options_from_jax(popts)
    assert (topts.version, topts.layout, topts.round_budgets) == \
        (1, "rows", budgets)
    d = _dirs(n_rays, 4)
    ref = np.asarray(ar.trace_ir(sc, jnp.asarray(d), jnp.zeros(3),
                                 jnp.asarray(rec), 25.0, params, popts))
    tparams = convert.trace_params_from_jax(params)
    got = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), rec, 25.0,
                            tparams, topts).numpy()
    assert got.shape == ref.shape == (2, SR) and ref.sum() > 0
    jt.assert_ir_close(got, ref, exact=False)
    rows_ir = t_tracer.trace_ir(
        sct, torch.from_numpy(d), np.zeros(3), rec, 25.0, tparams,
        t_tracer.TracerOptions(round_budgets=budgets)).numpy()
    rel_l1 = np.abs(got - rows_ir).sum() / np.abs(rows_ir).sum()
    assert rel_l1 <= 1e-6, rel_l1
    np.testing.assert_array_equal(got, rows_ir)


def test_trace_events_v1_rounds_match_jax():
    """Default budgets at 20 bounces are (6, 14): two rounds with the row
    partition between them, every event column against the JAX rounds."""
    sc, sct, rec = _setup("box")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=20)
    assert rc._round_schedule(20) == rp._round_schedule(20) == [6, 14]
    assert rc._round_schedule(100) == [6, 12, 24, 58]
    d = _dirs(1000, 2)
    ref = rp.trace_events_pallas(
        rp.pack_tris(sc), jnp.asarray(d), jnp.zeros(3), jnp.asarray(rec),
        10.0, params, rays_per_tile=128, interpret=True, version=1)
    got = rc.trace_events(rc.pack_tris_v1(sct), torch.from_numpy(d),
                          torch.zeros(3), torch.from_numpy(rec), 10.0,
                          convert.trace_params_from_jax(params), route=K7)
    assert got[1].shape == (1024, 1) and got[2].dtype == torch.int32
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert r.shape == tuple(g.shape)
        # the bars of tests/test_torch_trace.py for several rounds
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())
    assert np.count_nonzero(np.asarray(ref[1])) > 50


def test_v1_with_bands_runs_the_differentiable_tracer(monkeypatch):
    """Version 1 carries one band; with more, both packages trace through
    their differentiable tracer instead of a kernel, and agree."""
    v, t = jt.box_room((9.0, 7.0, 8.0))
    absorb = np.tile(np.array([[0.1, 0.4, 0.7]], np.float32), (12, 1))
    sc = ar.scene_to_arrays(jt.scene_from_arrays(v, t, absorb), 128)
    sct = convert.scene_arrays_from_jax(_np(sc), device="cpu")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=6, n_bands=3)
    tparams = convert.trace_params_from_jax(params)
    d = _dirs(1024, 7)
    rec = np.array([1.0, 0.5, -1.0], np.float32)

    def no_kernel(*a, **k):
        raise AssertionError("version 1 with 3 bands reached K7")

    monkeypatch.setattr(v1_cuda, "trace_round_v1", no_kernel)
    monkeypatch.setattr(rp, "trace_round", no_kernel)
    popts = _popts(block_size=512, tri_chunk=128)
    ref = np.asarray(ar.trace_ir(sc, jnp.asarray(d), jnp.zeros(3),
                                 jnp.asarray(rec), 0.0, params, popts))
    topts = convert.tracer_options_from_jax(popts)
    assert t_tracer.trace_route(topts, tparams.n_bands, False) is None
    assert t_tracer.trace_route(topts, 1, False) == K7
    got = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), rec, 0.0,
                            tparams, topts)
    assert got.shape == ref.shape == (2, 3, SR)
    jt.assert_ir_close(got.numpy().reshape(6, SR), ref.reshape(6, SR),
                       exact=False)
    auto = t_tracer.trace_ir(
        sct, torch.from_numpy(d), np.zeros(3), rec, 0.0, tparams,
        t_tracer.TracerOptions(backend="autograd", block_size=512,
                               tri_chunk=128))
    assert torch.equal(got, auto)
    # a renderer of that scene packs nothing for a kernel that will not run
    r = AudioRenderer(tt.scene_from_arrays(v, t, absorb), 1, SR, 256,
                      max_bounces=4, opts=t_tracer.TracerOptions(version=1),
                      device="cpu")
    assert r.rows is None and r.render().shape == (2, 3, SR)


# ----------------------------------------------------- options and gates

def test_v1_refuses_what_jax_refuses():
    """No in-kernel directions, no pose batch, one band in the kernel."""
    sc, sct, rec = _setup("box")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, max_bounces=4)
    tparams = convert.trace_params_from_jax(params)
    tris = rc.pack_tris_v1(sct)
    with pytest.raises(ValueError, match="directions=None needs version=2"):
        rc.trace_events(tris, None, torch.zeros(3), torch.from_numpy(rec),
                        0.0, tparams, route=K7, n_rays=128,
                        native_rng_seed=torch.tensor(3))
    with pytest.raises(ValueError, match="directions=None needs version=2"):
        rp.trace_events_pallas(rp.pack_tris(sc), None, jnp.zeros(3),
                               jnp.asarray(rec), 0.0, params, version=1,
                               n_rays=128, native_rng_seed=jnp.int32(3))
    em = np.zeros((2, 3), np.float32)
    rcv = np.tile(rec, (2, 1))
    with pytest.raises(ValueError, match="requires the kernels backend "
                                         "with version=2"):
        t_tracer.render_ir_pose_batch(sct, 0, 128, em, rcv, np.zeros(2),
                                      tparams,
                                      t_tracer.TracerOptions(version=1))
    import jax

    with pytest.raises(ValueError, match="pallas_version=2"):
        j_tracer.render_ir_pose_batch(sc, jax.random.PRNGKey(0), 128,
                                      jnp.asarray(em), jnp.asarray(rcv),
                                      jnp.zeros(2), params, _popts())
    banded = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, n_bands=2))
    with pytest.raises(ValueError, match="carries one band"):
        rc.trace_events(tris, torch.from_numpy(_dirs(128, 0)),
                        torch.zeros(3), torch.from_numpy(rec), 0.0, banded,
                        route=K7)
    # native_rng with version 1 samples its directions, as in the JAX
    # package: the render runs and draws from the generator
    g = torch.Generator().manual_seed(1)
    ir = t_tracer.render_ir(sct, g, 256, np.zeros(3), rec, 0.0, tparams,
                            t_tracer.TracerOptions(version=1,
                                                   native_rng=True))
    assert float(ir.sum()) > 0


def test_matrix_with_version_1_renders_pair_by_pair():
    """The fused pose batch is version 2's; a version-1 matrix is one
    render_ir per pair, equal to the rows matrix."""
    _, sct, rec = _setup("box")
    tparams = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=5))
    em = np.array([[0.0, 0.0, 0.0]], np.float32)
    rcv = np.array([rec, [-2.0, 1.0, 2.0]], np.float32)
    v1 = t_multi.render_ir_matrix(sct, 3, em, rcv, 0.0, 512, tparams,
                                  t_tracer.TracerOptions(version=1))
    rows = t_multi.render_ir_matrix(
        sct, 3, em, rcv, 0.0, 512, tparams,
        t_tracer.TracerOptions(round_budgets=(5,)))
    assert v1.shape == (1, 2, 2, SR) and v1.sum() > 0
    np.testing.assert_array_equal(v1, rows)


def test_renderer_version_1_never_clusters():
    """A 1280-triangle scene: explicit version-2 options cluster it,
    version 1 keeps it whole and packs the [17, T] table."""
    v, t = tt.icosphere(radius=6.0, subdivisions=3)
    scene = tt.scene_from_arrays(v, t, 0.2)
    r1 = AudioRenderer(scene, 1, SR, 256, max_bounces=3, device="cpu",
                       opts=t_tracer.TracerOptions(version=1), seed=2)
    assert r1.sc.cluster_boxes is None and r1.boxes is None
    assert r1.rows.shape == (17, 1280)
    r2 = AudioRenderer(scene, 1, SR, 256, max_bounces=3, device="cpu",
                       opts=t_tracer.TracerOptions(), seed=2)
    assert r2.sc.cluster_boxes is not None
    for r in (r1, r2):
        r.set_receiver((1.5, 0.5, -1.0), 10.0)
    a, b = r1.render(), r2.render()
    assert a.sum() > 0
    # the clustered scene is the same triangles in Morton order: the same
    # physics, summed in another order
    tt.assert_ir_close(a, b, exact=False)


def test_trace_round_v1_rejects_bad_inputs():
    """The wrapper checks before it dispatches; a device with no kernel
    raises instead of running the plain version."""
    _, sct, _ = _setup("box")
    params = convert.trace_params_from_jax(ar.TraceParams(sample_rate=SR,
                                                          ir_length=SR))
    tris = rc.pack_tris_v1(sct)
    state = rc.init_state(torch.from_numpy(_dirs(128, 0)), torch.zeros(3),
                          1.0, 128).T.contiguous()
    scal = torch.zeros(16)
    with pytest.raises(ValueError, match="row-major"):
        v1_cuda.trace_round_v1(state.T.contiguous(), tris, scal, params, 1)
    with pytest.raises(ValueError, match="contiguous float32"):
        v1_cuda.trace_round_v1(state.T, tris, scal, params, 1)
    with pytest.raises(ValueError, match="tris must be"):
        v1_cuda.trace_round_v1(state, tris[:16].contiguous(), scal, params,
                               1)
    with pytest.raises(ValueError, match="not a multiple of 128"):
        v1_cuda.trace_round_v1(state, tris[:, :100].contiguous(), scal,
                               params, 1)
    with pytest.raises(ValueError, match="scal must be"):
        v1_cuda.trace_round_v1(state, tris, torch.zeros((2, 16)), params, 1)
    with pytest.raises(ValueError, match="round budget"):
        v1_cuda.trace_round_v1(state, tris, scal, params, 0)
    meta = [x.to("meta") for x in (state, tris, scal)]
    with pytest.raises(ValueError, match="no trace kernel for device meta"):
        v1_cuda.trace_round_v1(*meta, params, 1)


def test_cpu_v1_call_launches_no_kernel():
    _, sct, rec = _setup("box")
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=6))
    v1_cuda.trace_round_v1_launches = rc.launches = 0
    ir = t_tracer.trace_ir(sct, torch.from_numpy(_dirs(512, 3)), np.zeros(3),
                           rec, 0.0, params,
                           t_tracer.TracerOptions(version=1))
    assert ir.device.type == "cpu" and float(ir.sum()) > 0
    assert v1_cuda.trace_round_v1_launches == 0 and rc.launches == 0
