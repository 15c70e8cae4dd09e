"""The port's group-layout path (K6: its packing, its plain version, the
rounds and ``trace_ir`` with ``layout="group"`` at both precisions, the
posed batch) against the JAX package's group branch in interpret mode, on
the same scene arrays and the same numpy directions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.core import tracer as j_tracer
from audiorenderingv2_tpu.renderer import AudioRenderer as JAudioRenderer
from audiorenderingv2_tpu.ops import raytrace_pallas as rp
from audiorenderingv2_tpu.ops import raytrace_pallas_v2 as rp2
from audiorenderingv2_tpu_torch import constants, convert
from audiorenderingv2_tpu_torch.core import sampling as t_sampling
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.diff import replay as t_replay
from audiorenderingv2_tpu_torch.ops import group_cuda as gc
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
from audiorenderingv2_tpu_torch import testing as tt

torch.set_num_threads(1)

SR = 16000
SCENES = {
    "box": (lambda: jt.box_room((12.0, 8.0, 10.0)), [2.0, 0.0, 1.0]),
    "ico": (lambda: jt.icosphere(radius=6.0, subdivisions=2),
            [1.5, 0.5, -1.0]),
}


def _np(sc):
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


def _absorption(n_tris, n_bands):
    if n_bands == 1:
        return 0.3
    return np.tile(np.linspace(0.1, 0.6, n_bands, dtype=np.float32),
                   (n_tris, 1))


def _setup(name, n_bands=1, tri_chunk=128):
    fn, rec = SCENES[name]
    v, t = fn()
    scene = jt.scene_from_arrays(v, t, _absorption(t.shape[0], n_bands))
    sc = ar.scene_to_arrays(scene, tri_chunk)
    return sc, convert.scene_arrays_from_jax(
        _np(sc), device="cpu"), np.asarray(rec, np.float32)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _popts(**kw):
    return ar.TracerOptions(backend="pallas", pallas_version=2,
                            pallas_interpret=True, pallas_layout="group",
                            **kw)


# --------------------------------------------------------------- packing

def _variant(sc, variant):
    """The JAX scene arrays as the packing cases need them."""
    if variant == "interior_invalid":   # a degenerate face inside the list
        return sc._replace(valid=sc.valid.at[5].set(0.0))
    if variant == "untrimmed":          # the last valid triangle in the last
        return sc._replace(**{         # group: 12 valid of 16, nothing to cut
            k: v[:16] for k, v in sc._asdict().items() if v is not None})
    return sc


@pytest.mark.parametrize("n_bands", [1, 4, 6])
@pytest.mark.parametrize("name,variant", [
    ("box", "plain"),             # 12 valid of 128: trimmed to 2 groups
    ("ico", "plain"),             # 320 valid of 384: trimmed to 40 groups
    ("box", "interior_invalid"),
    ("box", "untrimmed"),
])
def test_pack_tris_group_equals_jax(name, variant, n_bands):
    """Coefficients and attributes bit for bit, the trim at the last valid
    index by whole groups of 8 included."""
    sc, _, _ = _setup(name, n_bands)
    sc = _variant(sc, variant)
    sct = convert.scene_arrays_from_jax(_np(sc), device="cpu")
    ref_c, ref_a, ref_b = rp2.pack_tris_v2(sc, n_bands, layout="group")
    coeffs, attrs = rc.pack_tris_group(sct, n_bands)
    assert ref_b is None
    np.testing.assert_array_equal(coeffs.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(attrs.numpy(), np.asarray(ref_a))
    groups = {"box": 2, "ico": 40}[name]
    assert coeffs.shape == (groups * 48, 8)
    assert attrs.shape == (groups * 8, rc.attr_cols(n_bands))
    assert attrs.shape[1] == (8 if n_bands <= 4 else 16)
    n_valid = {"plain": 12 if name == "box" else 320,
               "interior_invalid": 11, "untrimmed": 12}[variant]
    assert int((attrs[:, 3 + n_bands] > 0).sum()) == n_valid
    (packed, none) = rc.pack_scene(sct, n_bands, rc.Route("k6"))
    assert none is None and torch.equal(packed[0], coeffs)


def test_pack_tris_group_errors():
    """The errors of ``pack_tris_v2``: a count not a multiple of 8, more
    than 8 bands, a band mismatch, cluster boxes."""
    sc, sct, _ = _setup("box", 3)
    cut = sct._replace(**{k: v[:12] for k, v in sct._asdict().items()
                          if v is not None})
    with pytest.raises(ValueError, match="not a multiple of 8"):
        rc.pack_tris_group(cut, 3)
    with pytest.raises(ValueError, match="at most 8 bands"):
        rc.pack_tris_group(sct, 9)
    with pytest.raises(ValueError, match="only 1-band scenes broadcast"):
        rc.pack_tris_group(sct, 4)
    with pytest.raises(ValueError, match="only 1-band"):
        rp2.pack_tris_v2(sc, 4, layout="group")
    boxed = sct._replace(cluster_boxes=torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="cannot carry cluster boxes"):
        rc.pack_tris_group(boxed, 3)
    with pytest.raises(ValueError, match="cannot carry cluster boxes"):
        rp2.pack_tris_v2(sc._replace(cluster_boxes=jnp.zeros((1, 8))), 3,
                         layout="group")
    # a one-band scene broadcasts over the bands, as in the rows layout
    _, one, _ = _setup("box", 1)
    attrs = rc.pack_tris_group(one, 4)[1]
    assert torch.all(attrs[:12, 3:7] == attrs[:12, 3:4])


# ------------------------------------------------------------- one round

# Tolerances against the Pallas kernel in interpret mode, as
# tests/test_torch_trace.py measured them for K1: XLA's CPU backend
# contracts multiply-adds into FMAs (and sums its dot in its own order), the
# port rounds each operation, so the states drift by a few ulp per bounce;
# 1e-5 after one bounce, 1e-4 after eight.
ROUND_TOL = {1: 1e-5, 8: 1e-4}


@pytest.mark.parametrize("budget", [1, 8])
@pytest.mark.parametrize("name,n_bands", [("box", 1), ("ico", 1),
                                          ("box", 4)])
def test_trace_round_group_plain_matches_pallas_kernel(name, n_bands,
                                                       budget):
    """Every state column; LTRI and RECVD (integers) exactly."""
    sc, sct, rec = _setup(name, n_bands)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=20, n_bands=n_bands)
    n = 512
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    ncols = rp2.state_ncols(n_bands)
    state = rp.init_state(jnp.asarray(_dirs(n, 1)), jnp.zeros(3), e0, n,
                          ncols=ncols,
                          en_cols=tuple(rp2._band_cols(n_bands)[0]))
    state = state.at[:, rp._C_RECVD].set(-1.0)
    scal = rp._scalars(jnp.zeros(3), jnp.asarray(rec),
                       jnp.deg2rad(jnp.float32(25.0)), e0, params)
    coeffs, attrs, _ = rp2.pack_tris_v2(sc, n_bands, layout="group")
    ref = rp2.trace_round_v2(rp2.to_tiles(state), coeffs, attrs, None, scal,
                             params, budget, interpret=True)
    ref = np.asarray(rp2.from_tiles(ref)).T  # [ncols, N]

    got = gc.trace_round_group(
        torch.tensor(np.asarray(state).T.copy()),
        *rc.pack_tris_group(sct, n_bands), torch.tensor(np.asarray(scal)[0]),
        convert.trace_params_from_jax(params), budget)
    assert got.shape == ref.shape == (ncols, n)
    tol = ROUND_TOL[budget]
    for c in range(ncols):
        np.testing.assert_allclose(got[c].numpy(), ref[c], rtol=tol,
                                   atol=tol, err_msg=f"column {c}")
    np.testing.assert_array_equal(got[rc._C_LTRI].numpy(), ref[rc._C_LTRI])
    np.testing.assert_array_equal(got[rc._C_RECVD].numpy(),
                                  ref[rc._C_RECVD])
    assert (ref[rc._C_LTRI] > 0).any() and (ref[rc._C_DEPTH] > 0).any()
    assert (ref[rc._C_RECVD] >= 0).any()


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_group_round_against_rows_round(precision):
    """In the port, K6's plain version at f32 equals K1's in every column,
    bit for bit: the packing's zeros add exactly in the eight-term sums.
    With the bf16 split the geometry moves by about 2^-17 relative: the
    columns stay within 1e-3 of K1's, except for the rare ray that the
    perturbation moves across a triangle edge."""
    _, sct, rec = _setup("ico")
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=20))
    n = 1024
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(torch.from_numpy(_dirs(n, 2)), torch.zeros(3), e0,
                          n)
    scal = rc.scalars(torch.zeros(3), torch.from_numpy(rec), 25.0, e0,
                      params)
    rows = rc.trace_round(state.clone(), rc.pack_tris_rows(sct), scal,
                          params, 8)
    group = gc.trace_round_group(state.clone(), *rc.pack_tris_group(sct),
                                 scal, params, 8, precision=precision)
    if precision == "highest":
        assert torch.equal(group, rows)
        return
    assert not torch.equal(group, rows)
    same_path = (group[rc._C_LTRI] == rows[rc._C_LTRI]) \
        & (group[rc._C_DEPTH] == rows[rc._C_DEPTH])
    assert float(same_path.float().mean()) > 0.99
    np.testing.assert_allclose(group[:, same_path].numpy(),
                               rows[:, same_path].numpy(), rtol=1e-3,
                               atol=1e-3)
    # the JAX package's alias "split3" is "high" once converted
    assert convert.tracer_options_from_jax(ar.TracerOptions(
        backend="pallas", pallas_precision="split3")).precision == "high"


def test_bf16_split_is_exact_in_three_terms():
    """x = hi + lo to about 2^-17 relative, hi and lo bf16 values."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32)) * 7.3
    hi, lo = gc._split_bf16(x)
    assert torch.equal(hi, hi.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(lo, lo.to(torch.bfloat16).to(torch.float32))
    rel = ((hi + lo - x).abs() / x.abs()).max()
    assert 0 < float(rel) < 2.0 ** -16


def test_posed_group_round_reads_each_rays_own_scalar_row():
    """scal [P, 16]: segment p equals a single-pose round with row p."""
    _, sct, _ = _setup("box")
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=20))
    p, n = 3, 256
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    d = torch.from_numpy(np.stack([_dirs(n, 5 + i) for i in range(p)]))
    em = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, -1.0], [-2.0, 0.5, 2.0]])
    rcv = torch.tensor([[2.0, 0.0, 1.0], [-3.0, 1.0, 0.0], [0.0, -2.0, 3.0]])
    yaw = torch.tensor([0.0, 45.0, -90.0])
    scal = rc.scalars(em, rcv, yaw, e0, params)
    state = rc.init_state(d, em, e0, n)
    packed = rc.pack_tris_group(sct)
    batch = gc.trace_round_group(state.clone(), *packed, scal, params, 6, n)
    for i in range(p):
        seg = slice(i * n, (i + 1) * n)
        one = gc.trace_round_group(state[:, seg].clone(), *packed, scal[i],
                                   params, 6)
        assert torch.equal(batch[:, seg], one), f"pose {i}"


# ------------------------------------------------------------ whole path

@pytest.mark.parametrize("name,n_bands,precision", [
    ("box", 1, "highest"), ("ico", 1, "highest"), ("box", 4, "highest"),
    ("box", 1, "high"), ("ico", 1, "high"),
])
def test_trace_ir_group_matches_jax(name, n_bands, precision):
    """``trace_ir`` with the group layout against the JAX package's, through
    the converted options, on the reference's statistical bar; and in the
    port the group IR at f32 against the rows IR within 1e-6 relative L1
    (found: bit-equal on the CPU)."""
    sc, sct, rec = _setup(name, n_bands)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=6, n_bands=n_bands)
    popts = _popts(pallas_precision=precision)
    topts = convert.tracer_options_from_jax(popts)
    assert (topts.layout, topts.version, topts.precision) == \
        ("group", 2, precision)
    d = _dirs(2048, 4)
    ref = np.asarray(ar.trace_ir(sc, jnp.asarray(d), jnp.zeros(3),
                                 jnp.asarray(rec), 25.0, params, popts))
    tparams = convert.trace_params_from_jax(params)
    got = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), rec, 25.0,
                            tparams, topts).numpy()
    assert got.shape == ref.shape and ref.sum() > 0
    flat = lambda m: m.reshape(-1, m.shape[-1])  # noqa: E731
    jt.assert_ir_close(flat(got), flat(ref), exact=False)
    rows_ir = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), rec,
                                25.0, tparams).numpy()
    rel_l1 = np.abs(got - rows_ir).sum() / np.abs(rows_ir).sum()
    if precision == "highest":
        assert rel_l1 <= 1e-6, rel_l1
        np.testing.assert_array_equal(got, rows_ir)
    else:
        jt.assert_ir_close(flat(got), flat(rows_ir), exact=False)


def test_trace_events_group_rounds_and_padding():
    """Rounds (2, 3, 3) with the partition between them, a ray count that is
    not a multiple of 128: the group route's events equal the rows route's
    in the port, and match the JAX rounds column by column."""
    sc, sct, rec = _setup("box")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=8)
    tparams = convert.trace_params_from_jax(params)
    d = _dirs(1000, 2)
    args = (torch.from_numpy(d), torch.zeros(3), torch.from_numpy(rec), 10.0,
            tparams)
    got = rc.trace_events(rc.pack_tris_group(sct), *args,
                          round_budgets=(2, 3, 3), route=rc.Route("k6"))
    rows = rc.trace_events(rc.pack_tris_rows(sct), *args,
                           round_budgets=(2, 3, 3))
    for g, r in zip(got, rows):
        assert torch.equal(g, r)
    ref = rp.trace_events_pallas(
        rp2.pack_tris_v2(sc, 1, layout="group"), jnp.asarray(d), jnp.zeros(3),
        jnp.asarray(rec), 10.0, params, interpret=True, version=2,
        round_budgets=(2, 3, 3))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())
    assert got[1].shape == (1024, 1) and torch.all(got[1][1000:] == 0)


def _shared_directions(monkeypatch, key, n_poses, n_rays, seed):
    """Make the port draw, for pose i, the directions JAX draws from
    fold_in(key, i)."""
    by_seed = {}
    for i in range(n_poses):
        d = np.asarray(j_sampling.sample_directions(
            jax.random.fold_in(key, i), n_rays))
        by_seed[t_sampling.pose_generator(seed, i, "cpu").initial_seed()] = d

    def fake(n, generator, device):
        return torch.tensor(by_seed[generator.initial_seed()], device=device)

    monkeypatch.setattr(t_sampling, "sample_directions", fake)


def test_render_ir_pose_batch_group_matches_jax(monkeypatch):
    """A 2-pose batch through the group layout: against JAX's batch on the
    statistical bar, and equal to the port's rows batch."""
    sc, sct, _ = _setup("box")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=6)
    popts = _popts(pallas_round_budgets=(2, 4))
    em = np.array([[0.0, 0.0, 0.0], [2.0, 1.0, -1.0]], np.float32)
    rcv = np.array([[3.0, 0.0, 1.0], [-2.0, -1.0, 2.0]], np.float32)
    yaw = np.array([0.0, 45.0], np.float32)
    key = jax.random.PRNGKey(9)
    n_rays = 1024
    ref = np.asarray(j_tracer.render_ir_pose_batch(
        sc, key, n_rays, jnp.asarray(em), jnp.asarray(rcv), jnp.asarray(yaw),
        params, popts))
    _shared_directions(monkeypatch, key, 2, n_rays, seed=5)
    tparams = convert.trace_params_from_jax(params)
    topts = convert.tracer_options_from_jax(popts)
    got = t_tracer.render_ir_pose_batch(sct, 5, n_rays, em, rcv, yaw,
                                        tparams, topts)
    assert got.shape == ref.shape == (2, 2, SR) and ref.sum() > 0
    jt.assert_ir_close(got.numpy().reshape(4, SR), ref.reshape(4, SR),
                       exact=False)
    rows = t_tracer.render_ir_pose_batch(
        sct, 5, n_rays, em, rcv, yaw, tparams,
        t_tracer.TracerOptions(round_budgets=(2, 4)))
    assert torch.equal(got, rows)


# ----------------------------------------------------- options and gates

def test_group_options_are_checked():
    with pytest.raises(ValueError, match="layout must be rows\\|group"):
        t_tracer.TracerOptions(layout="auto")
    with pytest.raises(ValueError, match="version must be 1 or 2"):
        t_tracer.TracerOptions(version=3)
    with pytest.raises(ValueError, match="corrupts positions"):
        t_tracer.TracerOptions(precision="default")
    with pytest.raises(ValueError, match="precision must be one of"):
        t_tracer.TracerOptions(precision="fp8")
    _, sct, rec = _setup("box")
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, max_bounces=4))
    d = torch.from_numpy(_dirs(128, 0))
    with pytest.raises(ValueError, match="cannot carry cluster boxes"):
        rc.trace_events(rc.pack_tris_group(sct), d, torch.zeros(3),
                        torch.from_numpy(rec), 0.0, params,
                        route=rc.Route("k6"), boxes=torch.zeros((1, 8)))
    # a caller's packed triangles must be those of the options' layout
    with pytest.raises(ValueError, match="not those of layout='group'"):
        t_tracer.trace_ir(sct, d, np.zeros(3), rec, 0.0, params,
                          t_tracer.TracerOptions(layout="group"),
                          rows=rc.pack_tris_rows(sct))
    with pytest.raises(ValueError, match="not those of layout='rows'"):
        t_tracer.trace_ir(sct, d, np.zeros(3), rec, 0.0, params,
                          rows=rc.pack_tris_group(sct))
    with pytest.raises(ValueError, match="precision must be one of"):
        gc.trace_round_group(torch.zeros((16, 128)),
                             *rc.pack_tris_group(sct), torch.zeros(16),
                             params, 1, precision="low")


def test_trace_round_group_rejects_bad_inputs():
    """The wrapper checks before it dispatches; a device with no kernel
    raises instead of running the plain version."""
    _, sct, _ = _setup("box")
    params = convert.trace_params_from_jax(ar.TraceParams(sample_rate=SR,
                                                          ir_length=SR))
    coeffs, attrs = rc.pack_tris_group(sct)
    state = rc.init_state(torch.from_numpy(_dirs(128, 0)), torch.zeros(3),
                          1.0, 128)
    scal = torch.zeros(16)
    with pytest.raises(ValueError, match="state must be"):
        gc.trace_round_group(state[:8].contiguous(), coeffs, attrs, scal,
                             params, 1)
    with pytest.raises(ValueError, match="contiguous float32"):
        gc.trace_round_group(state, coeffs.double(), attrs, scal, params, 1)
    with pytest.raises(ValueError, match="coeffs must be"):
        gc.trace_round_group(state, coeffs[:40].contiguous(), attrs, scal,
                             params, 1)
    with pytest.raises(ValueError, match="attrs must be"):
        gc.trace_round_group(state, coeffs, attrs[:8].contiguous(), scal,
                             params, 1)
    with pytest.raises(ValueError, match="round budget"):
        gc.trace_round_group(state, coeffs, attrs, scal, params, 0)
    meta = [x.to("meta") for x in (state, coeffs, attrs, scal)]
    with pytest.raises(ValueError, match="no trace kernel for device meta"):
        gc.trace_round_group(*meta, params, 1)


def test_cpu_group_call_launches_no_kernel():
    _, sct, rec = _setup("box")
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=6))
    gc.trace_round_group_launches = gc.trace_round_group_posed_launches = 0
    rc.launches = 0
    ir = t_tracer.trace_ir(sct, torch.from_numpy(_dirs(512, 3)), np.zeros(3),
                           rec, 0.0, params,
                           t_tracer.TracerOptions(layout="group"))
    assert ir.device.type == "cpu" and float(ir.sum()) > 0
    assert gc.trace_round_group_launches == 0 and rc.launches == 0
    assert gc.trace_round_group_posed_launches == 0


def test_renderer_group_layout_and_its_size_limit():
    """A renderer with ``layout="group"`` renders a small scene through K6's
    route, the IR equal to the rows route's from the same generator; a scene
    large enough to be clustered (512 triangles and up) raises the packing
    error, as the JAX renderer does."""
    v, t = tt.box_room((12.0, 8.0, 10.0))
    scene = tt.scene_from_arrays(v, t, 0.3)
    irs, packed = [], []
    for opts in (t_tracer.TracerOptions(layout="group"),
                 t_tracer.TracerOptions()):
        r = AudioRenderer(scene, 1, SR, 1024, max_bounces=6, opts=opts,
                          device="cpu", seed=3)
        r.set_receiver((2.0, 0.0, 1.0), 25.0)
        irs.append(r.render())
        packed.append(r.rows)
    assert packed[0][0].shape == (96, 8) and packed[1].shape == (16, 24)
    assert irs[0].sum() > 0
    np.testing.assert_array_equal(irs[0], irs[1])
    v, t = tt.icosphere(radius=6.0, subdivisions=3)  # 1280 triangles
    big = tt.scene_from_arrays(v, t, 0.2)
    with pytest.raises(ValueError, match="cannot carry cluster boxes"):
        AudioRenderer(big, 1, SR, 128, opts=t_tracer.TracerOptions(
            layout="group"), device="cpu")
    with pytest.raises(ValueError, match="cannot carry cluster boxes"):
        # the JAX renderer packs when it renders
        JAudioRenderer(jt.scene_from_arrays(v, t, 0.2), 1, SR, 128,
                       opts=_popts()).render()


def test_recorder_takes_the_group_layout():
    """``record_paths_kernels`` with ``layout="group"`` records the paths
    the rows layout records: K6 writes LTRI and RECVD as K1 does."""
    _, sct, rec = _setup("box")
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=5))
    d = torch.from_numpy(_dirs(300, 6))
    a = t_replay.record_paths_kernels(sct, d, np.zeros(3), rec, 25.0, params)
    b = t_replay.record_paths_kernels(
        sct, d, np.zeros(3), rec, 25.0, params,
        t_tracer.TracerOptions(layout="group", version=1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int((a[0] >= 0).sum()) > 300


# ------------------------------------------ the tensor-core form ("high")
#
# K6 "high" runs its product on the tensor cores (csrc/trace_group.cu), which
# no CPU test can run. What is tested here is what surrounds it: the B
# fragments the wrapper packs, a model of the m16n8k16 / m16n8k8 fragment
# layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16 / m16n8k8", .bf16)
# applied to the kernel's A words and B fragments, and a model of the quad
# reduction that gives each ray its nearest hit.

def _bf16_words(lo_half: np.ndarray, hi_half: np.ndarray) -> np.ndarray:
    """Two bf16-exact f32 arrays as one uint32 word each, the first in the
    low 16 bits (``bf16x2`` in the kernel)."""
    lo = lo_half.astype(np.float32).view(np.uint32) >> 16
    hi = hi_half.astype(np.float32).view(np.uint32) >> 16
    return (lo | (hi << 16)).astype(np.uint32)


def _unpack(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint32 words -> (low bf16, high bf16) as f32."""
    w = words.astype(np.uint32)
    return ((w << 16).view(np.float32), (w & 0xFFFF0000).view(np.float32))


def _a_words(state: torch.Tensor) -> np.ndarray:
    """The kernel's ``put_ray``: each ray's split as 8 words [8, N]."""
    ph, pl = (np.stack([x.numpy() for x in part])
              for part in gc._ray_rows(state, True))
    one, zero = np.ones_like(ph[0]), np.zeros_like(ph[0])
    return np.stack([_bf16_words(ph[0], ph[1]), _bf16_words(ph[2], ph[3]),
                     _bf16_words(ph[4], ph[5]), _bf16_words(one, zero),
                     _bf16_words(pl[0], pl[1]), _bf16_words(pl[2], pl[3]),
                     _bf16_words(pl[4], pl[5]), _bf16_words(zero, zero)])


def _mma_model(words: np.ndarray, frags: np.ndarray) -> np.ndarray:
    """The probe's output [N, G, 6, 8] from the lanes' fragment registers,
    placed into the A, B and C matrices by the PTX ISA's rules (gid =
    lane // 4, t = lane % 4): A (16 x 16, row-major) a0 row gid, a1 row gid
    + 8, a2 / a3 the same rows 8 columns on, each at columns 2t, 2t + 1;
    B (16 x 8) b0 rows 2t, 2t + 1 and b1 8 rows on, column gid; m16n8k8
    takes a0, a1 and b0; C c0, c1 row gid and c2, c3 row gid + 8, columns
    2t, 2t + 1. Each product is summed in f32 in k order."""
    n = words.shape[1]
    g_count = frags.shape[0]
    out = np.zeros((n, g_count, 6, 8), np.float32)
    lanes = np.arange(32)
    gid, t = lanes // 4, lanes % 4
    for w0 in range(0, n, 32):
        for m in range(2):
            rows = w0 + 16 * m
            # each lane's A registers, from the warp's word table
            regs = [words[t, rows + gid], words[t, rows + gid + 8],
                    words[4 + t, rows + gid], words[4 + t, rows + gid + 8]]
            a16 = np.zeros((16, 16), np.float32)
            for j, (r_off, c_off) in enumerate(((0, 0), (8, 0), (0, 8),
                                                (8, 8))):
                lo, hi = _unpack(regs[j])
                a16[gid + r_off, 2 * t + c_off] = lo
                a16[gid + r_off, 2 * t + 1 + c_off] = hi
            for g in range(g_count):
                for q in range(6):
                    b_hi, b_lo = frags[g, q, :, 0], frags[g, q, :, 1]
                    b16 = np.zeros((16, 8), np.float32)
                    b8 = np.zeros((8, 8), np.float32)
                    for reg, k_off, mat in ((b_hi, 0, b16), (b_hi, 8, b16),
                                            (b_lo, 0, b8)):
                        lo, hi = _unpack(reg)
                        mat[2 * t + k_off, gid] = lo
                        mat[2 * t + 1 + k_off, gid] = hi
                    d = np.zeros((16, 8), np.float32)
                    for k in range(16):
                        d = d + a16[:, k:k + 1] * b16[k:k + 1, :]
                    for k in range(8):
                        d = d + a16[:, k:k + 1] * b8[k:k + 1, :]
                    # the accumulators as the lanes hold them
                    for c in range(4):
                        r = gid + 8 * (c // 2)
                        col = 2 * t + c % 2
                        out[rows + r, g, q, col] = d[r, col]
    return out


def _random_coeffs(groups: int, seed: int) -> torch.Tensor:
    """Coefficients with no structural zeros: the kernel takes any table."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(groups * 48, 8))
                             * rng.choice([0.01, 1.0, 30.0],
                                          size=(groups * 48, 1)))
                            .astype(np.float32))


@pytest.mark.parametrize("source", ["box", "ico", "random"])
def test_b_fragments_unpack_to_the_bf16_split(source):
    """Word 0 of [g, q, lane] holds the high parts, word 1 the low parts of
    coefficients 2t, 2t + 1 of coefficient row g * 48 + q * 8 + lane // 4,
    bit for bit as ``_split_bf16`` gives them; coefficient 7 is 0."""
    if source == "random":
        coeffs = _random_coeffs(3, 0)
    else:
        coeffs = rc.pack_tris_group(_setup(source)[1])[0]
    frags = gc.b_fragments(coeffs).numpy()
    g = coeffs.shape[0] // 48
    assert frags.shape == (g, 6, 32, 2) and frags.dtype == np.int32
    hi, lo = (x.numpy().reshape(g, 6, 8, 8)
              for x in gc._split_bf16(coeffs))
    for word, table in ((0, hi), (1, lo)):
        low, high = _unpack(frags[..., word].reshape(g, 6, 8, 4))
        got = np.stack([low, high], axis=-1).reshape(g, 6, 8, 8)
        want = table.copy()
        want[..., 7] = 0.0
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("n_bands,source", [(1, "box"), (4, "box"),
                                            (8, "box"), (1, "random")])
def test_fragment_model_gives_the_three_product_sum(n_bands, source):
    """The packed A words and B fragments, through the PTX fragment
    layouts, give every quantity within 2^-20 of the sum of its 20 terms'
    magnitudes of the float64 sum, as the plain version does; random rays
    from random origins, a state of ``n_bands`` bands."""
    _, sct, _ = _setup("box", n_bands)
    coeffs = (rc.pack_tris_group(sct, n_bands)[0] if source == "box"
              else _random_coeffs(2, 1))
    rng = np.random.default_rng(n_bands)
    n = 64
    state = rc.init_state(torch.from_numpy(_dirs(n, 7 + n_bands)),
                          torch.zeros(3), 1.0, n, n_bands)
    state[rc._C_PX:rc._C_PZ + 1] = torch.from_numpy(
        rng.uniform(-6.0, 6.0, size=(3, n)).astype(np.float32))
    got = _mma_model(_a_words(state), gc.b_fragments(coeffs).numpy())
    ref, mag = (x.numpy() for x in gc.high_terms_f64(state, coeffs))
    bar = 2.0 ** -20 * mag
    assert np.all(np.abs(got - ref) <= bar)
    plain = gc.products_plain(state, coeffs).numpy()
    assert np.all(np.abs(plain - ref) <= bar)
    assert np.abs(got - plain).max() > 0 or source == "box"
    assert np.abs(ref).max() > 1.0  # the terms are not all zero


def _quad_hits(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A model of the "high" search and ``own_hit`` for one warp: ``t``
    [32 rays, T] (inf where a triangle is missed). Lane (gid, t4) holds
    rays 8r + gid and triangles 8g + 2 t4, + 1 in index order with a strict
    `<`; then the quad's xor-1 and xor-2 exchanges keep the lower (t, index)
    and ray L takes lane 4 (L % 8) + L // 8's value r = t4."""
    n_tris = t.shape[1]
    bt = np.full((32, 4), np.inf)
    bi = np.full((32, 4), -1)
    for lane in range(32):
        gid, t4 = lane // 4, lane % 4
        for g in range(n_tris // 8):
            for j in range(2):
                tri = 8 * g + 2 * t4 + j
                for r in range(4):
                    if t[8 * r + gid, tri] < bt[lane, r]:
                        bt[lane, r], bi[lane, r] = t[8 * r + gid, tri], tri
    for off in (1, 2):
        ot, oi = bt[np.arange(32) ^ off], bi[np.arange(32) ^ off]
        take = (ot < bt) | ((ot == bt) & (oi < bi))
        bt, bi = np.where(take, ot, bt), np.where(take, oi, bi)
    lanes = np.arange(32)
    src = 4 * (lanes % 8) + lanes // 8
    return bt[src, src % 4], bi[src, src % 4]


def test_quad_reduction_keeps_the_lowest_index_on_equal_t():
    """Equal hit distances on triangles held by different lanes of a quad,
    by one lane, and in different groups: each ray gets the lowest index, as
    the plain version's index-order `<` gives it; a ray that misses keeps
    (inf, -1)."""
    rng = np.random.default_rng(3)
    t = rng.choice([1.0, 2.0, 3.0, np.inf], size=(32, 24))
    t[5] = np.inf                        # a miss
    t[6, [23, 3, 2, 17]] = 0.5           # ties across lanes and groups
    t[7, [9, 8]] = 0.25                  # a tie within one lane
    t[8, :] = 4.0
    t[8, [20, 11]] = 0.75                # the later lane of the quad first
    got_t, got_i = _quad_hits(t)
    want_i = np.argmin(t, axis=1)        # numpy: the first minimum
    want_t = t[np.arange(32), want_i]
    want_i = np.where(np.isinf(want_t), -1, want_i)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_i, want_i)
    assert (got_i[6], got_i[7], got_i[8], got_i[5]) == (2, 8, 11, -1)


def test_products_high_on_the_cpu_is_the_plain_product():
    """The probe's wrapper: a CPU tensor takes the plain version and
    launches nothing; it refuses what its kernel does not take."""
    _, sct, _ = _setup("ico")
    coeffs = rc.pack_tris_group(sct)[0]
    state = rc.init_state(torch.from_numpy(_dirs(100, 0)), torch.zeros(3),
                          1.0, 128)
    gc.group_probe_launches = 0
    got = gc.products_high(state, coeffs)
    assert got.shape == (128, 40, 6, 8) and gc.group_probe_launches == 0
    assert torch.equal(got, gc.products_plain(state, coeffs))
    with pytest.raises(ValueError, match="coeffs must be"):
        gc.products_high(state, coeffs[:40].contiguous())
    with pytest.raises(ValueError, match="contiguous float32"):
        gc.products_high(state.double(), coeffs)
    with pytest.raises(ValueError, match="no probe kernel for device meta"):
        gc.products_high(state.to("meta"), coeffs.to("meta"))


def test_fragment_cache_follows_the_coefficients():
    """The fragments are made once per coefficient tensor and made again
    when that tensor changes in place."""
    coeffs = _random_coeffs(2, 4)
    first = gc._fragments_of(coeffs)
    assert gc._fragments_of(coeffs) is first
    coeffs.mul_(2.0)
    again = gc._fragments_of(coeffs)
    assert again is not first
    assert torch.equal(again, gc.b_fragments(coeffs))
    assert torch.equal(gc._fragments_of(coeffs.clone()), again)


@pytest.mark.parametrize("name,n_bands", [("box", 1), ("box", 4), ("box", 8),
                                          ("ico", 4)])
def test_folded_plain_round_equals_k1_bit_for_bit(name, n_bands):
    """The plain "highest" with the ray's packed 1 and 0 folded equals K1's
    plain round in every column, at 1, 4 and 8 bands, and its quantities
    equal K1's direct forms where they are not zero."""
    _, sct, rec = _setup(name, n_bands)
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=20,
        n_bands=n_bands))
    n = 512
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(torch.from_numpy(_dirs(n, 8)), torch.zeros(3), e0,
                          n, n_bands)
    scal = rc.scalars(torch.zeros(3), torch.from_numpy(rec), 25.0, e0,
                      params)
    rows = rc.trace_round(state.clone(), rc.pack_tris_rows(sct, n_bands),
                          scal, params, 8)
    coeffs, attrs = rc.pack_tris_group(sct, n_bands)
    group = gc.trace_round_group(state.clone(), coeffs, attrs, scal, params,
                                 8)
    assert torch.equal(group, rows)
    q = gc.products_plain(state, coeffs, "highest")  # [N, G, 6, 8]
    r = rc.pack_tris_rows(sct, n_bands)[:q.shape[1] * 8]
    p, v = state[rc._C_PX:rc._C_PZ + 1], state[rc._C_VX:rc._C_VZ + 1]
    nd = v[0][:, None] * r[:, rc._R_PNX] + v[1][:, None] * r[:, rc._R_PNY] \
        + v[2][:, None] * r[:, rc._R_PNZ]
    no = p[0][:, None] * r[:, rc._R_PNX] + p[1][:, None] * r[:, rc._R_PNY] \
        + p[2][:, None] * r[:, rc._R_PNZ] + r[:, rc._R_PD]
    for k, direct in ((0, no), (1, nd)):
        got = q[:, :, k, :].reshape(n, -1)
        assert torch.equal(got, direct)


def test_group_round_past_one_chunk_equals_k1():
    """An ops-level table of 160 groups (past the 64 the kernel stages at
    once; the chunked kernel on the card) through the plain "highest":
    K1's bits; and "high" on K1's path for nearly every ray."""
    v, t = tt.icosphere(radius=6.0, subdivisions=3)  # 1280 triangles
    sct = t_tracer.scene_to_arrays(tt.scene_from_arrays(v, t, 0.3), 128,
                                   device="cpu")
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=20))
    n = 256
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(torch.from_numpy(_dirs(n, 9)), torch.zeros(3), e0,
                          n)
    scal = rc.scalars(torch.zeros(3), torch.tensor([1.0, 0.5, -1.0]), 0.0,
                      e0, params)
    coeffs, attrs = rc.pack_tris_group(sct)
    assert coeffs.shape[0] // 48 == 160
    rows = rc.trace_round(state.clone(), rc.pack_tris_rows(sct), scal,
                          params, 3)
    assert torch.equal(gc.trace_round_group(state.clone(), coeffs, attrs,
                                            scal, params, 3), rows)
    high = gc.trace_round_group(state.clone(), coeffs, attrs, scal, params,
                                3, precision="high")
    same = (high[rc._C_LTRI] == rows[rc._C_LTRI]) \
        & (high[rc._C_DEPTH] == rows[rc._C_DEPTH])
    assert float(same.float().mean()) > 0.99
