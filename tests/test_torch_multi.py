"""The port's multi-pose path against the JAX package: the pose-batched
trace (rows and clustered), the posed histogram, ``render_ir_matrix`` and
``mix_sources``, on the same scene arrays and the same numpy directions.
The JAX side runs its Pallas kernels in interpret mode, as
tests/test_multi.py does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import accel as j_accel
from audiorenderingv2_tpu import multi as j_multi
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.core import tracer as j_tracer
from audiorenderingv2_tpu.ops import raytrace_pallas as rp
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch import multi as t_multi
from audiorenderingv2_tpu_torch.core import sampling as t_sampling
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc_cuda

torch.set_num_threads(1)

SR = 8000
EMITTERS = np.array([[0.0, 0.0, 0.0], [2.0, 1.0, -1.0]], np.float32)
RECEIVERS = np.array([[3.0, 0.0, 1.0], [-2.0, -1.0, 2.0], [0.0, 2.0, -3.0]],
                     np.float32)
YAWS = np.array([0.0, 45.0, -90.0], np.float32)


def _np(sc):
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _box(n_bands=1, max_bounces=5):
    v, t = jt.box_room((12.0, 9.0, 10.0))
    absorb = 0.3 if n_bands == 1 else np.tile(
        np.linspace(0.1, 0.6, n_bands, dtype=np.float32), (t.shape[0], 1))
    sc = ar.scene_to_arrays(jt.scene_from_arrays(v, t, absorb), 128)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=max_bounces, n_bands=n_bands)
    popts = ar.TracerOptions(backend="pallas", pallas_version=2,
                             pallas_interpret=True,
                             pallas_round_budgets=(2, 4))
    return (sc, convert.scene_arrays_from_jax(_np(sc), device="cpu"), params,
            popts)


def _ico():
    v, t = jt.icosphere(radius=6.0, subdivisions=3)  # 1280 triangles
    sorted_scene, clusters = j_accel.prepare_scene(
        jt.scene_from_arrays(v, t, 0.2), cluster_size=32)
    sc = ar.scene_to_arrays(sorted_scene, 128, clusters=clusters)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=5)
    popts = ar.TracerOptions(backend="pallas", pallas_version=2,
                             pallas_interpret=True, pallas_schedule=True,
                             pallas_key_layout="dir72", pallas_cell_bits=5)
    return (sc, convert.scene_arrays_from_jax(_np(sc), device="cpu"), params,
            popts)


def _poses(p):
    """p poses: pairs of EMITTERS x RECEIVERS in the matrix's order."""
    return (np.repeat(EMITTERS, 3, axis=0)[:p], np.tile(RECEIVERS, (2, 1))[:p],
            np.tile(YAWS, 2)[:p])


# ------------------------------------------------------- the pose batch

@pytest.mark.parametrize("route", ["rows", "clustered"])
def test_trace_events_pose_batch_matches_jax_and_single_pose(route):
    """Every event column against the JAX pose batch within 1e-4 (the bar
    of several bounces against the interpret-mode kernel,
    tests/test_torch_trace.py), and pose p of the port's batch bit-equal to
    a single-pose trace_events of the same directions. Event weights carry
    the chord 2 sqrt(disc) through the receiver sphere, which is
    ill-conditioned for a grazing entry (one such ray of 1,536 differs by
    1.8e-4 of the largest weight), so their absolute bar is 1e-3 of that."""
    sc, sct, params, _ = _box() if route == "rows" else _ico()
    budgets = (2, 4) if route == "rows" else None
    p, n = 4, 300  # padded to 384 per pose
    d = np.stack([_dirs(n, 40 + i) for i in range(p)])
    em, rcv, yaw = _poses(p)
    if route == "clustered":
        em, rcv = em * 0.5, rcv * 0.5  # inside the radius-6 sphere
    ref = rp.trace_events_pose_batch(
        sc, jnp.asarray(d), jnp.asarray(em), jnp.asarray(rcv),
        jnp.asarray(yaw), params, interpret=True, round_budgets=budgets,
        schedule_mode=route == "clustered")
    tparams = convert.trace_params_from_jax(params)
    rows, boxes = rc.pack_scene(sct)
    args = [torch.from_numpy(x) for x in (d, em, rcv, yaw)]
    kernels = rc.Route("sched", "sort") if boxes is not None else rc.ROWS
    got = rc.trace_events_pose_batch(rows, *args, tparams,
                                     round_budgets=budgets, boxes=boxes,
                                     route=kernels)
    assert got[0].shape == (p, 384) and got[1].shape == (p, 384, 1)
    assert got[2].dtype == torch.int32
    w_scale = float(np.abs(np.asarray(ref[1])).max())
    assert int((got[1] != 0).sum()) > 20
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-3 * w_scale)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for i in range(p):
        one = rc.trace_events(rows, args[0][i], args[1][i], args[2][i],
                              float(yaw[i]), tparams, round_budgets=budgets,
                              boxes=boxes, route=kernels)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b), f"pose {i} differs from its own trace"


def test_posed_round_reads_each_rays_own_scalar_row():
    """K1's and K2's plain versions with scal [P, 16]: segment p equals a
    single-pose round with row p, bit for bit, in every column."""
    _, sct, params, _ = _ico()
    tparams = convert.trace_params_from_jax(params)
    rows, boxes = rc.pack_scene(sct)
    flat_rows = rc.pack_tris_rows(sct._replace(cluster_boxes=None))
    p, n = 3, 256
    em, rcv, yaw = (torch.from_numpy(x * 0.5) for x in _poses(p))
    d = torch.from_numpy(np.stack([_dirs(n, i) for i in range(p)]))
    scal = rc.scalars(em, rcv, yaw * 2, 1e-6, tparams)
    assert scal.shape == (p, 16)
    state = rc.init_state(d, em, 1e-6, n)
    assert state.shape == (16, p * n)
    k1 = rc.trace_round(state.clone(), flat_rows, scal, tparams, 3, n)
    sched = sc_cuda.tile_schedule(state, boxes)
    k2 = sc_cuda.trace_round_sched(state.clone(), rows, boxes, sched, scal,
                                   tparams, n)
    for i in range(p):
        seg = slice(i * n, (i + 1) * n)
        one = rc.scalars(em[i], rcv[i], yaw[i] * 2, 1e-6, tparams)
        assert torch.equal(one, scal[i])
        s1 = state[:, seg].contiguous()
        assert torch.equal(rc.trace_round(s1.clone(), flat_rows, one,
                                          tparams, 3), k1[:, seg])
        assert torch.equal(sc_cuda.trace_round_sched(
            s1.clone(), rows, boxes, sched[2 * i:2 * i + 2].contiguous(),
            one, tparams), k2[:, seg])
    assert (k2[rc._C_DONE] == 0).any() and (k1[rc._C_EVW] > 0).any()


def test_per_pose_reorders_stay_inside_their_pose():
    """The segmented partition and key sort equal the single-pose functions
    applied to each pose's segment; the keys' cell grid spans that pose's
    positions only."""
    rng = np.random.default_rng(5)
    p, n = 3, 256
    st = torch.zeros(16, p * n)
    pos = rng.uniform(-4, 4, size=(3, p * n)).astype(np.float32)
    pos[:, n:2 * n] *= 0.1  # one pose's rays in a small box
    st[rc._C_PX:rc._C_PZ + 1] = torch.from_numpy(pos)
    st[rc._C_VX:rc._C_VZ + 1] = torch.from_numpy(_dirs(p * n, 6).T.copy())
    st[rc._C_DONE] = torch.from_numpy((rng.random(p * n) < 0.3)
                                      .astype(np.float32))
    st[rc._C_RAYID] = torch.arange(p * n, dtype=torch.float32)
    part = rc._partition_alive_first(st, p)
    keys = rc._compaction_keys(st, n_poses=p)
    srt = rc._sort_state_by_keys(st, keys, p)
    for i in range(p):
        seg = slice(i * n, (i + 1) * n)
        one = st[:, seg].contiguous()
        assert torch.equal(part[:, seg], rc._partition_alive_first(one))
        k1 = rc._compaction_keys(one)
        assert torch.equal(keys[seg], k1)
        assert torch.equal(srt[:, seg], rc._sort_state_by_keys(one, k1))
    assert len(torch.unique(keys[n:2 * n])) > 100  # its own, finer grid


def test_pose_batch_rejects_what_jax_rejects():
    _, sct, params, _ = _ico()
    _, box_t, _, _ = _box()
    tparams = convert.trace_params_from_jax(params)
    rows, boxes = rc.pack_scene(sct)
    d = torch.from_numpy(np.stack([_dirs(128, 0), _dirs(128, 1)]))
    em, rcv, yaw = (torch.from_numpy(x * 0.5) for x in _poses(2))
    with pytest.raises(ValueError, match="one bounce per round"):
        rc.trace_events_pose_batch(rows, d, em, rcv, yaw, tparams,
                                   round_budgets=(2, 3), boxes=boxes,
                                   route=rc.Route("sched", "sort"))
    with pytest.raises(ValueError, match="requires schedule=True"):
        rc.trace_events_pose_batch(rows, d, em, rcv, yaw, tparams,
                                   boxes=boxes, route=rc.Route("k5", "sort"))
    with pytest.raises(ValueError, match="deep paths would be truncated"):
        rc.trace_events_pose_batch(rows, d, em, rcv, yaw, tparams,
                                   round_budgets=(1, 1), boxes=boxes,
                                   route=rc.Route("sched", "sort"))
    with pytest.raises(ValueError, match="deep paths would be truncated"):
        rc.trace_events_pose_batch(rc.pack_tris_rows(box_t), d, em, rcv, yaw,
                                   tparams, round_budgets=(2, 2))
    state = rc.init_state(d, em, 1e-6, 128)
    scal = rc.scalars(em, rcv, yaw, 1e-6, tparams)
    flat = rc.pack_tris_rows(box_t)
    with pytest.raises(ValueError, match="do not make the state's 256 rays"):
        rc.trace_round(state, flat, scal, tparams, 1, rays_per_pose=64)
    with pytest.raises(ValueError, match="multiple of 128"):
        rc.trace_round(state[:, :128].contiguous(), flat, scal, tparams, 1,
                       rays_per_pose=64)
    with pytest.raises(ValueError, match=r"scal must be \[16\] or \[P, 16\]"):
        rc.trace_round(state, flat, scal[:, :8].contiguous(), tparams, 1)


# --------------------------------------------------- the posed histogram

@pytest.mark.parametrize("mode", ["stereo", "mono", "banded"])
def test_histogram_from_events_posed_matches(mode):
    """On the JAX pose batch's own events. JAX's CPU histogram is its sort
    path, whose f32 running sum is good to a few ulp of the summed weight
    (tests/test_torch_histogram.py), hence the absolute bar; the cross-ear
    shift at most doubles it."""
    n_bands = 3 if mode == "banded" else 1
    sc, _, params, _ = _box(n_bands, max_bounces=6)
    if mode == "mono":
        params = ar.TraceParams(**{**params.__dict__, "is_mono": True})
    p = 3
    d = np.stack([_dirs(384, 70 + i) for i in range(p)])
    em, rcv, yaw = _poses(p)
    ev = rp.trace_events_pose_batch(
        sc, jnp.asarray(d), jnp.asarray(em), jnp.asarray(rcv),
        jnp.asarray(yaw), params, interpret=True, round_budgets=(2, 4))
    ref = np.asarray(j_tracer._histogram_from_events_posed(*ev, params))
    got = t_tracer._histogram_from_events_posed(
        *(torch.tensor(np.asarray(x)) for x in ev),
        convert.trace_params_from_jax(params)).numpy()
    assert got.shape == ref.shape == ((p, 2, SR) if n_bands == 1
                                      else (p, 2, 3, SR))
    assert ref.sum() > 0
    atol = 8 * np.finfo(np.float32).eps * float(np.asarray(ev[1]).sum())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


# ----------------------------------------------------------- the matrix

def _shared_directions(monkeypatch, key, n_pairs, n_rays, seed):
    """Make the port draw, for pair i, the directions JAX draws from
    fold_in(key, i): the port's sampler is replaced by a lookup keyed on
    the pair generator's seed."""
    by_seed = {}
    for i in range(n_pairs):
        d = np.asarray(j_sampling.sample_directions(
            jax.random.fold_in(key, i), n_rays))
        by_seed[t_sampling.pose_generator(seed, i, "cpu").initial_seed()] = d

    def fake(n, generator, device):
        d = by_seed[generator.initial_seed()]
        assert d.shape[0] == n
        return torch.tensor(d, device=device)

    monkeypatch.setattr(t_sampling, "sample_directions", fake)


@pytest.mark.parametrize("n_bands", [1, 3])
def test_render_ir_matrix_matches_jax(monkeypatch, n_bands):
    """Fused against pair_batch=1 against JAX's fused matrix, per (source,
    listener, ear) row on the reference's statistical bar."""
    sc, sct, params, popts = _box(n_bands, max_bounces=6)
    key = jax.random.PRNGKey(3)
    n_rays = 512
    ref = j_multi.render_ir_matrix(sc, key, EMITTERS, RECEIVERS, YAWS, n_rays,
                                   params, popts, pair_batch=0)
    _shared_directions(monkeypatch, key, 6, n_rays, seed=11)
    tparams = convert.trace_params_from_jax(params)
    topts = convert.tracer_options_from_jax(popts)
    assert topts.round_budgets == (2, 4)
    fused = t_multi.render_ir_matrix(sct, 11, EMITTERS, RECEIVERS, YAWS,
                                     n_rays, tparams, topts, pair_batch=0)
    single = t_multi.render_ir_matrix(sct, 11, EMITTERS, RECEIVERS, YAWS,
                                      n_rays, tparams, topts, pair_batch=1)
    shape = (2, 3, 2, SR) if n_bands == 1 else (2, 3, 2, 3, SR)
    assert fused.shape == single.shape == ref.shape == shape
    assert fused.dtype == np.float32 and fused.sum() > 0
    np.testing.assert_array_equal(fused, single)  # pose p is its own trace
    flat = lambda m: m.reshape(-1, m.shape[-1])  # noqa: E731
    jt.assert_ir_close(flat(fused), flat(ref), exact=False)
    for i in range(6):
        assert fused[i // 3, i % 3].sum() > 0


def test_render_ir_matrix_pairs_batches_and_errors():
    """Pair order, yaw broadcast, an odd tail (5 pairs at pair_batch=2),
    one pair against a direct render_ir, and the argument checks."""
    _, sct, params, _ = _box()
    tparams = convert.trace_params_from_jax(params)
    opts = t_tracer.TracerOptions(round_budgets=(2, 4))
    em = np.array([[0.0, 0.0, 0.0]], np.float32)
    rcv = np.concatenate([RECEIVERS, -RECEIVERS[:2]])  # 1 x 5 pairs
    args = (sct, 7, em, rcv, 30.0, 256, tparams, opts)
    whole = t_multi.render_ir_matrix(*args, pair_batch=0)
    assert whole.shape == (1, 5, 2, SR)
    np.testing.assert_array_equal(
        whole, t_multi.render_ir_matrix(*args, pair_batch=2))
    np.testing.assert_array_equal(
        whole, t_multi.render_ir_matrix(*args))  # 16 > 5: one batch
    direct = t_tracer.render_ir(
        sct, t_sampling.pose_generator(7, 3, "cpu"), 256, em[0], rcv[3], 30.0,
        tparams, opts)
    np.testing.assert_array_equal(whole[0, 3], direct.numpy())
    assert not np.array_equal(whole[0, 3], whole[0, 4])
    # one source as a flat [3] vector, one yaw per listener
    yawed = t_multi.render_ir_matrix(sct, 7, em[0], rcv,
                                     [30.0, 30.0, 30.0, 30.0, 120.0], 256,
                                     tparams, opts)
    np.testing.assert_array_equal(yawed[0, :4], whole[0, :4])
    assert not np.array_equal(yawed[0, 4], whole[0, 4])
    with pytest.raises(ValueError, match="pair_batch must be >= 0"):
        t_multi.render_ir_matrix(*args, pair_batch=-1)
    with pytest.raises(ValueError):  # 2 yaws for 5 listeners
        t_multi.render_ir_matrix(sct, 7, em, rcv, [0.0, 1.0], 256, tparams)
    with pytest.raises(ValueError, match="hard binning"):
        t_tracer.render_ir_pose_batch(
            sct, 7, 256, em, rcv[:1], [0.0], tparams,
            t_tracer.TracerOptions(soft_binning=True))


@pytest.mark.parametrize("which", ["soft_binning", "native_rng"])
def test_matrix_gate_renders_pair_by_pair(monkeypatch, which):
    """Soft binning and in-kernel directions leave the fused batch: one
    render_ir per pair, as in the JAX package's gate."""
    _, sct, params, _ = _box()
    tparams = convert.trace_params_from_jax(params)
    opts = t_tracer.TracerOptions(round_budgets=(2, 4), **{which: True})
    calls = []
    real = t_multi.render_ir
    monkeypatch.setattr(t_multi, "render_ir",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(
        t_multi, "render_ir_pose_batch",
        lambda *a, **k: pytest.fail("the gate let the fused batch run"))
    m = t_multi.render_ir_matrix(sct, 2, EMITTERS, RECEIVERS[:2], 0.0, 256,
                                 tparams, opts, pair_batch=0)
    assert m.shape == (2, 2, 2, SR) and len(calls) == 4 and m.sum() > 0


def test_cpu_pose_batch_launches_no_kernel():
    _, sct, params, _ = _ico()
    rc.launches = rc.posed_launches = rc.init_launches = 0
    sc_cuda.trace_round_sched_posed_launches = 0
    m = t_multi.render_ir_matrix(sct, 0, EMITTERS[:1] * 0.5,
                                 RECEIVERS[:2] * 0.5, 0.0, 128,
                                 convert.trace_params_from_jax(params))
    assert m.shape == (1, 2, 2, SR) and m.sum() > 0
    assert rc.launches == rc.posed_launches == rc.init_launches == 0
    assert sc_cuda.trace_round_sched_posed_launches == 0


# -------------------------------------------------------------- the mix

def _matrix(n_bands, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 3, 2, SR) if n_bands == 1 else (2, 3, 2, n_bands, SR)
    return (rng.random(shape) ** 8 * 1e-3).astype(np.float32)


@pytest.mark.parametrize("n_bands", [1, 4])
def test_mix_sources_matches_jax(n_bands):
    """The same matrix and signals through both mixers; signals of unequal
    length, the banded form through the filterbank."""
    m = _matrix(n_bands, 1)
    rng = np.random.default_rng(2)
    signals = [rng.normal(size=2 * SR + 100).astype(np.float32),
               rng.normal(size=SR).astype(np.float32)]
    ref = j_multi.mix_sources(m, signals, SR)
    got = t_multi.mix_sources(m, signals, SR, device="cpu")
    assert got.shape == ref.shape == (3, 2, 2 * SR + 100)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="2 sources but 1 signals"):
        t_multi.mix_sources(m, signals[:1], SR, device="cpu")


@pytest.mark.parametrize("n_bands", [1, 4])
def test_mix_is_linear(n_bands):
    """The banded form with signals of one length: the band split is a
    circular filter over the padded length, so padding a signal changes
    its bands."""
    m = _matrix(n_bands, 3)
    rng = np.random.default_rng(4)
    sig_a = rng.normal(size=2 * SR).astype(np.float32)
    sig_b = rng.normal(size=SR if n_bands == 1 else 2 * SR).astype(
        np.float32)
    mixed = t_multi.mix_sources(m, [sig_a, sig_b], SR, device="cpu")
    only_a = t_multi.mix_sources(torch.from_numpy(m[:1]), [sig_a], SR,
                                 device="cpu")
    only_b = t_multi.mix_sources(m[1:], [sig_b], SR, device="cpu")
    padded_b = np.zeros_like(only_a)
    padded_b[..., :only_b.shape[-1]] = only_b
    np.testing.assert_allclose(mixed, only_a + padded_b, rtol=1e-4,
                               atol=1e-6)


def test_new_modules_import_without_jax():
    """multi and filterbank import with JAX made unimportable."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = ("import sys; sys.modules['jax'] = None\n"
            "from audiorenderingv2_tpu_torch import multi\n"
            "from audiorenderingv2_tpu_torch.ops import filterbank\n"
            "from audiorenderingv2_tpu_torch.core import tracer, sampling\n"
            "assert not [m for m in sys.modules if m.startswith("
            "'audiorenderingv2_tpu.')]\n"
            "print(multi.render_ir_matrix.__name__, "
            "tracer.TracerOptions().native_rng)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=str(repo)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["render_ir_matrix", "False"]
