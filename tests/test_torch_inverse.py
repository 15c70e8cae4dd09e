"""The port's inverse fit (diff/inverse.py, diff/checkpoint.py) against the
JAX package: losses, both fit methods, Adam, checkpoints that cross between
the packages. Both fits get JAX's direction set as a numpy array."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.diff import checkpoint as j_ckpt
from audiorenderingv2_tpu.diff import inverse as j_inverse
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch import diff as t_diff
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.diff import checkpoint as t_ckpt
from audiorenderingv2_tpu_torch.diff import inverse as t_inverse
from audiorenderingv2_tpu_torch.scene import build_scene
from audiorenderingv2_tpu_torch.testing import scene_from_arrays

torch.set_num_threads(1)

SR = 4000
REC = (1.5, 0.5, -2.0)
J_OPTS = ar.TracerOptions(block_size=128, tri_chunk=128)
T_OPTS = t_tracer.TracerOptions(block_size=128, tri_chunk=128)


def _fit_setup(true_a=0.35, n_bands=1, seed=11, n_rays=256):
    """tests/test_replay.py's fit: a 10 x 8 x 9 m box, 256 rays, 4
    bounces; the same scene in both packages, JAX's directions."""
    v, t = jt.box_room((10.0, 8.0, 9.0))
    if n_bands == 1:
        j_scene = jt.scene_from_arrays(v, t, true_a)
        t_scene = scene_from_arrays(v, t, true_a)
    else:
        from audiorenderingv2_tpu.scene import build_scene as j_build
        ab = np.tile(np.asarray(true_a, np.float32), (len(t), 1))
        j_scene = j_build(jt.mesh_from_arrays(v, t), ab)
        t_scene = scene_from_arrays(v, t, ab)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=4, n_bands=n_bands)
    dirs = np.array(j_sampling.sample_directions(jax.random.PRNGKey(seed),
                                                 n_rays))
    return j_scene, t_scene, params, convert.trace_params_from_jax(params), \
        dirs


def test_diff_exports_the_jax_names():
    from audiorenderingv2_tpu import diff as j_diff

    want = {n.replace("record_paths_pallas", "record_paths_kernels")
            for n in j_diff.__all__}
    assert set(t_diff.__all__) == want
    for name in want:
        assert callable(getattr(t_diff, name)) or name == "FitResult"


@pytest.mark.parametrize("kind,radius", [("l2", 0), ("log", 0), ("log", 5),
                                         ("l2", 32)])
def test_ir_loss_and_smooth_ir_match_jax(kind, radius):
    """Losses within rtol 1e-5 (f32 cumulative sums in another order), the
    smoothed IR itself within 1e-5 of its peak."""
    rng = np.random.default_rng(radius)
    pred = (rng.random((3, 2, 500)) ** 4).astype(np.float32)
    target = (rng.random((3, 2, 500)) ** 4).astype(np.float32)
    got = t_inverse.ir_loss(torch.from_numpy(pred), torch.from_numpy(target),
                            kind, radius)
    ref = j_inverse.ir_loss(jnp.asarray(pred), jnp.asarray(target), kind,
                            radius)
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    sm = t_inverse.smooth_ir(torch.from_numpy(pred), radius).numpy()
    sm_j = np.asarray(j_inverse.smooth_ir(jnp.asarray(pred), radius))
    np.testing.assert_allclose(sm, sm_j, rtol=0, atol=1e-5 * sm_j.max())
    with pytest.raises(ValueError):
        t_inverse.ir_loss(torch.zeros(2, 4), torch.zeros(2, 4), "l1")


def test_material_helpers_match_jax():
    from audiorenderingv2_tpu_torch.io.obj import MeshData

    v, t = tt.box_room((4.0, 3.0, 5.0))
    mesh = MeshData(vertices=v, triangles=t,
                    tri_material=np.array([0, 0, 1, 1, -1, -1, 2, 2, 0, 1, 2,
                                           -1], np.int32),
                    material_names=["a", "b", "c"])
    scene = build_scene(mesh, np.full(12, 0.2, np.float32))
    ids = t_inverse.material_ids_padded(scene, 128)
    ids_j = np.asarray(j_inverse.material_ids_padded(scene, 128))
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    assert ids.dtype == torch.int64 and int(ids[12:].min()) == 3
    sc = t_tracer.scene_to_arrays(scene, 128, device="cpu")
    table = torch.tensor([0.1, 0.2, 0.3, 0.9])
    out = t_inverse.with_material_absorption(sc, ids, table)
    np.testing.assert_array_equal(out.absorption.numpy(),
                                  table.numpy()[ids_j])
    grid = t_inverse.emitter_grid((-3, -2, -1), (3, 2, 1), spacing=2.0)
    np.testing.assert_array_equal(
        grid, j_inverse.emitter_grid((-3, -2, -1), (3, 2, 1), spacing=2.0))


@pytest.mark.parametrize("method", ["full", "replay"])
def test_fit_recovers_absorption_and_tracks_jax(method):
    """Both methods recover absorption 0.35 from 0.5 within 0.05 and shrink
    the loss 20-fold, as tests/test_replay.py:136-157 and
    tests/test_gradients.py:99-120 ask of JAX; with JAX's directions the
    loss curves of port and JAX stay within 1% over the first 20 steps and
    the fitted values within 1e-3 (other rounding; the same topology)."""
    j_scene, t_scene, params, tparams, dirs = _fit_setup()
    target = t_diff.render_soft_ir(
        t_scene, tparams, n_rays=256, emitter=(0.0, 0.0, 0.0),
        receiver_pos=REC, opts=T_OPTS, device="cpu", directions=dirs)
    target_j = j_inverse.render_soft_ir(
        j_scene, params, n_rays=256, emitter=(0.0, 0.0, 0.0),
        receiver_pos=REC, opts=J_OPTS, seed=11)
    jt.assert_ir_close(target.numpy(), np.asarray(target_j), exact=False)
    seen = []
    res = t_diff.fit_scene_parameters(
        t_scene, target, tparams, n_rays=256, steps=60, learning_rate=0.1,
        receiver_pos=REC, opts=T_OPTS, method=method, replay_refresh=20,
        device="cpu", directions=dirs,
        callback=lambda i, loss, theta: seen.append((i, loss)))
    fitted = res.params["absorption"]
    assert fitted.shape == (1,) and abs(fitted[-1] - 0.35) < 0.05
    assert res.losses[-1] < res.losses[0] * 0.05
    assert [i for i, _ in seen] == list(range(60))
    assert [loss for _, loss in seen] == list(res.losses)
    ref = j_inverse.fit_scene_parameters(
        j_scene, jnp.asarray(target.numpy()), params, n_rays=256, steps=60,
        learning_rate=0.1, receiver_pos=REC, seed=11, opts=J_OPTS,
        method=method, replay_refresh=20)
    np.testing.assert_allclose(res.losses[:20], ref.losses[:20], rtol=1e-2)
    np.testing.assert_allclose(fitted, ref.params["absorption"], atol=1e-3)


def test_fit_recovers_banded_absorption():
    """Per-band recovery of [0.2, 0.6] through the replay method, as
    tests/test_gradients.py:123-146 asks of JAX's full method."""
    true_bands = np.array([0.2, 0.6], np.float32)
    _, t_scene, _, tparams, dirs = _fit_setup(true_bands, n_bands=2, seed=13)
    target = t_diff.render_soft_ir(
        t_scene, tparams, n_rays=256, emitter=(0.0, 0.0, 0.0),
        receiver_pos=REC, opts=T_OPTS, device="cpu", directions=dirs)
    assert target.shape == (2, 2, SR)
    res = t_diff.fit_scene_parameters(
        t_scene, target, tparams, n_rays=256, steps=80, learning_rate=0.1,
        receiver_pos=REC, opts=T_OPTS, method="replay", device="cpu",
        directions=dirs)
    assert res.params["absorption"].shape == (1, 2)
    np.testing.assert_allclose(res.params["absorption"][-1], true_bands,
                               atol=0.06)
    assert res.final_loss < res.losses[0] * 0.05


def test_emitter_search_and_joint_fit_with_several_receivers():
    """examples/demo_4_inverse.py in small: three receivers, the coarse
    grid lands within a cell of the source, the joint fit (replay) moves
    absorption and emitter toward the truth; the losses of the grid equal
    JAX's (rtol 1e-3 with JAX's directions)."""
    true_em = np.array([0.8, -0.4, 0.6], np.float32)
    v, t = tt.box_room((12.0, 8.0, 10.0))
    t_scene = scene_from_arrays(v, t, 0.35)
    j_scene = jt.scene_from_arrays(v, t, 0.35)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=4)
    tparams = convert.trace_params_from_jax(params)
    recs = np.array([[2.0, 1.0, -1.5], [-3.0, -1.0, 2.0], [1.0, 2.5, 3.0]],
                    np.float32)
    dirs = np.array(j_sampling.sample_directions(jax.random.PRNGKey(7), 512))
    target = torch.stack([t_diff.render_soft_ir(
        t_scene, tparams, n_rays=512, emitter=true_em, receiver_pos=r,
        opts=T_OPTS, device="cpu", directions=dirs) for r in recs])
    grid = t_diff.emitter_grid(t_scene.bounds_min + 1.0,
                               t_scene.bounds_max - 1.0, spacing=3.0)
    best, losses = t_diff.coarse_emitter_search(
        t_scene, target, tparams, candidates=grid, receiver_pos=recs,
        n_rays=512, opts=T_OPTS, smooth_radius=16, device="cpu",
        directions=dirs)
    assert losses.shape == (len(grid),)
    assert np.linalg.norm(best - true_em) < 3.0
    _, losses_j = j_inverse.coarse_emitter_search(
        j_scene, jnp.asarray(target.numpy()), params, candidates=grid,
        receiver_pos=recs, n_rays=512, opts=J_OPTS, smooth_radius=16, seed=7)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-3)
    start = true_em + np.array([0.4, -0.3, 0.3], np.float32)
    res = t_diff.fit_scene_parameters(
        t_scene, target, tparams, n_rays=512, steps=40, learning_rate=0.03,
        fit_absorption=True, fit_emitter=True, smooth_radius=8,
        init_emitter=tuple(start), receiver_pos=recs, opts=T_OPTS,
        method="replay", replay_refresh=10, device="cpu", directions=dirs)
    assert res.final_loss < res.losses[0] * 0.5
    assert np.linalg.norm(res.params["emitter"] - true_em) < \
        np.linalg.norm(start - true_em)
    assert abs(res.params["absorption"][-1] - 0.35) < 0.15
    with pytest.raises(ValueError, match="multiple receivers"):
        t_diff.fit_scene_parameters(t_scene, target[0], tparams,
                                    receiver_pos=recs, device="cpu", steps=1)
    with pytest.raises(ValueError, match="nothing to fit"):
        t_diff.fit_scene_parameters(t_scene, target[0], tparams,
                                    fit_absorption=False, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        t_diff.fit_scene_parameters(t_scene, target[0], tparams,
                                    method="xla", device="cpu")


def test_large_scene_fit_records_through_the_schedule(monkeypatch):
    """A scene past the cluster threshold: the replay method Morton-sorts
    it into clusters of 32 and records through the schedule and K2, the
    material table following the sorted triangles."""
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc_cuda

    calls = []
    real = sc_cuda.trace_round_sched
    monkeypatch.setattr(sc_cuda, "trace_round_sched", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    scene = tt.office_scene(700)  # 652 triangles
    tparams = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=3))
    kw = dict(n_rays=256, receiver_pos=(6.0, 1.0, -8.0), opts=T_OPTS,
              device="cpu", seed=3)
    target = t_diff.render_soft_ir(scene, tparams, emitter=(0.0, 0.0, 0.0),
                                   **kw)
    res = t_diff.fit_scene_parameters(
        scene, target, tparams, steps=6, learning_rate=0.1, method="replay",
        replay_refresh=3, init_absorption=0.5, **kw)
    assert len(calls) == 2 * 3  # two recordings of three rounds
    assert res.losses[-1] < res.losses[0]
    assert 0.3 <= res.params["absorption"][-1] < 0.5  # true value 0.3


# ------------------------------------------------- Adam and the checkpoints

def _jax_fit_state(theta_np, grads_np, steps, lr):
    """theta and optax.adam state after ``steps`` updates with fixed
    gradients, and the flat leaves of (theta, opt_state)."""
    theta = {k: jnp.asarray(v) for k, v in theta_np.items()}
    grads = {k: jnp.asarray(v) for k, v in grads_np.items()}
    opt = optax.adam(lr)
    state = opt.init(theta)
    for _ in range(steps):
        updates, state = opt.update(grads, state)
        theta = optax.apply_updates(theta, updates)
    return theta, state, jax.tree.flatten((theta, state))[0]


def test_adam_step_from_jax_state_equals_optax():
    """``fit_state_from_jax``: after three optax steps, the port takes the
    fourth from the carried state on the same gradient and lands where
    optax lands, within 2e-5 of the learning rate (found 1e-5: the two
    apply the bias corrections in another order)."""
    rng = np.random.default_rng(0)
    theta0 = {"emitter": rng.standard_normal(3).astype(np.float32),
              "absorption_logits": rng.standard_normal((4, 2)).astype(
                  np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in theta0.items()}
    _, _, leaves = _jax_fit_state(theta0, grads, 3, 0.05)
    theta4, state4, _ = _jax_fit_state(theta0, grads, 4, 0.05)
    theta, opt_state = convert.fit_state_from_jax(
        [np.asarray(x) for x in leaves], theta0, device="cpu")
    assert opt_state.count == 3 and sorted(theta) == sorted(theta0)
    opt = torch.optim.Adam(list(theta.values()), lr=0.05)
    t_ckpt.load_adam_state(opt, theta, opt_state)
    for k, p in theta.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    for k in theta0:
        np.testing.assert_allclose(theta[k].detach().numpy(),
                                   np.asarray(theta4[k]), rtol=0,
                                   atol=2e-5 * 0.05)
    after = t_ckpt.adam_state_of(opt, theta)
    assert after.count == 4
    np.testing.assert_allclose(after.mu["emitter"].numpy(),
                               np.asarray(state4[0].mu["emitter"]), rtol=1e-6)
    # and back: the port's leaves are in optax's flatten order
    for mine, theirs in zip(t_ckpt.fit_leaves(theta, after),
                            jax.tree.flatten((theta4, state4))[0]):
        np.testing.assert_allclose(mine, np.asarray(theirs), rtol=1e-6,
                                   atol=2e-5 * 0.05)
    with pytest.raises(ValueError, match="leaves do not fit"):
        convert.fit_state_from_jax([np.zeros(3)] * 5, theta0, device="cpu")


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A fit stopped at step 10 in JAX resumes in the port from JAX's file
    and ends where the port's own uninterrupted fit ends (within 1e-3:
    JAX's first ten steps round otherwise); the port's file has JAX's keys
    and resumes in JAX."""
    j_scene, t_scene, params, tparams, dirs = _fit_setup()
    target = t_diff.render_soft_ir(
        t_scene, tparams, n_rays=256, emitter=(0.0, 0.0, 0.0),
        receiver_pos=REC, opts=T_OPTS, device="cpu", directions=dirs)
    kw = dict(n_rays=256, learning_rate=0.1, receiver_pos=REC,
              method="replay", replay_refresh=5)
    jkw = dict(kw, seed=11, opts=J_OPTS, checkpoint_every=5)
    tkw = dict(kw, opts=T_OPTS, device="cpu", directions=dirs,
               checkpoint_every=5)
    path = tmp_path / "fit"
    j_inverse.fit_scene_parameters(j_scene, jnp.asarray(target.numpy()),
                                   params, steps=10, checkpoint_path=path,
                                   **jkw)
    data = np.load(path.with_suffix(".npz"))
    assert int(data["step"]) == 10 and int(data["n_leaves"]) == 4
    resumed = t_diff.fit_scene_parameters(t_scene, target, tparams, steps=20,
                                          checkpoint_path=path, **tkw)
    straight = t_diff.fit_scene_parameters(t_scene, target, tparams,
                                           steps=20, **tkw)
    assert len(resumed.losses) == 20
    np.testing.assert_allclose(resumed.losses[:10], data["losses"])
    np.testing.assert_allclose(resumed.losses[10:], straight.losses[10:],
                               rtol=1e-2)
    np.testing.assert_allclose(resumed.params["absorption"],
                               straight.params["absorption"], atol=1e-3)
    # The port's file: the same keys, Adam's count as JAX wrote it.
    data = np.load(path.with_suffix(".npz"))
    assert sorted(data.files) == sorted(
        ["step", "losses", "n_leaves"] + [f"leaf_{i}" for i in range(4)])
    assert int(data["step"]) == 20 and int(data["leaf_1"]) == 20
    theta_like = {"absorption_logits": jnp.zeros(1)}
    step, theta, state, losses = j_ckpt.load_fit_state(
        path, theta_like, optax.adam(0.1).init(theta_like))
    assert step == 20 and len(losses) == 20
    logits = np.asarray(theta["absorption_logits"])
    np.testing.assert_allclose(1 / (1 + np.exp(-logits)),
                               resumed.params["absorption"], rtol=1e-6)
    # and JAX goes on from it
    more = j_inverse.fit_scene_parameters(
        j_scene, jnp.asarray(target.numpy()), params, steps=25,
        checkpoint_path=path, **jkw)
    assert len(more.losses) == 25
    assert more.losses[-1] < resumed.losses[9]
    assert t_ckpt.load_fit_state(tmp_path / "none", theta_like) is None
