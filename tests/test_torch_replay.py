"""The port's path recording and replay (diff/replay.py) against the JAX
package on tests/test_replay.py's scenes: the same numpy scene arrays and
the directions of JAX's sampler. The port does not contract multiply-adds,
XLA on the CPU does, so two recordings may part on a grazing ray: the bar
is identical paths for at least 99.5% of the rays, and each test prints how
many differ."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import accel as j_accel
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.diff import replay as j_replay
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.diff import inverse as t_inverse
from audiorenderingv2_tpu_torch.diff import replay as t_replay
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import replay_cuda as rp
from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc

torch.set_num_threads(1)

EMITTER = np.zeros(3, np.float32)
REC = np.array([-2.0, 1.0, -1.5], np.float32)
J_OPTS = ar.TracerOptions(block_size=2048, tri_chunk=512)
T_OPTS = t_tracer.TracerOptions(backend="autograd", block_size=2048,
                                tri_chunk=512, early_exit=False)


def _np(sc):
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


def _setup(n_bands=1, absorption=0.3, n_rays=4096):
    """tests/test_replay.py's room: a box with an icosphere in it."""
    bv, bt = jt.box_room((8.0, 6.0, 7.0))
    sv, st = jt.icosphere(radius=1.2, center=(1.5, -0.5, 1.0),
                          subdivisions=1)
    ab = np.concatenate([np.full(len(bt), absorption, np.float32),
                         np.full(len(st), 0.55, np.float32)])
    scene = jt.scene_from_arrays(np.vstack([bv, sv]),
                                 np.vstack([bt, st + len(bv)]), ab)
    params = ar.TraceParams(sample_rate=8000, ir_length=2000,
                            base_power=3.62, max_bounces=6,
                            energy_threshold=0.0, hrtf_absorption_rate=0.9,
                            n_bands=n_bands)
    sc = ar.scene_to_arrays(scene, 512)
    dirs = np.array(j_sampling.sample_directions(jax.random.PRNGKey(7),
                                                 n_rays))
    return (sc, convert.scene_arrays_from_jax(_np(sc), device="cpu"), dirs,
            params, convert.trace_params_from_jax(params))


def _clustered_setup(cs):
    """Its clustered scene: an icosphere room of 1,280 triangles."""
    v, t = jt.icosphere(radius=5.0, subdivisions=3)
    sorted_scene, clusters = j_accel.prepare_scene(
        jt.scene_from_arrays(v, t, 0.25), cluster_size=cs)
    sc = ar.scene_to_arrays(sorted_scene, 128, clusters=clusters)
    params = ar.TraceParams(sample_rate=8000, ir_length=8000,
                            base_power=3.62, max_bounces=5)
    dirs = np.array(j_sampling.sample_directions(jax.random.PRNGKey(11),
                                                 256))
    return (sc, convert.scene_arrays_from_jax(_np(sc), device="cpu"), dirs,
            params, convert.trace_params_from_jax(params))


def _same_paths(ids_a, recv_a, ids_b, recv_b, what):
    """Share of rays with identical paths; asserts the 99.5% bar."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    recv_a, recv_b = np.asarray(recv_a), np.asarray(recv_b)
    assert ids_a.shape == ids_b.shape and ids_a.dtype == ids_b.dtype
    same = (ids_a == ids_b).all(axis=1) & (recv_a == recv_b)
    print(f"{what}: {int((~same).sum())} of {same.size} rays differ")
    assert same.mean() >= 0.995, f"{what}: only {same.mean():.4f} agree"
    return same


# ------------------------------------------------------------ (c) recording

def test_record_paths_matches_jax():
    sc, sct, dirs, params, tparams = _setup()
    ids_j, recv_j = j_replay.record_paths(sc, jnp.asarray(dirs),
                                          jnp.asarray(EMITTER),
                                          jnp.asarray(REC), 30.0, params,
                                          J_OPTS)
    ids, recv = t_replay.record_paths(sct, torch.from_numpy(dirs), EMITTER,
                                      REC, 30.0, tparams, T_OPTS)
    assert ids.dtype == recv.dtype == torch.int32
    assert ids.shape == (4096, 6) and recv.shape == (4096,)
    _same_paths(ids, recv, ids_j, recv_j, "record_paths vs JAX")
    assert int((recv >= 0).sum()) > 0
    # a ragged last block records the same paths
    ids_b, recv_b = t_replay.record_paths(
        sct, torch.from_numpy(dirs), EMITTER, REC, 30.0, tparams,
        dataclasses.replace(T_OPTS, block_size=1000, tri_chunk=64))
    assert torch.equal(ids_b, ids) and torch.equal(recv_b, recv)


def test_record_paths_kernels_rows_route_matches_search_and_jax():
    """Unclustered: one-bounce rounds of K1 (its plain version here) with
    the alive-first partition between them. Equal to the port's plain
    search ray for ray; against JAX's Pallas recorder in interpret mode the
    99.5% bar."""
    sc, sct, dirs, params, tparams = _setup()
    d = torch.from_numpy(dirs)
    ids_k, recv_k = t_replay.record_paths_kernels(sct, d, EMITTER, REC, 30.0,
                                                  tparams)
    ids_s, recv_s = t_replay.record_paths(sct, d, EMITTER, REC, 30.0,
                                          tparams, T_OPTS)
    assert torch.equal(ids_k, ids_s) and torch.equal(recv_k, recv_s)
    ids_p, recv_p = j_replay.record_paths_pallas(
        sc, jnp.asarray(dirs), jnp.asarray(EMITTER), jnp.asarray(REC), 30.0,
        params, ar.TracerOptions(backend="pallas", pallas_version=2,
                                 pallas_interpret=True))
    _same_paths(ids_k, recv_k, ids_p, recv_p, "rows recorder vs JAX Pallas")


@pytest.mark.parametrize("cs,schedule", [(128, False), (32, False),
                                         (32, True)])
def test_record_paths_kernels_clustered_matches_jax(cs, schedule):
    """Clustered: K5 (the recorder's default) and the schedule + K2, plain
    versions here, against the port's search (equal), JAX's search and
    JAX's Pallas recorder in interpret mode in the same mode (99.5%)."""
    sc, sct, dirs, params, tparams = _clustered_setup(cs)
    rec = np.array([1.5, 0.5, -0.5], np.float32)
    d = torch.from_numpy(dirs)
    opts = t_tracer.TracerOptions(schedule=schedule)
    before = tc.trace_traverse_launches
    ids_k, recv_k = t_replay.record_paths_kernels(sct, d, EMITTER, rec, 0.0,
                                                  tparams, opts)
    assert tc.trace_traverse_launches == before  # the CPU launches nothing
    ids_s, recv_s = t_replay.record_paths(
        sct, d, EMITTER, rec, 0.0, tparams,
        dataclasses.replace(T_OPTS, block_size=256, tri_chunk=128))
    assert torch.equal(ids_k, ids_s) and torch.equal(recv_k, recv_s)
    jargs = (sc, jnp.asarray(dirs), jnp.zeros(3), jnp.asarray(rec), 0.0,
             params)
    ids_x, recv_x = j_replay.record_paths(
        *jargs, ar.TracerOptions(block_size=256, tri_chunk=128))
    _same_paths(ids_k, recv_k, ids_x, recv_x, "clustered recorder vs JAX")
    popts = ar.TracerOptions(
        backend="pallas", pallas_version=2, pallas_interpret=True,
        **(dict(pallas_schedule=True, pallas_key_layout="dir72",
                pallas_cell_bits=5) if schedule else {}))
    ids_p, recv_p = j_replay.record_paths_pallas(*jargs, popts)
    _same_paths(ids_k, recv_k, ids_p, recv_p,
                "clustered recorder vs JAX Pallas")
    # The replayed IR of the recorded paths is the forward render's.
    ir_fwd = t_tracer.trace_ir(sct, d, EMITTER, rec, 0.0, tparams, opts)
    ir_rep = t_replay.render_ir_replay(sct, ids_k, recv_k, d, EMITTER, rec,
                                       0.0, tparams, soft_binning=False)
    # launch order against the sorted order: f32 summation only
    jt.assert_ir_close(ir_rep.numpy(), ir_fwd.numpy(), rtol=2e-4, atol=1e-7)


def test_record_in_chunks_with_n_total_rays():
    """Two halves recorded with ``n_total_rays`` give the whole launch's
    paths, under an energy threshold that ends rays early."""
    _, sct, dirs, _, tparams = _setup(absorption=0.8, n_rays=1024)
    e0 = tparams.base_power / (1024 * 4.18879020478)
    tparams = dataclasses.replace(tparams, energy_threshold=e0 * 0.05)
    d = torch.from_numpy(dirs)
    for record in (t_replay.record_paths_kernels, t_replay.record_paths):
        whole = record(sct, d, EMITTER, REC, 0.0, tparams)
        halves = [record(sct, d[i:i + 512], EMITTER, REC, 0.0, tparams,
                         n_total_rays=1024) for i in (0, 512)]
        assert torch.equal(torch.cat([h[0] for h in halves]), whole[0])
        assert torch.equal(torch.cat([h[1] for h in halves]), whole[1])
        alone = record(sct, d[:512], EMITTER, REC, 0.0, tparams)
        assert not torch.equal(alone[0], whole[0][:512])  # e0 matters
    with pytest.raises(ValueError, match="2\\^24"):
        t_replay.record_paths_kernels(
            sct, torch.zeros((1, 3)).expand(2 ** 24 + 1, 3), EMITTER, REC,
            0.0, tparams)


# --------------------------------------------------------------- the replay

@pytest.mark.parametrize("n_bands,threshold", [(1, False), (2, False),
                                               (1, True)])
def test_replay_forward_matches_tracer_and_jax(n_bands, threshold):
    """Replay == the port's tracer on the recorded topology (the same
    arithmetic on the same path, launch order: rtol 1e-6), with the energy
    threshold ending paths too; against the JAX replay the statistical
    bar."""
    sc, sct, dirs, params, tparams = _setup(
        n_bands=n_bands, absorption=0.8 if threshold else 0.3)
    if threshold:
        e0 = params.base_power / (dirs.shape[0] * 4.18879020478)
        params = dataclasses.replace(params, energy_threshold=e0 * 0.05)
        tparams = convert.trace_params_from_jax(params)
    d = torch.from_numpy(dirs)
    ir_ref = t_tracer.trace_ir(sct, d, EMITTER, REC, 30.0, tparams, T_OPTS)
    ids, recv = t_replay.record_paths(sct, d, EMITTER, REC, 30.0, tparams,
                                      T_OPTS)
    ir_rep = t_replay.render_ir_replay(sct, ids, recv, d, EMITTER, REC, 30.0,
                                       tparams, soft_binning=False)
    jt.assert_ir_close(ir_rep.numpy(), ir_ref.numpy(), rtol=1e-6, atol=1e-12)
    assert float(ir_rep.sum()) > 0
    ev = t_replay.replay_events(sct, ids, recv, d, EMITTER, REC, 30.0,
                                tparams)
    assert torch.equal(ev[1].sum(dim=-1) > 0, recv >= 0)
    jargs = (jnp.asarray(dirs), jnp.asarray(EMITTER), jnp.asarray(REC), 30.0,
             params)
    ids_j, recv_j = j_replay.record_paths(sc, *jargs, J_OPTS)
    ir_j = j_replay.render_ir_replay(sc, ids_j, recv_j, *jargs,
                                     soft_binning=False)
    jt.assert_ir_close(ir_rep.numpy(), np.asarray(ir_j), exact=False)


def test_replay_absorption_grad_matches_full_tracer_and_jax():
    """d(loss)/d(absorption table) through the replay, through the port's
    autograd tracer (rtol 2e-4, the JAX test's bar) and through JAX's
    replay on JAX's own recording (rtol 1e-3: found 2e-5)."""
    sc, sct, dirs, params, tparams = _setup()
    d = torch.from_numpy(dirs)
    tri_mat = (sct.valid > 0).long()  # slot 1 drives every real triangle
    opts = dataclasses.replace(T_OPTS, soft_binning=True)

    def ir_full(a):
        return t_tracer.trace_ir(sct._replace(absorption=a[tri_mat]), d,
                                 EMITTER, REC, 30.0, tparams, opts)

    ids, recv = t_replay.record_paths_kernels(sct, d, EMITTER, REC, 30.0,
                                              tparams)

    def ir_rep(a):
        return t_replay.render_ir_replay(
            sct._replace(absorption=a[tri_mat]), ids, recv, d, EMITTER, REC,
            30.0, tparams, soft_binning=True)

    a0 = np.array([0.0, 0.35], np.float32)
    with torch.no_grad():
        target = ir_full(torch.tensor(a0 + 0.1))
    grads = []
    for fn in (ir_full, ir_rep):
        a = torch.tensor(a0, requires_grad=True)
        (((fn(a) - target) ** 2).sum() * 1e6).backward()
        grads.append(a.grad.numpy())
    assert np.isfinite(grads[1]).all() and grads[1][1] != 0
    np.testing.assert_allclose(grads[1], grads[0], rtol=2e-4, atol=1e-12)

    j_mat = jnp.asarray(tri_mat.numpy())
    jargs = (jnp.asarray(dirs), jnp.asarray(EMITTER), jnp.asarray(REC), 30.0,
             params)
    ids_j, recv_j = j_replay.record_paths(sc, *jargs, J_OPTS)

    def j_loss(a):
        ir = j_replay.render_ir_replay(sc._replace(absorption=a[j_mat]),
                                       ids_j, recv_j, *jargs,
                                       soft_binning=True)
        return jnp.sum((ir - jnp.asarray(target.numpy())) ** 2) * 1e6

    g_j = np.asarray(jax.grad(j_loss)(jnp.asarray(a0)))
    np.testing.assert_allclose(grads[1], g_j, rtol=1e-3, atol=1e-12)


def test_replay_pose_and_geometry_grads():
    """Emitter gradient of the replay against central differences (rtol
    0.08 as in the JAX test) and against JAX's; receiver and plane-row
    gradients exist and every one is finite."""
    sc, sct, dirs, params, tparams = _setup()
    d = torch.from_numpy(dirs)
    ids, recv = t_replay.record_paths_kernels(sct, d, EMITTER, REC, 0.0,
                                              tparams)
    with torch.no_grad():
        target = t_replay.render_ir_replay(sct, ids, recv, d, EMITTER + 0.05,
                                           REC, 0.0, tparams)

    def loss(em, rec=torch.from_numpy(REC), scene=sct):
        ir = t_replay.render_ir_replay(scene, ids, recv, d, em, rec, 0.0,
                                       tparams)
        return ((t_inverse.smooth_ir(ir, 3)
                 - t_inverse.smooth_ir(target, 3)) ** 2).sum() * 1e9

    em = torch.tensor(EMITTER, requires_grad=True)
    rec = torch.tensor(REC, requires_grad=True)
    leaves = {f: getattr(sct, f).clone().requires_grad_(True)
              for f in ("plane_n", "plane_d", "normal")}
    loss(em, rec, sct._replace(**leaves)).backward()
    for name, leaf in {**leaves, "emitter": em, "receiver": rec}.items():
        assert torch.isfinite(leaf.grad).all(), name
        assert leaf.grad.abs().sum() > 0, name
    g = em.grad.numpy()
    eps = 1e-3
    with torch.no_grad():
        for axis in range(3):
            e = torch.zeros(3)
            e[axis] = eps
            fd = (float(loss(torch.from_numpy(EMITTER) + e))
                  - float(loss(torch.from_numpy(EMITTER) - e))) / (2 * eps)
            np.testing.assert_allclose(g[axis], fd, rtol=0.08, atol=1e-7)
    assert g.sum() < 0.0  # it pulls the emitter toward the target offset

    from audiorenderingv2_tpu.diff import inverse as j_inverse
    ids_j, recv_j = jnp.asarray(ids.numpy()), jnp.asarray(recv.numpy())

    def j_loss(e):
        ir = j_replay.render_ir_replay(sc, ids_j, recv_j, jnp.asarray(dirs),
                                       e, jnp.asarray(REC), 0.0, params)
        return jnp.sum((j_inverse.smooth_ir(ir, 3) - j_inverse.smooth_ir(
            jnp.asarray(target.numpy()), 3)) ** 2) * 1e9

    g_j = np.asarray(jax.grad(j_loss)(jnp.asarray(EMITTER)))
    # Same topology in both; the slack is the cumsum smoothing and JAX's
    # sort-path histogram VJP in f32 (found 3e-3 of the norm).
    np.testing.assert_allclose(g, g_j, rtol=0,
                               atol=2e-2 * np.linalg.norm(g_j))


@pytest.mark.parametrize("table", [False, True])
def test_replay_pose_pair_emitter_grad_matches_jax(monkeypatch, table):
    """The emitter alone (``table``: with the absorption table) requiring a
    gradient takes the pose pair, whose emitter gradient (and table
    gradient) equals ``jax.grad`` of JAX's replay on the same recorded
    paths: the emitter at the bar of the chain's test above, the table at
    the absorption test's rtol 1e-3."""
    sc, sct, dirs, params, tparams = _setup()
    d = torch.from_numpy(dirs)
    tri_mat = (sct.valid > 0).long()
    ids, recv = t_replay.record_paths_kernels(sct, d, EMITTER, REC, 0.0,
                                              tparams)
    a0 = np.array([0.0, 0.3], np.float32)
    with torch.no_grad():
        target = t_replay.render_ir_replay(sct, ids, recv, d, EMITTER + 0.05,
                                           REC, 0.0, tparams)
    calls = []
    for name in ("chain_events", "replay_absorption", "replay_pose_pair"):
        def spy(*a, _fn=getattr(rp, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(rp, name, spy)
    em = torch.tensor(EMITTER, requires_grad=True)
    a = torch.tensor(a0, requires_grad=table)
    ir = t_replay.render_ir_replay(sct._replace(absorption=a[tri_mat]), ids,
                                   recv, d, em, REC, 0.0, tparams)
    ((t_inverse.smooth_ir(ir, 3) - t_inverse.smooth_ir(target, 3)) ** 2
     ).sum().mul(1e9).backward()
    # (On the CPU the pair's plain version runs the chain's ops inside.)
    assert calls[0] == "replay_pose_pair"

    from audiorenderingv2_tpu.diff import inverse as j_inverse
    ids_j, recv_j = jnp.asarray(ids.numpy()), jnp.asarray(recv.numpy())
    j_mat = jnp.asarray(tri_mat.numpy())

    def j_loss(e, aj):
        ir = j_replay.render_ir_replay(sc._replace(absorption=aj[j_mat]),
                                       ids_j, recv_j, jnp.asarray(dirs), e,
                                       jnp.asarray(REC), 0.0, params)
        return jnp.sum((j_inverse.smooth_ir(ir, 3) - j_inverse.smooth_ir(
            jnp.asarray(target.numpy()), 3)) ** 2) * 1e9

    g_e, g_a = (np.asarray(x) for x in jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(EMITTER), jnp.asarray(a0)))
    np.testing.assert_allclose(em.grad.numpy(), g_e, rtol=0,
                               atol=2e-2 * np.linalg.norm(g_e))
    if table:
        np.testing.assert_allclose(a.grad.numpy(), g_a, rtol=1e-3,
                                   atol=1e-12)


def test_replay_rejects_partial_band_tables():
    _, sct, dirs, _, tparams = _setup(n_rays=64)
    bad = sct._replace(absorption=sct.absorption[:, None].expand(-1, 3))
    ids = torch.zeros((64, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="only 1-band scenes broadcast"):
        t_replay.replay_events(
            bad, ids, ids[:, 0], torch.from_numpy(dirs), EMITTER, REC, 0.0,
            dataclasses.replace(tparams, n_bands=2))


def test_recorder_sets_rayid_and_recvd():
    """``init_state`` leaves RAYID and RECVD at 0; the recorder sets the
    launch index and -1 itself, so a ray that never reaches the receiver
    records -1 and padding rays record nothing."""
    _, sct, dirs, _, tparams = _setup(n_rays=200)  # pads to 256
    state = rc.init_state(torch.from_numpy(dirs), torch.zeros(3), 1.0, 256)
    assert not state[rc._C_RAYID].any() and not state[rc._C_RECVD].any()
    ids, recv = t_replay.record_paths_kernels(
        sct, torch.from_numpy(dirs), EMITTER, REC, 0.0, tparams)
    assert ids.shape == (200, 6) and recv.shape == (200,)
    assert int(recv.min()) == -1 and int(recv.max()) >= 0
    assert int(ids.min()) == -1 and int(ids.max()) >= 12  # sphere rows


# ------------------------------------------- the absorption-only kernel pair

def _kernel_case(n_bands, dtype):
    """The box room's recorded paths with a per-band absorption table in
    ``dtype``, one often visited wall at absorption 1 in every band. The
    paths hold rays that never reach the receiver, deposits at step 0 and
    triangles visited twice before the deposit."""
    _, sct, dirs, _, tparams = _setup(n_bands=n_bands, n_rays=2048)
    d = torch.from_numpy(dirs)
    ids, recv = t_replay.record_paths_kernels(sct, d, EMITTER, REC, 30.0,
                                              tparams)
    before = [row[:r].tolist() for row, r in zip(ids, recv) if r > 0]
    assert (recv < 0).any() and (recv == 0).any()
    assert any(len({t for t in p if t >= 0}) < sum(t >= 0 for t in p)
               for p in before)
    wall = int(torch.mode(ids[recv > 1, 0]).values)
    scales = torch.linspace(0.5, 1.5, n_bands)
    absorb = (sct.absorption[:, None] * scales).clamp(max=1.0)
    absorb[wall] = 1.0
    sc = sct._replace(**{f: getattr(sct, f).to(dtype) for f in
                         ("plane_n", "plane_d", "normal")},
                      absorption=absorb.to(dtype))
    return sc, ids, recv, d, tparams, wall


def _chain(sc, ids, recv, d, tparams, absorb):
    e0 = tparams.base_power / (ids.shape[0] * 4.18879020478)
    yaw = torch.deg2rad(torch.tensor(30.0))
    return rp.chain_events(sc.plane_n, sc.plane_d, sc.normal, absorb, ids,
                           recv, d, torch.from_numpy(EMITTER),
                           torch.from_numpy(REC), torch.sin(yaw),
                           torch.cos(yaw), e0,
                           tparams.sample_rate / 343.0)[:3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_bands", [1, 8])
def test_replay_plain_equals_chain(n_bands, dtype):
    """The kernel pair's plain version against the eager chain's autograd:
    the events bit for bit, the table's gradient to rounding (float64 to
    1e-12, float32 to 1e-5 of each entry plus 1e-6 of the largest); the
    wall at absorption 1 gets the chain's gradient, not a division by 0."""
    sc, ids, recv, d, tparams, wall = _kernel_case(n_bands, dtype)
    w = torch.rand((ids.shape[0], n_bands), dtype=dtype,
                   generator=torch.Generator().manual_seed(n_bands)) + 0.5
    grads, events = [], []
    for fn in ("kernel", "chain"):
        a = sc.absorption.clone().requires_grad_(True)
        if fn == "kernel":
            ev = t_replay.replay_events(sc._replace(absorption=a), ids, recv,
                                        d, EMITTER, REC, 30.0, tparams)
        else:
            ev = _chain(sc, ids, recv, d, tparams, a)
        (ev[1] * w).sum().backward()
        events.append(ev)
        grads.append(a.grad)
    for got, want in zip(*events):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert (events[0][1][recv == 0] > 0).all()
    rtol, atol = (1e-12, 1e-14) if dtype == torch.float64 else (1e-5, 1e-6)
    top = float(grads[1].abs().max())
    torch.testing.assert_close(grads[0], grads[1], rtol=rtol,
                               atol=atol * top)
    assert (grads[1][wall] != 0).all() and torch.isfinite(grads[0]).all()


@pytest.mark.parametrize("leaf", [None, "absorption", "emitter", "receiver",
                                  "yaw", "dirs", "plane_n", "plane_d",
                                  "normal"])
def test_replay_dispatch_follows_what_requires_grad(monkeypatch, leaf):
    """The absorption pair (span ``ar2.replay.kernel``) where nothing but
    the absorption table requires a gradient, the pose pair (the same
    span) where the emitter does too, the chain (span
    ``ar2.replay.chain``) wherever the receiver, the yaw, the directions
    or a triangle row does; the same events every way."""
    _, sct, dirs, _, tparams = _setup(n_rays=256)
    d = torch.from_numpy(dirs)
    ids, recv = t_replay.record_paths_kernels(sct, d, EMITTER, REC, 30.0,
                                              tparams)
    args = {"emitter": torch.from_numpy(EMITTER),
            "receiver": torch.from_numpy(REC), "yaw": torch.tensor(30.0),
            "dirs": d}
    sc = sct
    if leaf in args:
        args[leaf] = args[leaf].clone().requires_grad_(True)
    elif leaf is not None:
        sc = sct._replace(**{leaf: getattr(sct, leaf).clone()
                             .requires_grad_(True)})
    calls = []
    for name in ("chain_events", "replay_absorption", "replay_pose_pair"):
        def spy(*a, _fn=getattr(rp, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(rp, name, spy)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ev = t_replay.replay_events(sc, ids, recv, args["dirs"],
                                    args["emitter"], args["receiver"],
                                    args["yaw"], tparams)
    kernel = leaf in (None, "absorption", "emitter")
    pair = "replay_pose_pair" if leaf == "emitter" else "replay_absorption"
    # (On the CPU the pair's plain version runs the chain's ops inside.)
    assert calls[0] == (pair if kernel else "chain_events")
    assert not {"replay_absorption", "replay_pose_pair"} & set(calls[1:]) \
        and (kernel or calls == ["chain_events"])
    spans = {e.name for e in prof.events() if e.name.startswith("ar2.")}
    assert spans == {"ar2.replay.kernel" if kernel else "ar2.replay.chain"}
    want = t_replay.replay_events(sct, ids, recv, d, EMITTER, REC, 30.0,
                                  tparams)
    for got, ref in zip(ev, want):
        assert torch.equal(got.detach(), ref)


def test_render_ir_replay_log_loss_plain_equals_chain():
    """Soft binning and the log loss at test size: the same loss and the
    same absorption gradient through the absorption pair's plain version
    as through the chain (a receiver that requires a gradient takes the
    chain) and through the pose pair's (an emitter that requires one takes
    the pose pair)."""
    _, sct, dirs, _, tparams = _setup()
    d = torch.from_numpy(dirs)
    ids, recv = t_replay.record_paths_kernels(sct, d, EMITTER, REC, 30.0,
                                              tparams)
    tri_mat = (sct.valid > 0).long()
    with torch.no_grad():
        target = t_replay.render_ir_replay(
            sct._replace(absorption=torch.tensor([0.0, 0.4])[tri_mat]), ids,
            recv, d, EMITTER, REC, 30.0, tparams)
    out = []
    for grad_of in (None, "receiver", "emitter"):
        em = torch.from_numpy(EMITTER).requires_grad_(grad_of == "emitter")
        rec = torch.from_numpy(REC).requires_grad_(grad_of == "receiver")
        a = torch.tensor([0.0, 0.3], requires_grad=True)
        ir = t_replay.render_ir_replay(sct._replace(absorption=a[tri_mat]),
                                       ids, recv, d, em, rec, 30.0, tparams)
        loss = t_inverse.ir_loss(ir, target, "log")
        loss.backward()
        out.append((loss.detach(), a.grad))
    assert float(out[0][0]) > 0 and out[0][1][1] != 0
    for loss, grad in out[1:]:
        assert torch.equal(out[0][0], loss)
        torch.testing.assert_close(out[0][1], grad, rtol=1e-5, atol=0)


def test_replay_kernels_are_declared_and_launched():
    """Both C entries are defined in their source, declared in _build's
    signatures and launched by their wrappers. Each also takes the pose
    pair's buffers (``tan``; the backward's ``g_bin``, ``ev_w``, ``tan``
    and ``grad_e``), null for the absorption pair."""
    import inspect

    from audiorenderingv2_tpu_torch.ops import _build

    cu = (_build.CSRC / "replay.cu").read_text()
    for entry, fn, n_args in (("ar2_replay", rp.replay, 23),
                              ("ar2_replay_bwd", rp.replay_bwd, 16)):
        assert f'extern "C" int {entry}(' in cu
        assert len(_build._SIGNATURES[entry]) == n_args
        assert f".{entry}(" in inspect.getsource(fn)


@pytest.mark.parametrize("bad", ["ids_int64", "recv_shape", "absorb_rows",
                                 "meta", "bwd_shape"])
def test_replay_wrappers_reject(bad):
    _, sct, dirs, _, _ = _setup(n_rays=64)
    ids = torch.zeros((64, 6), dtype=torch.int32)
    recv = torch.zeros(64, dtype=torch.int32)
    args = dict(tri_ids=ids, recv_step=recv, dirs=torch.from_numpy(dirs),
                scal=torch.zeros(8), plane_n=sct.plane_n,
                plane_d=sct.plane_d, normal=sct.normal,
                absorb=sct.absorption[:, None], e0=1.0, bin_rate=1.0)
    if bad == "bwd_shape":
        with pytest.raises(ValueError, match="g \\[N, n_bands\\]"):
            rp.replay_bwd(ids, recv, torch.zeros(64), torch.zeros((64, 2)),
                          sct.absorption[:, None], 1.0)
        return
    if bad == "ids_int64":
        args["tri_ids"] = ids.long()
    elif bad == "recv_shape":
        args["recv_step"] = recv[:10]
    elif bad == "absorb_rows":
        args["absorb"] = args["absorb"][:-1]
    else:
        args = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}
    err = TypeError if bad == "ids_int64" else ValueError
    with pytest.raises(err):
        rp.replay(**args)
