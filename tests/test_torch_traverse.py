"""K5's plain version (the in-kernel front-to-back cluster traversal)
against the JAX package's kernel in interpret mode and against the schedule
route, the ``schedule`` flag through ``trace_events`` and ``trace_ir``, and
the renderer with explicit options, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import accel as j_accel
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.ops import raytrace_pallas as rp
from audiorenderingv2_tpu.ops import raytrace_pallas_v2 as rp2
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch import tuned
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc_cuda
from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc
from test_torch_schedule import (SPECIAL, ico_boxes, office,
                                 office_after_one_bounce, rays_state,
                                 seeded_rays, superboxes)

torch.set_num_threads(1)

SR = 16000
REC = np.array([1.5, 0.5, -1.0], np.float32)
EMITTER = np.array([0.5, -0.2, 0.1], np.float32)


def _np(sc):
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _clustered(cs, n_bands=1, scene=None):
    """An icosphere room of 1,280 triangles (or ``scene``) in clusters of
    ``cs``: the JAX package's scene arrays and the port's copy."""
    if scene is None:
        v, t = jt.icosphere(radius=6.0, subdivisions=3)
        absorb = np.linspace(0.1, 0.5, t.shape[0] * n_bands).astype(
            np.float32).reshape(t.shape[0], n_bands)
        scene = jt.scene_from_arrays(v, t, absorb if n_bands > 1 else 0.2)
    sorted_scene, clusters = j_accel.prepare_scene(scene, cluster_size=cs)
    sc = ar.scene_to_arrays(sorted_scene, 128, clusters=clusters)
    return sc, convert.scene_arrays_from_jax(_np(sc), device="cpu")


def _start(sc, sct, n, n_bands, max_bounces=20, yaw=25.0):
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=max_bounces, n_bands=n_bands)
    e0 = params.base_power / (n * 4.0 / 3.0 * np.pi)
    state = rp.init_state(jnp.asarray(_dirs(n, 9)), jnp.asarray(EMITTER), e0,
                          n, ncols=rp2.state_ncols(n_bands),
                          en_cols=tuple(rp2._band_cols(n_bands)[0]))
    scal = rp._scalars(jnp.asarray(EMITTER), jnp.asarray(REC),
                       jnp.deg2rad(jnp.float32(yaw)), e0, params)
    return params, convert.trace_params_from_jax(params), state, scal


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("cs,n_bands,budget", [
    (32, 1, 1), (128, 1, 1), (32, 3, 1), (32, 1, 3), (128, 1, 4)])
def test_trace_traverse_plain_matches_pallas_kernel(cs, n_bands, budget):
    """K5's plain version against ``trace_round_v2`` with boxes and no
    schedule (the in-kernel traversal) in interpret mode, from the start
    state and from the JAX state after one round, at clusters of 32 and
    128, one and several bounces a round. Every column, LTRI and RECVD
    included, within 1e-5 per bounce of the round (XLA on the CPU contracts
    multiply-adds, the port does not)."""
    sc, sct = _clustered(cs, n_bands)
    n = 256
    params, tparams, state, scal = _start(sc, sct, n, n_bands)
    rows_j, _, boxes_j = rp2.pack_tris_v2(sc, n_bands)
    rows_t, boxes_t = rc.pack_tris_clusters(sct, n_bands)
    tscal = torch.tensor(np.asarray(scal)[0])
    for step in range(2):
        ref = rp2.from_tiles(rp2.trace_round_v2(
            rp2.to_tiles(state), rows_j, None, boxes_j, scal, params, budget,
            interpret=True))
        st = torch.tensor(np.asarray(state).T.copy())
        visits = torch.zeros(n // 128, dtype=torch.int32)
        got = tc.trace_traverse(st, rows_t, boxes_t, tscal, tparams, budget,
                                visits=visits)
        r = np.asarray(ref).T
        assert got.shape == r.shape
        for c in range(r.shape[0]):
            np.testing.assert_allclose(got[c].numpy(), r[c],
                                       rtol=1e-5 * budget,
                                       atol=1e-5 * budget,
                                       err_msg=f"step {step}, column {c}")
        assert (r[rc._C_LTRI] > 0).any()
        assert 0 < int(visits.min()) and \
            int(visits.max()) <= budget * boxes_t.shape[0]
        state = ref
    assert (r[rc._C_DONE] == 0).any()


@pytest.mark.parametrize("cs", [32, 128])
def test_trace_traverse_plain_matches_schedule_route(cs):
    """K5 against the schedule and K2 (both plain here) over five rounds
    with the coherent sort between them: every column bit-equal on this
    scene (no two triangles tie for a ray's nearest hit), and the visits
    never exceed the schedule's candidates."""
    sc, sct = _clustered(cs)
    n = 512
    _, tparams, state, scal = _start(sc, sct, n, 1)
    rows, boxes = rc.pack_tris_clusters(sct)
    tscal = torch.tensor(np.asarray(scal)[0])
    a = torch.tensor(np.asarray(state).T.copy())
    b = a.clone()
    for step in range(5):
        visits = torch.zeros(n // 128, dtype=torch.int32)
        sched = sc_cuda.tile_schedule(b, boxes)
        a = tc.trace_traverse(a, rows, boxes, tscal, tparams, visits=visits)
        b = sc_cuda.trace_round_sched(b, rows, boxes, sched, tscal, tparams)
        assert torch.equal(a, b), f"round {step}"
        assert (visits <= sched[:, 0]).all()
        a = rc._sort_state_by_keys(a, rc._compaction_keys(a))
        b = a.clone()
    assert (a[rc._C_EVW] > 0).any()


def test_traverse_skips_invalid_boxes_and_dead_tiles():
    """A padded cluster (valid flag 0, zeroed box) is never visited although
    its zero box passes the slab test of rays through the origin; a tile
    whose rays are all done visits nothing; a tile whose rays all look at
    one sphere stops before the clusters behind its front."""
    scene = tt.office_scene(1000)  # 972 triangles pad to 1,024
    sc, sct = _clustered(32, scene=scene)
    boxes_full = sct.cluster_boxes
    assert int((boxes_full[:, 6] == 0).sum()) == 1
    _, tparams, state, scal = _start(sc, sct, 256, 1)
    # Keep the padded cluster in the packing (pack_tris_clusters trims it).
    rows = rc._stack_rows(sct, 1).contiguous()
    st = torch.tensor(np.asarray(state).T.copy())
    st[rc._C_PX:rc._C_PZ + 1] = 0.0        # rays from the origin
    st[rc._C_DONE, 128:] = 1.0             # the second tile is dead
    centre = tt.office_mesh(1000)[0][8:8 + 162].mean(axis=0)  # first sphere
    aim = centre + 0.1 * np.random.default_rng(1).normal(size=(128, 3))
    aim = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(
        np.float32)
    st[rc._C_VX:rc._C_VZ + 1, :128] = torch.from_numpy(aim.T)
    visits = torch.zeros(2, dtype=torch.int32)
    tscal = torch.tensor(np.asarray(scal)[0])
    out = tc.trace_traverse(st.clone(), rows, boxes_full.contiguous(), tscal,
                            tparams, visits=visits)
    assert 0 < int(visits[0]) <= 31 and int(visits[1]) == 0
    reach = sc_cuda.tile_schedule(st, boxes_full.contiguous())[:, 0]
    assert int(visits[0]) < int(reach[0])  # the traversal stops early
    assert torch.equal(out[:, 128:], st[:, 128:].index_fill(
        0, torch.tensor([rc._C_LTRI]), 0.0))
    flat = rc.trace_round_plain(st.clone(), rows, tscal, tparams, 1)
    assert torch.equal(out, flat)  # same hits as K1 over every row


@pytest.mark.parametrize("budgets", [None, (2, 4), (6,)])
def test_trace_events_schedule_flag(budgets):
    """Clustered ``trace_events`` with ``schedule=False`` runs K5 (the
    schedule's functions are not called), takes rounds of several bounces,
    and gives the events of the schedule route bit for bit."""
    sc, sct = _clustered(32)
    rows, boxes = rc.pack_scene(sct)
    tparams = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=6))
    args = (rows, torch.from_numpy(_dirs(300, 4)), torch.from_numpy(EMITTER),
            torch.from_numpy(REC), 10.0, tparams)
    ref = rc.trace_events(*args, boxes=boxes, route=rc.Route("sched", "sort"))
    real = sc_cuda.tile_schedule
    try:
        sc_cuda.tile_schedule = None  # calling it would raise
        got = rc.trace_events(*args, boxes=boxes,
                              round_budgets=budgets, route=rc.Route(
                                  "k5", "sort" if budgets != (6,) else None))
    finally:
        sc_cuda.tile_schedule = real
    if budgets is None:  # the same ray order at the end: slot for slot
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    # any schedule: the same multiset of events
    key = lambda ev: torch.sort(ev[0] * 4 + ev[2])[0]  # noqa: E731
    assert torch.equal(key(got), key(ref))
    assert torch.equal(torch.sort(got[1][:, 0])[0],
                       torch.sort(ref[1][:, 0])[0])
    assert (got[1] > 0).any()


def test_traverse_pose_batch_matches_single_poses():
    """K5 with one scalar row per pose: each pose's segment equals a
    single-pose call, bit for bit in every column, over two rounds with the
    per-pose sort between. ``trace_events_pose_batch`` itself batches a
    clustered scene only through the schedule, as the JAX package's does."""
    sc, sct = _clustered(32)
    rows, boxes = rc.pack_scene(sct)
    tparams = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=4))
    p, n = 3, 256
    d = torch.from_numpy(np.stack([_dirs(n, 20 + i) for i in range(p)]))
    em = torch.tensor([[0.5, -0.2, 0.1], [-1.0, 0.4, 0.3], [0.0, 0.0, 2.0]])
    rcv = torch.tensor([[1.5, 0.5, -1.0], [0.0, 2.0, 1.0], [-2.0, 0.1, 0.2]])
    yaw = torch.tensor([0.0, 45.0, 200.0])
    scal = rc.scalars(em, rcv, yaw, 1e-6, tparams)
    state = rc.init_state(d, em, 1e-6, n)
    for budget in (1, 2):
        out = tc.trace_traverse(state.clone(), rows, boxes, scal, tparams,
                                budget, n)
        for i in range(p):
            seg = slice(i * n, (i + 1) * n)
            one = tc.trace_traverse(state[:, seg].contiguous(), rows, boxes,
                                    scal[i].contiguous(), tparams, budget)
            assert torch.equal(out[:, seg], one), f"pose {i}, budget {budget}"
        state = rc._sort_state_by_keys(
            out, rc._compaction_keys(out, n_poses=p), p)
    assert (state[rc._C_EVW] > 0).any()
    with pytest.raises(ValueError, match="requires schedule=True"):
        rc.trace_events_pose_batch(rows, d, em, rcv, yaw, tparams,
                                   boxes=boxes, route=rc.Route("k5", "sort"))


def test_trace_ir_default_options_run_the_traversal(monkeypatch):
    """``TracerOptions()`` on a clustered scene runs K5;
    ``tuned.auto_options`` sets ``schedule``, which runs the schedule and
    K2. Both against the JAX package's in-kernel traversal in interpret
    mode, the statistical bar (other rounding, six bounces)."""
    calls = {"k5": 0, "k2": 0}
    real_k5, real_k2 = tc.trace_traverse, sc_cuda.trace_round_sched
    monkeypatch.setattr(tc, "trace_traverse", lambda *a, **k: (
        calls.__setitem__("k5", calls["k5"] + 1), real_k5(*a, **k))[1])
    monkeypatch.setattr(sc_cuda, "trace_round_sched", lambda *a, **k: (
        calls.__setitem__("k2", calls["k2"] + 1), real_k2(*a, **k))[1])
    sc, sct = _clustered(128)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=6)
    tparams = convert.trace_params_from_jax(params)
    d = _dirs(256, 21)
    ref = np.asarray(ar.trace_ir(
        sc, jnp.asarray(d), jnp.zeros(3), jnp.asarray(REC), 10.0, params,
        ar.TracerOptions(backend="pallas", pallas_version=2,
                         pallas_interpret=True, tri_chunk=128)))
    args = (sct, torch.from_numpy(d), np.zeros(3), REC, 10.0, tparams)
    got = t_tracer.trace_ir(*args).numpy()
    assert calls == {"k5": 6, "k2": 0}
    auto, cluster_size = tuned.auto_options(1280, 6)
    assert auto.schedule and cluster_size == 32
    got_s = t_tracer.trace_ir(*args, auto).numpy()
    assert calls == {"k5": 6, "k2": 6}
    np.testing.assert_array_equal(got, got_s)
    jt.assert_ir_close(got, ref, exact=False)
    assert got.sum() > 0


def test_traverse_wrapper_rejects_bad_inputs():
    sc, sct = _clustered(32)
    rows, boxes = rc.pack_scene(sct)
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR))
    state = rc.init_state(torch.from_numpy(_dirs(256, 0)), torch.zeros(3),
                          1.0, 256)
    scal = torch.zeros(16)
    before = tc.trace_traverse_launches
    with pytest.raises(ValueError, match="multiple of 128"):
        tc.trace_traverse(state[:, :200].contiguous(), rows, boxes, scal,
                          params)
    with pytest.raises(ValueError, match=r"boxes must be \[C, 8\]"):
        tc.trace_traverse(state, rows, boxes[:, :6].contiguous(), scal,
                          params)
    with pytest.raises(ValueError, match="multiple of 16"):
        tc.trace_traverse(state, rows[:-8].contiguous(), boxes, scal, params)
    with pytest.raises(ValueError, match="round budget"):
        tc.trace_traverse(state, rows, boxes, scal, params, 0)
    with pytest.raises(ValueError, match="visits must be int32"):
        tc.trace_traverse(state, rows, boxes, scal, params,
                          visits=torch.zeros(2))
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tc.trace_traverse(state, torch.zeros((16000 * 16, 24)),
                          torch.zeros((16000, 8)), scal, params)
    meta = [x.to("meta") for x in (state, rows, boxes, scal)]
    with pytest.raises(ValueError, match="no trace kernel for device"):
        tc.trace_traverse(*meta, params)
    tc.trace_traverse(state, rows, boxes, scal, params)
    assert tc.trace_traverse_launches == before  # no kernel on the CPU


# ------------------------------------------------------------------ (f)

def test_renderer_with_explicit_opts_clusters_at_128_and_matches_jax():
    """Explicit kernel options on a scene of 512 triangles and up: both
    renderers Morton-sort it into clusters of 128 and traverse them in the
    kernel; the same directions through both renderers' scenes and options
    give the same IR (statistical bar: other rounding over six bounces). A
    small scene stays unclustered, and the autograd backend never
    clusters."""
    from audiorenderingv2_tpu.renderer import AudioRenderer as JRenderer
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer

    v, t = jt.icosphere(radius=6.0, subdivisions=3)
    kw = dict(base_power=3.62, max_bounces=6, hrtf_absorption_rate=0.9)
    rj = JRenderer(jt.scene_from_arrays(v, t, 0.3), 1, 8000, 512,
                   opts=ar.TracerOptions(backend="pallas", pallas_version=2,
                                         pallas_interpret=True,
                                         tri_chunk=128), **kw)
    rt = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), 1, 8000, 512,
                       opts=t_tracer.TracerOptions(), device="cpu", **kw)
    assert rt.boxes is not None and rt.boxes.shape == (10, 8)
    np.testing.assert_array_equal(np.asarray(rj.sc.cluster_boxes),
                                  rt.sc.cluster_boxes.numpy())
    np.testing.assert_array_equal(np.asarray(rj.sc.plane_d),
                                  rt.sc.plane_d.numpy())
    rt.set_receiver(REC, 15.0)
    calls = []
    real = tc.trace_traverse_plain
    try:
        tc.trace_traverse_plain = lambda *a, **k: (calls.append(1),
                                                   real(*a, **k))[1]
        ir = rt.render()
    finally:
        tc.trace_traverse_plain = real
    assert len(calls) == 6 and ir.sum() > 0
    d = _dirs(512, 5)
    ref = np.asarray(ar.trace_ir(rj.sc, jnp.asarray(d), jnp.zeros(3),
                                 jnp.asarray(REC), 15.0, rj.params, rj.opts))
    got = t_tracer.trace_ir(rt.sc, torch.from_numpy(d), np.zeros(3), REC,
                            15.0, rt.params, rt.opts, rows=rt.rows,
                            boxes=rt.boxes).numpy()
    jt.assert_ir_close(got, ref, exact=False)

    bv, bt = tt.box_room((9.0, 6.0, 7.0))
    small = AudioRenderer(tt.scene_from_arrays(bv, bt, 0.3), 1, 8000, 256,
                          opts=t_tracer.TracerOptions(), device="cpu", **kw)
    assert small.boxes is None and small.sc.cluster_boxes is None
    auto = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), 1, 8000, 256,
                         opts=t_tracer.TracerOptions(backend="autograd"),
                         device="cpu", **kw)
    assert auto.sc.cluster_boxes is None


# ------------------------------------------------------------------ (g)
# The kernel's two passes, modelled in plain PyTorch: pass 1 tests the
# superbox of each group of 32 clusters before the group's children, pass 2
# sorts the reached clusters once and visits them in that order.


def two_level_entries(state: torch.Tensor, boxes: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """Pass 1 as the kernel runs it: a lane's entry into a child counts only
    when some alive lane of its warp (32 rays) reaches the child's
    superbox; a tile's entry is the least over its lanes, inf when none
    counts."""
    s = state.reshape(state.shape[0], -1, 128)
    k, c = s.shape[1], boxes.shape[0]
    live = alive.view(k, 1, 128)
    entry, child = sc_cuda.slab_pass(s, boxes)
    sup = sc_cuda.slab_pass(s, superboxes(boxes))[1] & live
    warp_sup = sup.view(k, -1, 4, 32).any(dim=3)            # [k, G, 4]
    group = torch.arange(c) // 32
    reach = warp_sup[:, group, :].repeat_interleave(32, dim=2)
    ok = child & live & reach
    return torch.where(ok, entry, float("inf")).amin(dim=2)


def sorted_visit_model(state: torch.Tensor, rows: torch.Tensor,
                       boxes: torch.Tensor, alive: torch.Tensor):
    """Pass 2 as the kernel runs it: per tile one stable sort of the
    clusters by entry (ties to the lowest id), visited in that order while
    some alive ray has the cluster's entry below its best hit. Returns (the
    clusters each tile visits, in order; best t [N]; best row [N])."""
    n = state.shape[1]
    n_tiles, c = n // 128, boxes.shape[0]
    cs = rows.shape[0] // c
    entry = two_level_entries(state, boxes, alive)
    order_e, order_id = torch.sort(entry, dim=1, stable=True)
    rows_c = rows.view(c, cs, rows.shape[1])
    ray = [state[col].view(n_tiles, 128)
           for col in range(rc._C_PX, rc._C_VZ + 1)]
    alive_t = alive.view(n_tiles, 128)
    best_t = torch.full((n_tiles, 128), float("inf"))
    best_i = torch.zeros((n_tiles, 128), dtype=torch.int64)
    going = torch.ones(n_tiles, dtype=torch.bool)
    seqs = [[] for _ in range(n_tiles)]
    for k in range(c):
        tn = order_e[:, k]
        going &= (alive_t & (tn[:, None] < best_t)).any(dim=1)
        act = torch.nonzero(going).squeeze(1)
        if act.numel() == 0:
            break
        cl = order_id[act, k]
        t, i = tc._nearest_hit_tiles([x[act] for x in ray], rows_c[cl])
        better = alive_t[act] & (t < best_t[act])
        best_t[act] = torch.where(better, t, best_t[act])
        best_i[act] = torch.where(better, i + (cl * cs)[:, None], best_i[act])
        for a, cid in zip(act.tolist(), cl.tolist()):
            seqs[a].append(cid)
    return seqs, best_t.view(n), best_i.view(n)


def traverse_with_sequence(state, rows, boxes, alive, monkeypatch):
    """``_traverse`` (the plain version) with the clusters each tile
    visits, in order, read off the entries it marks visited."""
    log = []

    class Marked(torch.Tensor):
        def __setitem__(self, idx, value):
            log.append(tuple(x.clone() for x in idx))
            super().__setitem__(idx, value)

    real = tc._tile_entries
    monkeypatch.setattr(tc, "_tile_entries",
                        lambda *a: real(*a).as_subclass(Marked))
    visits = torch.zeros(state.shape[1] // 128, dtype=torch.int32)
    best_t, best_i = tc._traverse(state, rows, boxes, alive, visits)
    seqs = [[] for _ in range(state.shape[1] // 128)]
    for act, ca in log:
        for a, cid in zip(act.tolist(), ca.tolist()):
            seqs[a].append(cid)
    return seqs, visits, torch.as_tensor(best_t), torch.as_tensor(best_i)


def _assert_same_traversal(state, rows, boxes, alive, monkeypatch):
    want_seq, visits, want_t, want_i = traverse_with_sequence(
        state, rows, boxes, alive, monkeypatch)
    seqs, best_t, best_i = sorted_visit_model(state, rows, boxes, alive)
    assert seqs == want_seq
    assert [len(s) for s in seqs] == visits.tolist()
    assert torch.equal(best_t[alive], want_t[alive])
    assert torch.equal(best_i[alive], want_i[alive])
    return seqs


@pytest.mark.parametrize("cs", [32, 128])
def test_sorted_visit_order_matches_traverse_on_office(cs, monkeypatch):
    """The office after one bounce and the dir72 sort (16,384 rays)."""
    from audiorenderingv2_tpu_torch import accel

    state = office_after_one_bounce()
    if cs == 32:
        _, rows, boxes = office()
    else:
        sorted_scene, clusters = accel.prepare_scene(tt.office_scene(20000),
                                                     cluster_size=cs)
        rows, boxes = rc.pack_tris_clusters(t_tracer.scene_to_arrays(
            sorted_scene, 128, clusters=clusters, device="cpu"))
    alive = state[rc._C_DONE] == 0.0
    seqs = _assert_same_traversal(state, rows, boxes, alive, monkeypatch)
    n_visits = [len(s) for s in seqs]
    assert 0 < float(np.mean(n_visits)) < boxes.shape[0] / 4


def test_sorted_visit_order_with_ties_and_zero_entries(monkeypatch):
    """Clusters with the same box (equal entries, visited in id order) and
    rays starting inside boxes (entry +0 into every box around them)."""
    sc, sct = _clustered(32)
    rows, boxes = rc.pack_tris_clusters(sct)
    boxes = boxes.clone()
    boxes[1] = boxes[0]
    boxes[5] = boxes[4] = boxes[3]
    rng = np.random.default_rng(4)
    n = 512
    b = boxes.numpy()
    pick = b[rng.integers(0, 6, n)]
    p = (pick[:, 0:3] + rng.random((n, 3)) * (pick[:, 3:6] - pick[:, 0:3]))
    p[n // 2:] = rng.normal(size=(n // 2, 3)) * 2.0
    state = rays_state(p.astype(np.float32), _dirs(n, 6))
    alive = torch.ones(n, dtype=torch.bool)
    alive[::7] = False
    entry = two_level_entries(state, boxes, alive)
    assert bool((entry == 0.0).sum(dim=1).ge(2).any())  # +0 ties
    assert torch.equal(entry[:, 1], entry[:, 0])
    assert bool(torch.isfinite(entry[:, 0]).any())
    _assert_same_traversal(state, rows, boxes, alive, monkeypatch)


@pytest.mark.parametrize("which", ["office", "ico"])
@pytest.mark.parametrize("seed", [0, 1])
def test_two_level_entries_equal_all_pairs(which, seed):
    """Pass 1's entries equal the all-pairs entries of ``_tile_entries``:
    every alive ray that reaches a box reaches its superbox, with direction
    components 0, +-1e-20 and +-1e-21, origins on box faces and padding
    boxes among the clusters; dead lanes reach nothing."""
    boxes = (office()[0] if which == "office" else ico_boxes()).contiguous()
    assert int((boxes[:, 6] == 0).sum()) > 0
    p, v = seeded_rays(boxes, seed)
    assert set(np.float32(SPECIAL).tolist()) <= set(v.ravel().tolist())
    state = rays_state(p, v)
    alive = torch.from_numpy(np.random.default_rng(seed).random(
        state.shape[1]) < 0.8)
    alive[:64] = True
    want = tc._tile_entries(state, boxes, alive)
    got = two_level_entries(state, boxes, alive)
    assert torch.equal(got, want)
    s = state.reshape(16, -1, 128)
    child = sc_cuda.slab_pass(s, boxes)[1]
    sup = sc_cuda.slab_pass(s, superboxes(boxes))[1]
    missed = child & ~sup[:, torch.arange(boxes.shape[0]) // 32, :]
    assert not bool(missed.any())
    assert int(torch.isfinite(want).sum()) > 20
