"""The port's clustered route against the JAX package: Morton clusters, the
cluster packing, the dir72 coherence keys, the per-tile schedule, K2's
plain version and the clustered ``trace_ir``, on the same scene arrays and
the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import accel as j_accel
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.ops import raytrace_pallas as rp
from audiorenderingv2_tpu.ops import raytrace_pallas_v2 as rp2
from audiorenderingv2_tpu_torch import accel as t_accel
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc_cuda

torch.set_num_threads(1)

SR = 16000
REC = np.array([1.5, 0.5, -1.0], np.float32)
EMITTER = np.array([0.5, -0.2, 0.1], np.float32)
SCHED = rc.Route("sched", "sort")  # the schedule and K2, then the sort


def _np(sc):
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


def _ico_scene(absorption=0.2):
    v, t = jt.icosphere(radius=6.0, subdivisions=3)  # 1280 triangles
    return jt.scene_from_arrays(v, t, absorption)


def _clustered(scene, cs=32):
    """The JAX package's clustered scene arrays and the port's copy."""
    sorted_scene, clusters = j_accel.prepare_scene(scene, cluster_size=cs)
    sc = ar.scene_to_arrays(sorted_scene, 128, clusters=clusters)
    return sc, convert.scene_arrays_from_jax(_np(sc), device="cpu")


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _spread_state(n, seed, ncols=16):
    """A mid-render ray state [n, ncols]: positions inside the sphere,
    unit directions (a few exactly on axis ties), a quarter of rays done."""
    rng = np.random.default_rng(seed)
    st = np.zeros((n, ncols), np.float32)
    st[:, rp._C_PX:rp._C_PZ + 1] = rng.uniform(-4, 4, size=(n, 3))
    st[:, rp._C_VX:rp._C_VZ + 1] = _dirs(n, seed + 1)
    st[:8, rp._C_VX:rp._C_VZ + 1] = np.float32(np.sqrt(0.5)) * np.array(
        [1, -1, 0], np.float32)
    st[8:12, rp._C_VX:rp._C_VZ + 1] = [0.0, 0.0, -1.0]
    st[:, rp._C_DONE] = rng.random(n) < 0.25
    st[:, rp._C_EN] = 1e-6
    return st


# ------------------------------------------------------------ (a), (b)

@pytest.mark.parametrize("cs", [32, 64, 128])
def test_prepare_scene_matches(cs):
    """Sorted scene and cluster boxes bit-equal to the JAX package's."""
    scene = _ico_scene()
    sj, cj = j_accel.prepare_scene(scene, cluster_size=cs)
    st, ct = t_accel.prepare_scene(
        tt.scene_from_arrays(*tt.icosphere(radius=6.0, subdivisions=3), 0.2),
        cluster_size=cs)
    for f in ("v0", "v1", "v2", "normal", "plane_n", "plane_d", "bary_u",
              "bary_v", "absorption", "valid", "tri_material"):
        np.testing.assert_array_equal(getattr(sj, f), getattr(st, f), f)
    assert ct.cluster_size == cj.cluster_size == cs
    for f in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z"):
        np.testing.assert_array_equal(getattr(cj, f), getattr(ct, f), f)
    with pytest.raises(ValueError, match="does not divide"):
        t_accel.prepare_scene(st, cluster_size=48)


@pytest.mark.parametrize("cs", [32, 128])
def test_scene_to_arrays_cluster_boxes_match(cs):
    """Boxes equal JAX's, padding clusters flagged 0 and zeroed: the office
    at ~1,000 triangles pads 972 to 1,024."""
    scene = tt.office_scene(1000)
    sorted_scene, clusters = t_accel.prepare_scene(scene, cluster_size=cs)
    bj = np.asarray(ar.scene_to_arrays(sorted_scene, 128,
                                       clusters=clusters).cluster_boxes)
    bt = t_tracer.scene_to_arrays(sorted_scene, 128, clusters=clusters,
                                  device="cpu").cluster_boxes
    np.testing.assert_array_equal(bj, bt.numpy())
    assert bt.shape == (1024 // cs, 8)
    empty = bt[:, 6] == 0
    assert int(empty.sum()) == (1 if cs == 32 else 0)  # clusters past 972
    assert torch.all(bt[empty] == 0)


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("n_bands", [1, 3])
def test_pack_tris_clusters_matches(n_bands):
    """Rows and boxes equal pack_tris_v2's cluster branch, trim included."""
    v, t = tt.office_mesh(1000)
    absorb = np.linspace(0.1, 0.6, t.shape[0] * n_bands).astype(
        np.float32).reshape(t.shape[0], n_bands)
    scene = jt.scene_from_arrays(v, t, absorb if n_bands > 1 else 0.3)
    sc, sct = _clustered(scene)
    rows_j, attrs, boxes_j = rp2.pack_tris_v2(sc, n_bands)
    rows_t, boxes_t = rc.pack_tris_clusters(sct, n_bands)
    assert attrs is None
    np.testing.assert_array_equal(np.asarray(rows_j), rows_t.numpy())
    np.testing.assert_array_equal(np.asarray(boxes_j), boxes_t.numpy())
    assert boxes_t.shape[0] == 31 < sct.cluster_boxes.shape[0]  # trimmed
    assert rc.pack_scene(sct, n_bands)[1] is not None


def test_pack_tris_clusters_rejects_bad_cluster_sizes():
    _, sct = _clustered(_ico_scene())
    for n_boxes in (48, 160):  # 1280 / 48 is no integer; 1280 / 160 = 8
        bad = sct._replace(cluster_boxes=torch.zeros(n_boxes, 8))
        with pytest.raises(ValueError, match="multiple of 16"):
            rc.pack_tris_clusters(bad)


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("seed", [0, 1])
def test_compaction_keys_and_sort_match(seed):
    """dir72 keys at cell_bits=5 equal JAX's integer for integer, and the
    stable sort by them gives the same ray order."""
    st = _spread_state(1000, seed)
    kj = np.asarray(rp._compaction_keys(jnp.asarray(st), True, cell_bits=5,
                                        key_layout="dir72"))
    stt = torch.from_numpy(st.T.copy())
    kt = rc._compaction_keys(stt)
    assert kt.dtype == torch.int32
    np.testing.assert_array_equal(kj, kt.numpy())
    assert len(np.unique(kj)) > 100
    ref = np.asarray(rp._sort_state_by_keys(jnp.asarray(st), jnp.asarray(kj)))
    np.testing.assert_array_equal(rc._sort_state_by_keys(stt, kt).numpy(),
                                  ref.T)
    with pytest.raises(ValueError, match="overflows int32"):
        rc._compaction_keys(stt, cell_bits=8)


def _posed_spread_state(p, n, seed):
    """A state [16, p * n] of ``p`` poses whose positions spread over boxes
    of different sizes, with done rays."""
    st = torch.from_numpy(_spread_state(p * n, seed).T.copy())
    for i in range(p):
        st[rc._C_PX:rc._C_PZ + 1, i * n:(i + 1) * n] *= 0.5 ** i
    return st


@pytest.mark.parametrize("cell_bits", [3, 5, 7])
@pytest.mark.parametrize("n_poses", [1, 4])
def test_compaction_keys_wrapper_equals_plain_on_cpu(n_poses, cell_bits):
    """The key kernel's wrapper runs the plain version for a CPU tensor:
    the same int32 keys, pose by pose."""
    st = _posed_spread_state(n_poses, 256, 7)
    got = rc.compaction_keys(st, cell_bits, n_poses)
    want = rc._compaction_keys(st, cell_bits, n_poses)
    assert got.dtype == torch.int32 and got.shape == (n_poses * 256,)
    assert torch.equal(got, want)
    assert len(torch.unique(got)) > 50


@pytest.mark.parametrize("bad", ["cell_bits_8", "n_poses", "float64",
                                 "strided"])
def test_compaction_keys_wrapper_rejects(bad):
    st = _posed_spread_state(1, 256, 8)
    kwargs = {}
    if bad == "cell_bits_8":
        kwargs, match = {"cell_bits": 8}, "overflows int32"
    elif bad == "n_poses":
        kwargs, match = {"n_poses": 3}, "do not divide"
    elif bad == "float64":
        st, match = st.double(), "float32"
    else:
        st, match = torch.cat([st, st], dim=1)[:, ::2], "strided"
    assert bad == "cell_bits_8" or st.shape[1] == 256
    with pytest.raises(ValueError, match=match):
        rc.compaction_keys(st, **kwargs)


def test_key_kernel_is_declared_and_launched():
    """The C entry is defined in its source, declared in _build's
    signatures, and launched by the wrapper."""
    import inspect

    from audiorenderingv2_tpu_torch.ops import _build

    cu = (_build.CSRC / "compaction_keys.cu").read_text()
    assert 'extern "C" int ar2_compaction_keys(' in cu
    assert len(_build._SIGNATURES["ar2_compaction_keys"]) == 9
    assert ".ar2_compaction_keys(" in inspect.getsource(rc.compaction_keys)


@pytest.mark.parametrize("n_poses", [1, 2])
def test_run_rounds_reorders_through_the_key_wrapper(monkeypatch, n_poses):
    """Every reorder of the clustered route goes through the wrapper (with
    the pose count), and the plain keys only through it."""
    _, sct = _clustered(_ico_scene())
    rows, boxes = rc.pack_scene(sct)
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, max_bounces=4))
    wrapped, plain = [], []
    wrapper, plain_keys = rc.compaction_keys, rc._compaction_keys

    def counting_wrapper(state, cell_bits=rc.CELL_BITS, n_poses=1):
        wrapped.append(n_poses)
        return wrapper(state, cell_bits, n_poses)

    def counting_plain(state, cell_bits=rc.CELL_BITS, n_poses=1):
        plain.append(n_poses)
        return plain_keys(state, cell_bits, n_poses)

    monkeypatch.setattr(rc, "compaction_keys", counting_wrapper)
    monkeypatch.setattr(rc, "_compaction_keys", counting_plain)
    d = torch.from_numpy(_dirs(n_poses * 128, 0)).view(n_poses, 128, 3)
    rec = torch.from_numpy(REC)
    if n_poses == 1:
        rc.trace_events(rows, d[0], torch.zeros(3), rec, 0.0, params,
                        boxes=boxes, route=SCHED)
    else:
        rc.trace_events_pose_batch(
            rows, d, torch.zeros(n_poses, 3), rec.expand(n_poses, 3),
            torch.zeros(n_poses), params, boxes=boxes, route=SCHED)
    assert wrapped == plain == [n_poses] * 3


# ------------------------------------------------------------------ (e)

@pytest.mark.parametrize("which", ["start", "spread"])
def test_tile_schedule_plain_matches(which):
    """Row for row equal to rp2.tile_schedule(mode="exact") in the slots
    K2 reads (count, then ids); the port's other slots are zeros."""
    sc, _ = _clustered(_ico_scene(0.25))
    n = 512
    if which == "start":
        st = np.asarray(rp.init_state(jnp.asarray(_dirs(n, 5)),
                                      jnp.asarray(EMITTER), 1e-6, n))
        st = st.copy()
        st[: n // 4, rp._C_DONE] = 1.0
        st[n - 128:, rp._C_DONE] = 1.0  # an all-done tile lists nothing
    else:  # each tile's rays near one point, in a narrow cone of directions
        st = _spread_state(n, 3)
        rng = np.random.default_rng(4)
        tile = np.arange(n) // 128
        st[:, rp._C_PX:rp._C_PZ + 1] = (
            rng.uniform(-3, 3, size=(4, 3))[tile]
            + rng.uniform(-0.3, 0.3, size=(n, 3))).astype(np.float32)
        d = rng.normal(size=(4, 3))[tile] + 0.1 * rng.normal(size=(n, 3))
        st[12:, rp._C_VX:rp._C_VZ + 1] = (d / np.linalg.norm(
            d, axis=1, keepdims=True)).astype(np.float32)[12:]
    ref = np.asarray(rp2.tile_schedule(rp2.to_tiles(jnp.asarray(st)),
                                       sc.cluster_boxes, mode="exact"))
    got = sc_cuda.tile_schedule(torch.from_numpy(st.T.copy()),
                                torch.tensor(np.asarray(
                                    sc.cluster_boxes))).numpy()
    assert got.shape == ref.shape == (4, sc_cuda.schedule_width(40))
    for i in range(got.shape[0]):
        count = ref[i, 0]
        np.testing.assert_array_equal(got[i, :1 + count], ref[i, :1 + count])
        assert not got[i, 1 + count:].any()
    if which == "start":
        assert ref[3, 0] == got[3, 0] == 0 < ref[1, 0]
    else:
        assert (ref[:, 0] > 0).all() and (ref[:, 0] < 40).all()


# ------------------------------------------------------------------ (f)

@pytest.mark.parametrize("n_bands", [1, 3])
def test_trace_round_sched_plain_matches_pallas_kernel(n_bands):
    """K2's plain version against trace_round_v2(sched=...) in interpret
    mode at budget 1, from the start state and from the state after one
    bounce; every column within 1e-5 (the interpret-mode bar of one bounce,
    tests/test_torch_trace.py)."""
    v, t = jt.icosphere(radius=6.0, subdivisions=3)
    absorb = np.linspace(0.1, 0.5, t.shape[0] * n_bands).astype(
        np.float32).reshape(t.shape[0], n_bands)
    scene = jt.scene_from_arrays(v, t, absorb if n_bands > 1 else 0.2)
    sc, sct = _clustered(scene)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=20, n_bands=n_bands)
    n = 512
    e0 = params.base_power / (n * 4.0 / 3.0 * np.pi)
    ncols = rp2.state_ncols(n_bands)
    state = rp.init_state(jnp.asarray(_dirs(n, 9)), jnp.asarray(EMITTER), e0,
                          n, ncols=ncols,
                          en_cols=tuple(rp2._band_cols(n_bands)[0]))
    scal = rp._scalars(jnp.asarray(EMITTER), jnp.asarray(REC),
                       jnp.deg2rad(jnp.float32(25.0)), e0, params)
    rows_j, _, boxes_j = rp2.pack_tris_v2(sc, n_bands)
    rows_t, boxes_t = rc.pack_tris_clusters(sct, n_bands)
    tparams = convert.trace_params_from_jax(params)
    tscal = torch.tensor(np.asarray(scal)[0])
    for step in range(2):
        tiles = rp2.to_tiles(state)
        sched_j = rp2.tile_schedule(tiles, boxes_j)
        ref = rp2.trace_round_v2(tiles, rows_j, None, boxes_j, scal, params,
                                 1, interpret=True, sched=sched_j)
        ref = rp2.from_tiles(ref)
        st = torch.tensor(np.asarray(state).T.copy())
        sched_t = sc_cuda.tile_schedule(st, boxes_t)
        got = sc_cuda.trace_round_sched(st, rows_t, boxes_t, sched_t, tscal,
                                        tparams)
        r = np.asarray(ref).T
        assert got.shape == r.shape == (ncols, n)
        for c in range(ncols):  # every column, LTRI and RECVD included
            np.testing.assert_allclose(got[c].numpy(), r[c], rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=f"step {step}, column {c}")
        assert (r[rc._C_LTRI] > 0).any()
        state = ref
    assert (r[rc._C_EVW] > 0).any() and (r[rc._C_DONE] == 0).any()


# ------------------------------------------------------------- (g), (h)

def test_clustered_trace_ir_matches_jax():
    """The clustered trace_ir against JAX's schedule-mode Pallas path
    (interpret, dir72, cell_bits 5) on the same sorted scene, and against
    the XLA tracer on the unsorted scene."""
    scene = _ico_scene()
    sc, sct = _clustered(scene)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=6)
    d = _dirs(256, 21)
    args = (jnp.asarray(d), jnp.zeros(3), jnp.asarray(REC), 10.0, params)
    pallas = np.asarray(ar.trace_ir(sc, *args, ar.TracerOptions(
        backend="pallas", pallas_version=2, pallas_interpret=True,
        tri_chunk=128, pallas_schedule=True, pallas_key_layout="dir72",
        pallas_cell_bits=5)))
    xla = np.asarray(ar.trace_ir(ar.scene_to_arrays(scene, 128), *args,
                                 ar.TracerOptions(block_size=256,
                                                  tri_chunk=128)))
    got = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), REC, 10.0,
                            convert.trace_params_from_jax(params)).numpy()
    assert got.sum() > 0
    np.testing.assert_allclose(got, pallas, rtol=1e-3, atol=5e-7)
    np.testing.assert_allclose(got, xla, rtol=1e-3, atol=5e-7)


def test_clustered_route_takes_only_single_bounce_rounds():
    _, sct = _clustered(_ico_scene())
    rows, boxes = rc.pack_scene(sct)
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, max_bounces=4))
    args = (rows, torch.from_numpy(_dirs(128, 0)), torch.zeros(3),
            torch.from_numpy(REC), 0.0, params)
    with pytest.raises(ValueError, match="one bounce per round"):
        rc.trace_events(*args, boxes=boxes, round_budgets=(2, 2),
                        route=SCHED)
    with pytest.raises(ValueError, match="one bounce per round"):
        rc.trace_events(*args, boxes=boxes, route=SCHED._replace(
            reorder=None))
    with pytest.raises(ValueError, match="packed boxes"):
        t_tracer.trace_ir(sct, args[1], np.zeros(3), REC, 0.0, params,
                          rows=rows)


# ------------------------------------------------------------------ (i)

@pytest.mark.parametrize("scene_name,clustered", [("ico", True),
                                                  ("box", False)])
def test_renderer_picks_route_by_triangle_count(monkeypatch, scene_name,
                                                clustered):
    """1,280 triangles take the clustered route (schedule + K2 every round,
    no K1), the 12-triangle box the rows route (K1, no schedule)."""
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer

    calls = {"trace_round": 0, "trace_round_sched": 0, "tile_schedule": 0}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counting(rc, "trace_round")
    counting(sc_cuda, "trace_round_sched")
    counting(sc_cuda, "tile_schedule")
    v, t = (tt.icosphere(radius=6.0, subdivisions=3) if scene_name == "ico"
            else tt.box_room((9.0, 6.0, 7.0)))
    r = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), 1, 8000, 1024,
                      max_bounces=6, base_power=3.62, device="cpu")
    r.set_receiver(REC, 0.0)
    ir = r.render()
    assert ir.sum() > 0
    if clustered:
        assert r.sc.cluster_boxes.shape == (40, 8) and r.boxes is not None
        assert calls == {"trace_round": 0, "trace_round_sched": 6,
                         "tile_schedule": 6}
    else:
        assert r.sc.cluster_boxes is None and r.boxes is None
        assert calls["trace_round"] == 3 and calls["tile_schedule"] == 0


# --------------------------------------------------------- the wrappers

def test_schedule_wrappers_reject_bad_inputs():
    _, sct = _clustered(_ico_scene())
    rows, boxes = rc.pack_scene(sct)
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR))
    state = rc.init_state(torch.from_numpy(_dirs(256, 0)), torch.zeros(3),
                          1.0, 256)
    scal = torch.zeros(16)
    sched = sc_cuda.tile_schedule(state, boxes)
    assert sched.dtype == torch.int32 and sched.shape == (2, 48)
    with pytest.raises(ValueError, match="multiple of 128"):
        sc_cuda.tile_schedule(state[:, :200].contiguous(), boxes)
    with pytest.raises(ValueError, match=r"boxes must be \[C, 8\]"):
        sc_cuda.tile_schedule(state, boxes[:, :6].contiguous())
    with pytest.raises(ValueError, match="sched must be int32"):
        sc_cuda.trace_round_sched(state, rows, boxes, sched[:1].contiguous(),
                                  scal, params)
    with pytest.raises(ValueError, match="sched must be int32"):
        sc_cuda.trace_round_sched(state, rows, boxes, sched.long(), scal,
                                  params)
    with pytest.raises(ValueError, match="multiple of 16"):
        sc_cuda.trace_round_sched(state, rows[:-8].contiguous(), boxes,
                                  sched, scal, params)
    meta = [x.to("meta") for x in (state, rows, boxes, sched, scal)]
    with pytest.raises(ValueError, match="no schedule kernel for device"):
        sc_cuda.tile_schedule(meta[0], meta[2])
    with pytest.raises(ValueError, match="no trace kernel for device"):
        sc_cuda.trace_round_sched(*meta, params)


def test_cpu_clustered_call_launches_no_kernel():
    _, sct = _clustered(_ico_scene())
    params = convert.trace_params_from_jax(ar.TraceParams(
        sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=3))
    rc.launches = 0
    sc_cuda.tile_schedule_launches = sc_cuda.trace_round_sched_launches = 0
    ir = t_tracer.trace_ir(sct, torch.from_numpy(_dirs(512, 3)), np.zeros(3),
                           REC, 0.0, params)
    assert ir.device.type == "cpu" and float(ir.sum()) > 0
    assert rc.launches == sc_cuda.tile_schedule_launches == \
        sc_cuda.trace_round_sched_launches == 0


def test_office_export_takes_clustered_route(tmp_path, monkeypatch):
    """The slice as a user runs it on a scene past the threshold: an office
    .obj through config.json -> load_context -> export_audio on the CPU,
    one schedule and one K2 round per bounce, no K1 round; its IR against
    the JAX XLA tracer's on the same directions."""
    import json

    from audiorenderingv2_tpu_torch import context
    from audiorenderingv2_tpu_torch.core import sampling
    from audiorenderingv2_tpu_torch.io import wav as t_wav

    v, t = tt.office_mesh(700)  # 652 triangles
    tt.write_obj(tmp_path / "office.obj", v, t, material="walls")
    dry = np.random.default_rng(0).uniform(-0.5, 0.5, 8000).astype(np.float32)
    t_wav.write_wav(tmp_path / "dry.wav", dry[None, :], 8000)
    (tmp_path / "config.json").write_text(json.dumps({
        "renderer_parameters": {"ir_length_in_seconds": 1},
        "scene_parameters": {
            "mono": False, "audio_file_path": "dry.wav",
            "scene_file_path": "office.obj",
            "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0},
            "initial_receiver_pos": {"x": 6.0, "y": 1.0, "z": -8.0}},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": {"x": 16, "y": 16, "z": 16},
            "ray_max_bounces": 5, "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls", "mat_absorption": 0.3}]}}))
    before = (rc.launches, sc_cuda.tile_schedule_launches)
    calls = []
    real = sc_cuda.trace_round_sched_plain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(sc_cuda, "trace_round_sched_plain", counting)
    ctx = context.load_context(tmp_path / "config.json", device="cpu")
    out = context.export_audio(ctx, tmp_path / "office.wav")
    r = ctx.renderer
    assert r.boxes is not None and len(calls) == 5
    assert (rc.launches, sc_cuda.tile_schedule_launches) == before
    assert out.shape == (2, 8000) and np.allclose(np.abs(out).max(axis=1), 1)
    assert np.all((r.ir > 0).sum(axis=1) > 20)

    # The same directions through the JAX XLA tracer on the unsorted scene.
    g = torch.Generator().manual_seed(3)
    d = sampling.sample_directions(4096, g, "cpu")
    got = t_tracer.trace_ir(r.sc, d, r.emitter_pos, r.receiver_pos, 0.0,
                            r.params, r.opts, rows=r.rows, boxes=r.boxes)
    jp = ar.TraceParams(sample_rate=8000, ir_length=8000, base_power=3.62,
                        max_bounces=5, hrtf_absorption_rate=0.9)
    ref = ar.trace_ir(ar.scene_to_arrays(ctx.scene, 128),
                      jnp.asarray(d.numpy()), jnp.zeros(3),
                      jnp.asarray(r.receiver_pos), 0.0, jp,
                      ar.TracerOptions(block_size=4096, tri_chunk=128))
    jt.assert_ir_close(got.numpy(), np.asarray(ref), exact=False)


def test_build_dir_follows_shared_header(tmp_path, monkeypatch):
    """An edit to the header K1 and K2 share picks a new library directory,
    so no stale build is reused."""
    import shutil

    from audiorenderingv2_tpu_torch.ops import _build

    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert {p.name for p in _build.sources()} == {
        "band_split.cu", "compaction_keys.cu", "histogram.cu",
        "init_state.cu", "replay.cu", "tile_schedule.cu", "trace_group.cu",
        "trace_round.cu", "trace_sched.cu", "trace_traverse.cu"}
    before = _build.build_dir()
    header = tmp_path / "trace_common.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.build_dir() != before
