"""The two-level test of the schedule kernel (csrc/tile_schedule.cu), held
on the CPU through the plain slab test (``schedule_cuda.slab_pass``): every
ray that reaches a cluster box reaches the union of its group of 32
(the superbox), and a schedule that tests a group's children only where a
warp of 32 rays reaches the superbox gives ``tile_schedule_plain``'s rows,
integer for integer."""
import functools

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from audiorenderingv2_tpu_torch import accel, constants
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

torch.set_num_threads(1)

GROUP = 32  # clusters per superbox, the kernel's kGroup
WARP = 32   # rays per warp
SPECIAL = (0.0, -0.0, 1e-21, -1e-21, 1e-20, -1e-20)


def superboxes(boxes: torch.Tensor) -> torch.Tensor:
    """[ceil(C / 32), 8]: per group of 32 consecutive boxes, the union of
    the flagged ones (lo min, hi max) with flag 1, or zeros and flag 0 when
    none is flagged, as the kernel builds them."""
    c = boxes.shape[0]
    g = -(-c // GROUP)
    pad = torch.zeros((g * GROUP - c, 8), dtype=boxes.dtype)
    b = torch.cat([boxes, pad]).view(g, GROUP, 8)
    valid = b[:, :, 6] > 0
    inf = torch.tensor(float("inf"))
    lo = torch.where(valid[..., None], b[:, :, 0:3], inf).amin(dim=1)
    hi = torch.where(valid[..., None], b[:, :, 3:6], -inf).amax(dim=1)
    out = torch.zeros((g, 8), dtype=boxes.dtype)
    any_valid = valid.any(dim=1)
    out[:, 0:3] = torch.where(any_valid[:, None], lo, 0.0)
    out[:, 3:6] = torch.where(any_valid[:, None], hi, 0.0)
    out[:, 6] = any_valid.to(boxes.dtype)
    return out


def two_level_schedule(state: torch.Tensor, boxes: torch.Tensor,
                       chunk: int = 16) -> torch.Tensor:
    """The kernel's rule in plain PyTorch: a warp's rays test a group's 32
    boxes only where one of them reaches the group's superbox; the rows'
    format is tile_schedule_plain's."""
    n_tiles = state.shape[1] // 128
    c = boxes.shape[0]
    sup = superboxes(boxes)
    group = torch.arange(c) // GROUP
    out = torch.zeros((n_tiles, sc.schedule_width(c)), dtype=torch.int32)
    ids = torch.arange(c)
    for t0 in range(0, n_tiles, chunk):
        k = min(chunk, n_tiles - t0)
        s = state[:, t0 * 128:(t0 + k) * 128].reshape(-1, k, 128)
        live = (s[rc._C_DONE] == 0.0)[:, None, :]
        warp_sup = (sc.slab_pass(s, sup)[1] & live).view(
            k, -1, 128 // WARP, WARP).any(dim=3)            # [k, G, 4]
        child = (sc.slab_pass(s, boxes)[1] & live).view(
            k, c, 128 // WARP, WARP).any(dim=3)             # [k, C, 4]
        reach = (child & warp_sup[:, group, :]).any(dim=2)  # [k, C]
        listed = torch.sort(torch.where(reach, ids, c), dim=1).values
        out[t0:t0 + k, 0] = reach.sum(dim=1).to(torch.int32)
        out[t0:t0 + k, 1:c + 1] = torch.where(listed < c, listed, 0).to(
            torch.int32)
    return out


@functools.cache
def office():
    """The office scene (19,852 triangles) prepared as the renderer does:
    (untrimmed boxes [624, 8] with 3 padding clusters, packed rows, packed
    boxes [621, 8])."""
    sorted_scene, clusters = accel.prepare_scene(tt.office_scene(20000),
                                                 cluster_size=32)
    arrays = tracer.scene_to_arrays(sorted_scene, 128, clusters=clusters,
                                    device="cpu")
    return (arrays.cluster_boxes, *rc.pack_tris_clusters(arrays))


@functools.cache
def ico_boxes():
    """The 1,280-triangle icosphere in clusters of 32 (40 boxes), with
    flag-0 zeroed boxes put in among them: a whole group of padding and
    four inside a group of real boxes."""
    scene = tt.scene_from_arrays(*tt.icosphere(radius=6.0, subdivisions=3),
                                 0.2)
    sorted_scene, clusters = accel.prepare_scene(scene, cluster_size=32)
    b = tracer.scene_to_arrays(sorted_scene, 128,
                               clusters=clusters, device="cpu").cluster_boxes
    b = torch.cat([b, torch.zeros((GROUP + 4, 8))])
    b[[3, 9, 17, 30]] = 0.0  # inside the first group
    return b


def rays_state(p: np.ndarray, v: np.ndarray) -> torch.Tensor:
    """A [16, n] state (n a multiple of 128) of origins ``p`` and
    directions ``v``, none done."""
    s = np.zeros((16, p.shape[0]), np.float32)
    s[rc._C_PX:rc._C_PZ + 1] = p.T
    s[rc._C_VX:rc._C_VZ + 1] = v.T
    return torch.from_numpy(s)


def face_origins(boxes: torch.Tensor, rng, n: int) -> np.ndarray:
    """``n`` points on faces of flagged boxes: inside the box on two axes,
    exactly on its lo or hi plane on the third."""
    b = boxes[boxes[:, 6] > 0].numpy()
    pick = b[rng.integers(0, b.shape[0], n)]
    lo, hi = pick[:, 0:3], pick[:, 3:6]
    p = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    side = np.where(rng.random((n, 1)) < 0.5, lo, hi)
    p[np.arange(n), axis] = side[np.arange(n), axis]
    return p


def assert_superbox_covers(state: torch.Tensor, boxes: torch.Tensor) -> int:
    """Every (ray, box) pair the slab test passes passes for the box's
    superbox too; returns the number of such pairs."""
    s = state.reshape(16, -1, 128)
    child = sc.slab_pass(s, boxes)[1]                    # [k, C, 128]
    sup = sc.slab_pass(s, superboxes(boxes))[1]          # [k, G, 128]
    group = torch.arange(boxes.shape[0]) // GROUP
    missed = child & ~sup[:, group, :]
    assert not bool(missed.any()), (
        f"{int(missed.sum())} ray-box hits whose superbox the ray misses")
    return int(child.sum())


def seeded_rays(boxes: torch.Tensor, seed: int, n: int = 1024):
    """Origins in and around the boxes' span and on their faces; unit
    directions with some components exactly 0, +-1e-21 and +-1e-20."""
    rng = np.random.default_rng(seed)
    b = boxes[boxes[:, 6] > 0]
    lo, hi = b[:, 0:3].amin(0).numpy(), b[:, 3:6].amax(0).numpy()
    span = hi - lo
    p = (lo - 0.1 * span + rng.random((n, 3)) * 1.2 * span).astype(
        np.float32)
    p[: n // 4] = face_origins(boxes, rng, n // 4)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = v.astype(np.float32)
    for axis in range(3):
        hit = rng.random(n) < 0.2
        v[hit, axis] = rng.choice(np.float32(SPECIAL), int(hit.sum()))
    v[:8] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [1e-20, 1e-21, -1],
             [0, 1e-20, -1e-20], [-1e-21, 0, 1], [0, 0, -1e-21], [0, 0, 0]]
    return p, v


@pytest.mark.parametrize("which", ["office", "ico"])
@pytest.mark.parametrize("seed", [0, 1])
def test_superbox_covers_every_reached_box_seeded(which, seed):
    boxes = office()[0] if which == "office" else ico_boxes()
    assert int((boxes[:, 6] == 0).sum()) > 0  # padding boxes among them
    p, v = seeded_rays(boxes, seed)
    hits = assert_superbox_covers(rays_state(p, v), boxes)
    assert hits > 1000


_coord = st.floats(-30.0, 30.0, width=32, allow_nan=False)
_comp = st.one_of(st.sampled_from(SPECIAL),
                  st.floats(-1.0, 1.0, width=32, allow_nan=False))


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(which=st.sampled_from(["office", "ico"]),
       origin=st.tuples(_coord, _coord, _coord),
       direction=st.tuples(_comp, _comp, _comp),
       on_face=st.integers(0, 2**31 - 1))
def test_superbox_covers_every_reached_box_hypothesis(which, origin,
                                                      direction, on_face):
    """One drawn ray, and 127 more around it: its origin moved onto the
    faces of flagged boxes, and its direction with single components
    replaced by the special values."""
    boxes = office()[0] if which == "office" else ico_boxes()
    rng = np.random.default_rng(on_face)
    p = np.repeat(np.float32([origin]), 128, axis=0)
    p[64:] = face_origins(boxes, rng, 64)
    v = np.repeat(np.float32([direction]), 128, axis=0)
    for i in range(1, 64):
        axis = i % 3
        v[i, axis] = SPECIAL[i % len(SPECIAL)]
    assert_superbox_covers(rays_state(p, v), boxes)


def test_superboxes_leave_padding_out():
    boxes = ico_boxes()
    sup = superboxes(boxes)
    assert sup.shape == (3, 8)
    assert torch.equal(sup[2], torch.zeros(8))  # a group of padding only
    real = boxes[:GROUP][boxes[:GROUP, 6] > 0]
    assert torch.equal(sup[0, 0:3], real[:, 0:3].amin(0))
    assert torch.equal(sup[0, 3:6], real[:, 3:6].amax(0))
    assert sup[0, 6] == 1.0 and sup[1, 6] == 1.0


@functools.cache
def office_after_one_bounce(n: int = 16384) -> torch.Tensor:
    """The office at ``n`` rays from the emitter at the origin after one
    clustered round (plain schedule, plain K2) and the dir72 sort."""
    _, rows, boxes = office()
    params = TraceParams(sample_rate=16000, ir_length=32000, base_power=3.62,
                         max_bounces=32, hrtf_absorption_rate=0.9)
    d = np.random.default_rng(3).normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    emitter = torch.zeros(3)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(torch.from_numpy(d), emitter, e0, n)
    scal = rc.scalars(emitter, torch.tensor([6.0, 1.0, -8.0]), 0.0, e0,
                      params)
    state = sc.trace_round_sched_plain(
        state, rows, boxes, sc.tile_schedule_plain(state, boxes), scal,
        params)
    return rc._sort_state_by_keys(state, rc._compaction_keys(state))


@pytest.mark.parametrize("which", ["after_bounce", "tiles_done"])
def test_two_level_schedule_equals_plain_rows(which):
    _, _, boxes = office()
    state = office_after_one_bounce().clone()
    if which == "tiles_done":
        state[rc._C_DONE, 10 * 128:40 * 128] = 1.0    # whole tiles done
        state[rc._C_DONE, 50 * 128 + 1:51 * 128] = 1.0  # all but one ray
        state[rc._C_DONE, -3 * 128:] = 1.0
    want = sc.tile_schedule_plain(state, boxes)
    got = two_level_schedule(state, boxes)
    assert torch.equal(got, want)
    counts = want[:, 0]
    assert int(counts.min()) >= 0 and 0 < float(counts.float().mean()) < 621
    if which == "tiles_done":
        assert not want[10:40].any() and not want[-3:].any()
        assert 0 < int(want[50, 0]) < int(counts.max())


# ------------------------------------------------- K2's per-warp cull

@functools.cache
def _ico_packed(n_bands: int):
    """The 1,280-triangle icosphere in clusters of 32, packed for
    ``n_bands`` bands of absorptions that differ by triangle and band:
    (rows, boxes [40, 8])."""
    v, t = tt.icosphere(radius=6.0, subdivisions=3)
    absorb = np.linspace(0.1, 0.5, t.shape[0] * n_bands).astype(
        np.float32).reshape(t.shape[0], n_bands)
    scene = tt.scene_from_arrays(v, t, absorb if n_bands > 1 else 0.2)
    sorted_scene, clusters = accel.prepare_scene(scene, cluster_size=32)
    return rc.pack_tris_clusters(tracer.scene_to_arrays(
        sorted_scene, 128, clusters=clusters, device="cpu"), n_bands)


@functools.cache
def _office_packed(n_bands: int):
    """The office in clusters of 32 packed for ``n_bands`` bands (its one
    absorption in every band): (rows, boxes [621, 8])."""
    if n_bands == 1:
        return office()[1:]
    sorted_scene, clusters = accel.prepare_scene(tt.office_scene(20000),
                                                 cluster_size=32)
    return rc.pack_tris_clusters(tracer.scene_to_arrays(
        sorted_scene, 128, clusters=clusters, device="cpu"), n_bands)


def _k2_start(n_poses: int, n: int, n_bands: int, emitters):
    """A start state of ``n_poses`` poses x ``n`` rays (pose-major) and its
    scalar rows: [16] for one pose, [P, 16] for several."""
    params = TraceParams(sample_rate=16000, ir_length=32000, base_power=3.62,
                         max_bounces=32, hrtf_absorption_rate=0.9,
                         n_bands=n_bands)
    d = np.random.default_rng(11 + n_poses).normal(size=(n_poses, n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=2, keepdims=True))
                         .astype(np.float32))
    em = torch.tensor(emitters[:n_poses], dtype=torch.float32)
    rec = em + torch.tensor([1.5, 0.5, -1.0])
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(d, em, e0, n, n_bands).reshape(
        rc.state_ncols(n_bands), -1)
    yaws = torch.linspace(0.0, 90.0, n_poses)
    scal = rc.scalars(em, rec, yaws, e0, params)
    if n_poses == 1:
        state, scal = state, scal[0].contiguous()
    return state, scal, params


def _tile_union(state, rows, boxes, sched, scal, params, rays_per_pose):
    """K2's plain version as it was before the per-warp cull, in place:
    every ray of a tile that is not done tests the rows of every cluster
    its tile lists, in ascending id order with a strict running minimum,
    then K1's receiver test and bounce tail."""
    en_cols, evw_cols = rc.band_cols(params.n_bands)
    state[rc._C_LTRI] = 0.0
    idx = torch.nonzero(state[rc._C_DONE] == 0.0).squeeze(1)
    s = state[:, idx]
    ray = s[rc._C_PX:rc._C_VZ + 1]
    c_all = boxes.shape[0]
    cs = rows.shape[0] // c_all
    member = sc._members(sched, c_all)
    best_t = torch.full((idx.numel(),), float("inf"))
    best_i = torch.zeros((idx.numel(),), dtype=torch.int64)
    for c in range(c_all):
        sel = torch.nonzero(member[idx // 128, c]).squeeze(1)
        t, i = rc._nearest_hit(*ray[:, sel], rows[c * cs:(c + 1) * cs])
        better = t < best_t[sel]
        best_t[sel] = torch.where(better, t, best_t[sel])
        best_i[sel] = torch.where(better, i + c * cs, best_i[sel])
    rc._bounce(s, rows, rc.pose_rows(scal, idx, rays_per_pose), en_cols,
               evw_cols, params.max_bounces, best=(best_t, best_i))
    state[:, idx] = s
    return state


@pytest.mark.parametrize("n_poses", [1, 4])
@pytest.mark.parametrize("n_bands", [1, 8])
@pytest.mark.parametrize("which", ["office", "ico"])
def test_warp_cull_equals_tile_union(which, n_bands, n_poses):
    """The warp-culled plain K2 gives every column, bit for bit, what the
    tile-union K2 gave, from the start state and after two bounces (each
    bounce a schedule, the culled K2 and the per-pose dir72 sort); and it
    culls: the warps test fewer (warp, candidate) pairs than four a
    candidate, so the comparison is not vacuous."""
    rows, boxes = (_office_packed if which == "office" else
                   _ico_packed)(n_bands)
    emitters = ([[0.0, 0.0, 0.0], [3.0, 1.0, -2.0], [-4.0, 2.0, 5.0],
                 [8.0, -1.0, 6.0]] if which == "office" else
                [[0.5, -0.2, 0.1], [2.0, 1.0, -1.0], [-1.5, 0.5, 2.0],
                 [0.0, -3.0, 0.0]])
    n = 1024 // n_poses
    state, scal, params = _k2_start(n_poses, n, n_bands, emitters)
    rpp = n if n_poses > 1 else None
    culled = visited = 0
    for step in range(3):
        if step in (0, 2):  # the start state, then after two bounces
            sched = sc.tile_schedule_plain(state, boxes)
            visits = torch.zeros(state.shape[1] // 128, dtype=torch.int32)
            got = sc.trace_round_sched_plain(state.clone(), rows, boxes,
                                             sched, scal, params, rpp,
                                             visits)
            want = _tile_union(state.clone(), rows, boxes, sched, scal,
                               params, rpp)
            for c in range(state.shape[0]):
                assert torch.equal(got[c], want[c]), (
                    f"{which}, step {step}, column {c}: "
                    f"{int((got[c] != want[c]).sum())} rays differ")
            assert (want[rc._C_LTRI] > 0).any()
            visited += int(visits.sum())
            culled += 4 * int(sched[:, 0].sum()) - int(visits.sum())
        sched = sc.tile_schedule_plain(state, boxes)
        state = sc.trace_round_sched_plain(state, rows, boxes, sched, scal,
                                           params, rpp)
        state = rc._sort_state_by_keys(
            state, rc._compaction_keys(state, n_poses=n_poses), n_poses)
    assert visited > 0 and culled > 0


def _walls(xs=(-5.0, 3.0, 5.0)):
    """Walls of 16 triangles each at the planes x in ``xs`` (4 x 4 m, a
    2 x 4 grid of quads), in clusters of 16 taken in the mesh's order:
    (rows, boxes [len(xs), 8]), one cluster a wall."""
    verts, tris = [], []
    for x in xs:
        base = len(verts)
        for j in range(3):
            for i in range(5):
                verts.append((x, -2.0 + 2.0 * j, -2.0 + i))
        for j in range(2):
            for i in range(4):
                a = base + j * 5 + i
                tris += [(a, a + 1, a + 5), (a + 1, a + 6, a + 5)]
    scene = tt.scene_from_arrays(np.array(verts, np.float32),
                                 np.array(tris, np.int32), 0.3)
    return rc.pack_tris_clusters(tracer.scene_to_arrays(
        scene, 128, clusters=accel.build_clusters(scene, 16), device="cpu"))


def test_warp_visits_hand_count():
    """One tile at the origin among three walls, at x = -5, +3 and +5 (in
    that cluster order): warp 0 faces +x but for one lane that faces -x,
    warp 1 faces +x, warp 2 faces -x, warp 3 is done. The schedule lists
    the three walls, so the tile union would test 4 x 3 pairs; the warps
    test 2 + 1 + 1 + 0 = 4: the wall at +5 is reached only past the hit at
    +3, and a warp facing one way reaches nothing behind it. Every live ray
    hits the nearest wall it faces."""
    rows, boxes = _walls()
    assert boxes.shape[0] == 3
    rng = np.random.default_rng(5)
    v = np.zeros((128, 3), np.float32)
    v[:, 1:] = rng.uniform(-0.1, 0.1, size=(128, 2))
    v[:, 0] = np.where(np.arange(128) < 64, 1.0, -1.0)
    v[7, 0] = -1.0
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    state = rays_state(np.zeros((128, 3), np.float32), v)
    state[rc._C_EN] = 1.0
    state[rc._C_DONE, 96:] = 1.0
    params = TraceParams(sample_rate=16000, ir_length=32000,
                         max_bounces=32)
    scal = rc.scalars(torch.zeros(3), torch.tensor([0.0, 50.0, 0.0]), 0.0,
                      1.0, params)
    sched = sc.tile_schedule(state, boxes)
    assert sched[0, 0] == 3
    visits = torch.zeros(1, dtype=torch.int32)
    out = sc.trace_round_sched(state.clone(), rows, boxes, sched, scal,
                               params, visits=visits)
    assert int(visits) == 4 < 4 * int(sched[0, 0])
    hit = out[rc._C_LTRI, :96].long() - 1        # the row each ray hit
    wall_x = boxes[hit // (rows.shape[0] // 3), 0]
    vx = state[rc._C_VX, :96]
    assert torch.equal(wall_x, torch.where(vx > 0, 3.0, -5.0))
    assert torch.allclose(out[rc._C_DIST, :96], wall_x / vx)
    assert torch.equal(out[:, 96:], state[:, 96:])


@pytest.mark.parametrize("which", ["office", "ico"])
def test_warp_visits_at_most_four_a_candidate(which):
    """Each tile's warps test at most four times its candidates, fewer
    over all tiles; a tile with no live ray tests none."""
    rows, boxes = (_office_packed if which == "office" else
                   _ico_packed)(1)
    state = (office_after_one_bounce(2048).clone() if which == "office"
             else _k2_start(1, 1024, 1, [[0.5, -0.2, 0.1]])[0])
    state[rc._C_DONE, 128:256] = 1.0  # a tile with no live ray
    params = TraceParams(sample_rate=16000, ir_length=32000, base_power=3.62,
                         max_bounces=32, hrtf_absorption_rate=0.9)
    scal = rc.scalars(torch.zeros(3), torch.tensor([6.0, 1.0, -8.0]), 0.0,
                      1e-6, params)
    sched = sc.tile_schedule_plain(state, boxes)
    visits = torch.zeros(state.shape[1] // 128, dtype=torch.int32)
    sc.trace_round_sched(state.clone(), rows, boxes, sched, scal, params,
                         visits=visits)
    counts = sched[:, 0]
    assert bool((visits <= 4 * counts).all())
    assert visits[1] == counts[1] == 0
    assert 0 < int(visits.sum()) < 4 * int(counts.sum())


@pytest.mark.parametrize("bad", ["int64", "length", "strided", "2d"])
def test_trace_round_sched_rejects_bad_visits(bad):
    rows, boxes = _ico_packed(1)
    state, scal, params = _k2_start(1, 256, 1, [[0.5, -0.2, 0.1]])
    sched = sc.tile_schedule(state, boxes)
    visits = {"int64": torch.zeros(2, dtype=torch.int64),
              "length": torch.zeros(3, dtype=torch.int32),
              "strided": torch.zeros(4, dtype=torch.int32)[::2],
              "2d": torch.zeros((1, 2), dtype=torch.int32)}[bad]
    match = "must be contiguous" if bad == "strided" else "visits must be"
    with pytest.raises(ValueError, match=match):
        sc.trace_round_sched(state, rows, boxes, sched, scal, params,
                             visits=visits)
