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
