"""The port's streaming runtime: the cases of tests/test_streaming.py carried
over to ``audiorenderingv2_tpu_torch.streaming``, and the port against the
JAX package's module on the same seeded inputs (ring buffer, re-render
policy, trajectory, live convolution, auralizer)."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import streaming as j_streaming
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.renderer import AudioRenderer as JRenderer
from audiorenderingv2_tpu_torch import native, streaming
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import sampling as t_sampling
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
from audiorenderingv2_tpu_torch.streaming import (AsyncRenderWorker,
                                                  Auralizer,
                                                  ListenerTrajectory,
                                                  LiveConvolver,
                                                  ReRenderPolicy, RingBuffer,
                                                  TrajectoryPoint)

torch.set_num_threads(1)

SR = 8000
WAIT = 60.0  # seconds any wait on a worker may take before the test fails


def _renderer(n_rays=256, max_bounces=4, absorption=0.3):
    v, t = tt.box_room((10.0, 8.0, 9.0))
    return AudioRenderer(tt.scene_from_arrays(v, t, absorption),
                         ir_seconds=1, sample_rate=SR, n_rays=n_rays,
                         base_power=3.62, max_bounces=max_bounces,
                         device="cpu")


def _rel_l2(got, ref):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(ref))
                 / np.linalg.norm(np.asarray(ref)))


# ------------------------------------------- tests/test_streaming.py's cases

def test_ring_add_does_not_advance():
    rb = RingBuffer(8)
    rb.add(np.ones(4))
    rb.add(np.ones(4) * 2)  # stacks on the same region
    out = rb.get_and_reset(4)
    np.testing.assert_allclose(out, 3.0)
    # region was zeroed and head advanced
    np.testing.assert_allclose(rb.get_and_reset(4), 0.0)


def test_ring_overlap_accumulation():
    """The live convolution tail pattern: add ir-length output, drain a
    block, next add overlaps the remaining tail."""
    rb = RingBuffer(12)
    rb.add(np.arange(8, dtype=float))        # [0..7]
    out1 = rb.get_and_reset(4)               # drains 0..3, head=4
    np.testing.assert_allclose(out1, [0, 1, 2, 3])
    rb.add(np.ones(8))                       # stacks on 4..11
    out2 = rb.get_and_reset(4)               # (4..7 leftovers) + 1
    np.testing.assert_allclose(out2, [5, 6, 7, 8])


def test_ring_wraparound():
    rb = RingBuffer(6)
    rb.get_and_reset(4)  # advance head to 4
    rb.add(np.array([1.0, 2.0, 3.0, 4.0]))  # wraps: idx 4,5,0,1
    out = rb.get_and_reset(4)
    np.testing.assert_allclose(out, [1, 2, 3, 4])


def test_policy_triggers():
    p = ReRenderPolicy(distance_threshold=2.0, angle_threshold=5.0,
                       settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)  # first call renders
    assert not p.should_render(0.1, np.array([1.0, 0, 0]), 1.0)  # small
    assert p.should_render(0.2, np.array([3.0, 0, 0]), 1.0)      # > 2 m
    assert not p.should_render(0.3, np.array([3.1, 0, 0]), 1.0)
    assert p.should_render(0.4, np.array([3.1, 0, 0]), 8.0)      # > 5 deg
    # settle timer: small motion then 1 s of stillness
    assert not p.should_render(0.5, np.array([3.2, 0, 0]), 8.0)
    assert p.should_render(1.6, np.array([3.2, 0, 0]), 8.0)


def test_trajectory_interpolation():
    traj = ListenerTrajectory([
        TrajectoryPoint(0.0, np.array([0.0, 0, 0]), 0.0),
        TrajectoryPoint(2.0, np.array([4.0, 0, 0]), 90.0),
    ])
    pos, yaw = traj.at(1.0)
    np.testing.assert_allclose(pos, [2.0, 0, 0])
    assert yaw == 45.0
    pos, yaw = traj.at(5.0)
    np.testing.assert_allclose(pos, [4.0, 0, 0])


def test_settle_fires_after_motion_stops_not_after_it_starts():
    """Slow continuous drift must NOT trigger the settle re-render until the
    listener actually stops (main.cpp:470-498 semantics)."""
    p = ReRenderPolicy(distance_threshold=5.0, angle_threshold=90.0,
                       settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)
    t, x = 0.0, 0.0
    for _ in range(15):  # drift 0.1 m every 0.2 s for 3 s
        t += 0.2
        x += 0.1
        assert not p.should_render(t, np.array([x, 0, 0]), 0.0), \
            f"fired at t={t}"
    # stop moving: settle fires ~1 s later, not before
    assert not p.should_render(t + 0.5, np.array([x, 0, 0]), 0.0)
    assert p.should_render(t + 1.1, np.array([x, 0, 0]), 0.0)


def test_settle_does_not_fire_at_rendered_pose():
    p = ReRenderPolicy(settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)
    # jiggle then return exactly to the rendered pose: nothing to re-render
    assert not p.should_render(0.2, np.array([0.1, 0, 0]), 0.0)
    assert not p.should_render(0.4, np.zeros(3), 0.0)
    assert not p.should_render(2.0, np.zeros(3), 0.0)


def test_async_render_worker():
    """The detached-worker runtime: requests coalesce, latest output swaps
    in (main.cpp:40-67 semantics)."""
    r = _renderer()
    r.set_emitter_pos(np.zeros(3))
    samples = np.random.default_rng(0).normal(size=SR).astype(np.float32)
    w = AsyncRenderWorker(r, samples)
    try:
        assert w.latest is None
        w.request([2.0, 0.0, 1.0], 0.0)
        w.wait_idle(timeout=WAIT)
        first = w.latest
        assert first is not None and first.shape == (2, SR)
        w.request([1.0, 1.0, -1.0], 45.0)
        w.wait_idle(timeout=WAIT)
        assert w.renders == 2
        assert not np.array_equal(w.latest, first)
    finally:
        w.close()


def test_live_duplex_rerender_under_stream(tmp_path):
    """End-to-end live-duplex runtime: AsyncRenderWorker re-renders on a
    moving pose WHILE LiveConvolver + the native engine stream blocks
    (main.cpp:99-135, 470-498): no NaN in the stream, bounded underruns,
    and blocks processed while a render is in flight are pure silence."""
    r = _renderer(n_rays=512, max_bounces=6)
    r.set_receiver(np.array([2.0, 0.0, 1.0], np.float32), 0.0)
    r.render()  # initial IR so the stream has something to convolve

    worker = AsyncRenderWorker(r, samples=None)
    conv = LiveConvolver(r, volume=1.0, render_guard=worker)
    engine = None
    if native.available():
        engine = native.NativeAudioEngine(
            str(tmp_path / "sink.f64"), ring_capacity=1 << 20,
            sample_rate=SR, channels=2, frames_per_buffer=256,
            realtime=False)
    block = 1024
    mic = np.random.default_rng(3).normal(size=block * 24).astype(
        np.float32) * 0.1
    poses = [([2.0, 0.0, 1.0], 0.0), ([-2.0, 0.5, -1.0], 45.0),
             ([0.0, 1.0, 2.0], 120.0)]
    silent, outputs = 0, []
    try:
        for i in range(24):
            if i % 8 == 1:  # listener moved: kick a background re-render
                worker.request(*poses[(i // 8) % len(poses)])
            out = conv.process_block(mic[i * block:(i + 1) * block])
            assert out.shape == (2 * block,)
            assert np.isfinite(out).all()
            if conv.silenced_blocks > silent:
                silent = conv.silenced_blocks
                assert not out.any()  # the guard means SILENCE
            outputs.append(out)
            if engine is not None:
                engine.add(out)
                engine.drain_ticks(block // 256)
        worker.wait_idle(timeout=WAIT)
        assert worker.renders >= 1  # re-renders happened mid-stream
        inter = np.concatenate(outputs)
        assert np.isfinite(inter).all() and (inter != 0).any()
        if engine is not None:
            # every all-zero tick is explained by a guard-silenced block
            assert engine.underruns <= conv.silenced_blocks * (block // 256)
            assert engine.frames_streamed > 0
    finally:
        worker.close()
        if engine is not None:
            engine.close()


def test_auralizer_async_mode():
    r = _renderer()
    r.set_emitter_pos(np.zeros(3))
    traj = ListenerTrajectory([
        TrajectoryPoint(0.0, np.array([2.0, 0.0, 1.0], np.float32), 0.0),
        TrajectoryPoint(1.0, np.array([-2.0, 0.0, -1.0], np.float32), 90.0),
    ])
    samples = np.random.default_rng(1).normal(size=SR).astype(
        np.float32) * 0.1
    aur = Auralizer(r, traj, ReRenderPolicy(2.0, 5.0, 1.0),
                    chunk_seconds=0.25, async_render=True)
    out = aur.run(samples)
    assert out.shape == (2, SR)
    assert np.isfinite(out).all() and (out != 0).any()
    assert aur.renders >= 2  # initial + at least one movement re-render


def test_policy_settle_fires_after_first_interval_move():
    """Motion in the FIRST inter-query interval arms the settle timer (the
    first query seeds query-to-query tracking)."""
    p = ReRenderPolicy(distance_threshold=2.0, angle_threshold=5.0,
                       settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)  # initial render
    # a 1 m (sub-threshold) move right after, then stillness
    assert not p.should_render(0.5, np.array([1.0, 0.0, 0.0]), 0.0)
    assert not p.should_render(1.0, np.array([1.0, 0.0, 0.0]), 0.0)
    assert p.should_render(1.6, np.array([1.0, 0.0, 0.0]), 0.0)


def test_async_worker_surfaces_render_failure():
    """A render-thread exception reaches the caller through wait_idle
    instead of being swallowed."""
    class Boom:
        lock = threading.RLock()

        def full_render_cycle(self, pos, yaw, samples):
            raise RuntimeError("kaboom")

    w = AsyncRenderWorker(Boom(), samples=np.zeros(8, np.float32))
    try:
        w.request(np.zeros(3), 0.0)
        with pytest.raises(RuntimeError, match="render worker failed"):
            w.wait_idle(timeout=10.0)
    finally:
        w.close()
    assert not w._thread.is_alive()


# ------------------------------------------------ the port against JAX's

def test_ring_buffer_equals_jax_bit_for_bit():
    """A seeded sequence of adds and drains of every length up to the
    capacity, wrapping many times: the same drained values and the same
    buffer, bit for bit (both sum float64 in index order)."""
    rng = np.random.default_rng(11)
    a, b = j_streaming.RingBuffer(101), RingBuffer(101)
    for _ in range(300):
        vals = rng.normal(size=int(rng.integers(1, 102)))
        a.add(vals)
        b.add(vals)
        n = int(rng.integers(1, 102))
        np.testing.assert_array_equal(b.get_and_reset(n), a.get_and_reset(n))
        assert a.head == b.head
    np.testing.assert_array_equal(b.data, a.data)
    for rb in (a, b):
        with pytest.raises(ValueError, match="capacity"):
            rb.add(np.zeros(102))


def _seeded_points(module, seed=5, n=12):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.1, 0.6, n))
    positions = np.cumsum(rng.normal(scale=1.2, size=(n, 3)), axis=0)
    yaws = np.cumsum(rng.normal(scale=8.0, size=n))
    return module.ListenerTrajectory.from_arrays(times, positions, yaws)


def test_policy_and_trajectory_equal_jax():
    """A seeded random walk sampled every 50 ms: the port's trajectory
    gives the JAX one's poses exactly and its policy fires at the same
    times (thresholds 2 m, 5 degrees, a 1 s settle)."""
    j_traj, t_traj = _seeded_points(j_streaming), _seeded_points(streaming)
    j_pol = j_streaming.ReRenderPolicy(2.0, 5.0, 1.0)
    t_pol = ReRenderPolicy(2.0, 5.0, 1.0)
    fired = []
    for t in np.arange(0.0, t_traj.duration + 2.0, 0.05):
        jp, jy = j_traj.at(t)
        tp, ty = t_traj.at(t)
        np.testing.assert_array_equal(tp, jp)
        assert ty == jy
        f = t_pol.should_render(t, tp, ty)
        assert f == j_pol.should_render(t, jp, jy), t
        fired.append(f)
    assert 3 < sum(fired) < len(fired) // 2


def _live_pair(n_bands):
    """A JAX renderer and the port's on the same box, both holding the same
    seeded IR ([2, SR], or [2, 4, SR] banded): the IR set where render()
    leaves it, so both convolve one array."""
    rng = np.random.default_rng(n_bands)
    shape = (2, SR) if n_bands == 1 else (2, n_bands, SR)
    ir = (rng.random(shape) ** 6 * 1e-2).astype(np.float32)
    v, t = jt.box_room((10.0, 8.0, 9.0))
    absorb = 0.3 if n_bands == 1 else np.full((12, n_bands), 0.3, np.float32)
    j_r = JRenderer(jt.scene_from_arrays(v, t, absorb), ir_seconds=1,
                    sample_rate=SR, n_rays=128,
                    opts=ar.TracerOptions(block_size=128, tri_chunk=128))
    j_r._ir = ir
    t_r = AudioRenderer(tt.scene_from_arrays(v, t, absorb), ir_seconds=1,
                        sample_rate=SR, n_rays=128, device="cpu")
    t_r._ir, t_r._ir_dev = ir, torch.from_numpy(ir)
    return j_r, t_r


@pytest.mark.parametrize("n_bands", [1, 4])
def test_live_convolver_equals_jax(n_bands):
    """Ten 512-frame blocks through ``LiveConvolver.process_block`` of both
    packages on the same IR (stereo, or 4 bands through the filterbank),
    the ring's tails accumulating: every block within 1e-5 relative L2
    (two float32 FFT libraries on the same data)."""
    j_r, t_r = _live_pair(n_bands)
    j_c = j_streaming.LiveConvolver(j_r, volume=0.7)
    t_c = LiveConvolver(t_r, volume=0.7)
    mic = np.random.default_rng(2).uniform(-0.5, 0.5, 512 * 10).astype(
        np.float32)
    for i in range(10):
        blk = mic[i * 512:(i + 1) * 512]
        ref, got = j_c.process_block(blk), t_c.process_block(blk)
        assert got.shape == ref.shape == (1024,) and got.dtype == np.float64
        assert _rel_l2(got, ref) <= 1e-5, i
    with pytest.raises(ValueError, match="longer than the IR"):
        t_r.convolve_live_input(np.zeros(SR + 1, np.float32), t_c.ring)
    with pytest.raises(RuntimeError, match="render"):
        _renderer().convolve_live_input(np.zeros(8, np.float32), t_c.ring)


def test_auralizer_equals_jax(monkeypatch):
    """The synchronous Auralizer of both packages along the same
    trajectory, every render of both from the same 2048 seeded directions
    (``sample_directions`` patched in both, as tests/test_torch_context.py
    does): the same renders at the same times and an output within 1e-2
    relative L2 (the bar of the context test)."""
    d = np.random.default_rng(9).normal(size=(2048, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    monkeypatch.setattr(j_sampling, "sample_directions",
                        lambda key, n, **kw: jnp.asarray(d))
    monkeypatch.setattr(t_sampling, "sample_directions",
                        lambda n, generator, device: torch.tensor(d))
    v, t = jt.box_room((10.0, 8.0, 9.0))
    kw = dict(ir_seconds=1, sample_rate=SR, n_rays=2048, base_power=3.62,
              max_bounces=12, hrtf_absorption_rate=0.9)
    j_r = JRenderer(jt.scene_from_arrays(v, t, 0.3),
                    opts=ar.TracerOptions(block_size=2048, tri_chunk=128),
                    **kw)
    t_r = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), device="cpu", **kw)
    points = [(0.0, [2.0, 0.0, 1.0], 0.0), (1.0, [-1.0, 0.5, 2.5], 60.0),
              (2.0, [-2.5, 0.0, -1.0], 150.0)]
    samples = np.random.default_rng(4).uniform(-0.5, 0.5, 3 * SR).astype(
        np.float32)
    outs, renders = [], []
    for module, r in ((j_streaming, j_r), (streaming, t_r)):
        traj = module.ListenerTrajectory.from_arrays(*zip(*points))
        aur = module.Auralizer(r, traj, module.ReRenderPolicy(2.0, 5.0, 1.0),
                               chunk_seconds=0.25, volume=0.8)
        outs.append(aur.run(samples))
        renders.append(aur.renders)
    assert renders[0] == renders[1] >= 3
    assert outs[1].shape == outs[0].shape == (2, 3 * SR)
    assert _rel_l2(outs[1], outs[0]) < 1e-2
