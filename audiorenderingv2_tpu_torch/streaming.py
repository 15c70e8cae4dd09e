"""Streaming / auralization runtime.

The counterpart of ``audiorenderingv2_tpu/streaming.py``, whose host logic
it keeps; the renders and convolutions it drives run on the renderer's
device.

Covers the reference's interactive layers without a GL window or sound card:

* :class:`RingBuffer` — accumulate/drain ring buffer with the exact semantics
  of the reference's CircularBuffer.h: ``add`` sums in place WITHOUT advancing
  (so overlapping convolution tails from consecutive live blocks stack), and
  ``get_and_reset`` reads n values, zeroes them, and advances. This is the
  pure-numpy implementation; ``native.NativeRingBuffer`` is the semantically
  identical C++ version for native streaming pipelines.

* :class:`ListenerTrajectory` + :class:`Auralizer` — scripted listener
  movement replacing the GLFW walkthrough: the re-render policy (move beyond
  the distance threshold, turn beyond the angle threshold, or a 1 s settle
  timer after motion) reproduces main.cpp:470-498.

* :class:`LiveConvolver` — the full-duplex mic path of audioHandlerWithMic
  (main.cpp:99-135): per-block convolve against the current IR, drain the
  ring buffer, NaN-guard, volume gain.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .utils.logging import get_logger


class RingBuffer:
    """Accumulating ring buffer (CircularBuffer.h:13-36 semantics)."""

    def __init__(self, capacity: int, dtype=np.float64):
        self.data = np.zeros(capacity, dtype)
        self.capacity = int(capacity)
        self.head = 0

    def add(self, values: np.ndarray) -> None:
        """Sum ``values`` into the buffer starting at the head, wrapping;
        does NOT advance the head."""
        values = np.asarray(values, self.data.dtype)
        n = values.shape[0]
        if n > self.capacity:
            raise ValueError("more values than capacity")
        first = min(n, self.capacity - self.head)
        self.data[self.head : self.head + first] += values[:first]
        if n > first:
            self.data[: n - first] += values[first:]

    def get_and_reset(self, n: int) -> np.ndarray:
        """Read n values from the head, zero them, advance the head."""
        if n > self.capacity:
            raise ValueError("more values than capacity")
        first = min(n, self.capacity - self.head)
        out = np.empty(n, self.data.dtype)
        out[:first] = self.data[self.head : self.head + first]
        self.data[self.head : self.head + first] = 0
        if n > first:
            rest = n - first
            out[first:] = self.data[:rest]
            self.data[:rest] = 0
        self.head = (self.head + n) % self.capacity
        return out


@dataclass
class TrajectoryPoint:
    """Listener pose at a time instant."""

    time: float
    position: np.ndarray
    yaw_deg: float


class ListenerTrajectory:
    """A scripted listener path: piecewise-linear position and yaw."""

    def __init__(self, points: list[TrajectoryPoint]):
        if not points:
            raise ValueError("empty trajectory")
        self.points = sorted(points, key=lambda p: p.time)

    @classmethod
    def from_arrays(cls, times, positions, yaws_deg):
        return cls([
            TrajectoryPoint(float(t), np.asarray(p, np.float32), float(y))
            for t, p, y in zip(times, positions, yaws_deg)
        ])

    def at(self, t: float) -> tuple[np.ndarray, float]:
        pts = self.points
        if t <= pts[0].time:
            return pts[0].position, pts[0].yaw_deg
        if t >= pts[-1].time:
            return pts[-1].position, pts[-1].yaw_deg
        for a, b in zip(pts[:-1], pts[1:]):
            if a.time <= t <= b.time:
                w = (t - a.time) / max(b.time - a.time, 1e-9)
                pos = (1 - w) * a.position + w * b.position
                # shortest-arc yaw interpolation
                dy = ((b.yaw_deg - a.yaw_deg + 180.0) % 360.0) - 180.0
                return pos.astype(np.float32), a.yaw_deg + w * dy
        return pts[-1].position, pts[-1].yaw_deg

    @property
    def duration(self) -> float:
        return self.points[-1].time


class ReRenderPolicy:
    """The reference's movement-triggered re-render policy (main.cpp:470-498):
    re-render when the listener moved more than ``distance_threshold`` or
    turned more than ``angle_threshold`` since the last render, or
    ``settle_seconds`` after motion STOPS while the pose still differs from
    the last render (the 1 s settle re-render)."""

    def __init__(self, distance_threshold: float = 2.0,
                 angle_threshold: float = 5.0, settle_seconds: float = 1.0):
        self.distance_threshold = float(distance_threshold)
        self.angle_threshold = float(angle_threshold)
        self.settle_seconds = float(settle_seconds)
        self._last_pos: np.ndarray | None = None  # pose at last render
        self._last_yaw = 0.0
        self._query_pos: np.ndarray | None = None  # pose at previous query
        self._query_yaw = 0.0
        self._moved_at: float | None = None  # time of last observed motion

    def should_render(self, t: float, pos: np.ndarray, yaw_deg: float) -> bool:
        pos = np.asarray(pos, np.float32)
        if self._last_pos is None:
            self._note(t, pos, yaw_deg)
            # Seed query-to-query motion tracking too: otherwise motion in
            # the first inter-query interval is unobserved and the settle
            # re-render can never fire after a small (sub-threshold) move.
            self._query_pos = pos.copy()
            self._query_yaw = float(yaw_deg)
            return True
        # Track when motion was last OBSERVED (query-to-query), so the
        # settle timer measures time since motion stopped, not since it
        # started — matching the reference's lastMovement timestamping.
        if self._query_pos is not None:
            step = float(np.linalg.norm(pos - self._query_pos))
            turn = abs(((yaw_deg - self._query_yaw + 180.0) % 360.0) - 180.0)
            if step > 1e-6 or turn > 1e-6:
                self._moved_at = t
        self._query_pos = pos.copy()
        self._query_yaw = float(yaw_deg)

        moved = float(np.linalg.norm(pos - self._last_pos))
        turned = abs(((yaw_deg - self._last_yaw + 180.0) % 360.0) - 180.0)
        if moved > self.distance_threshold or turned > self.angle_threshold:
            self._note(t, pos, yaw_deg)
            return True
        pose_stale = moved > 1e-6 or turned > 1e-6
        if (pose_stale and self._moved_at is not None
                and t - self._moved_at >= self.settle_seconds):
            self._note(t, pos, yaw_deg)
            return True
        return False

    def _note(self, t, pos, yaw_deg):
        self._last_pos = np.asarray(pos, np.float32).copy()
        self._last_yaw = float(yaw_deg)
        self._moved_at = None


class Auralizer:
    """Offline real-time-equivalent auralization along a trajectory.

    Walks the trajectory in ``chunk_seconds`` steps; whenever the re-render
    policy fires, renders a fresh IR at the current pose and re-convolves.
    Each output chunk comes from the most recent convolution, reproducing
    what the reference's audio callback plays while the render worker swaps
    buffers (main.cpp:69-95, 470-498).
    """

    def __init__(self, renderer, trajectory: ListenerTrajectory,
                 policy: ReRenderPolicy | None = None,
                 chunk_seconds: float = 0.25, volume: float = 1.0,
                 async_render: bool = False):
        self.renderer = renderer
        self.trajectory = trajectory
        self.policy = policy or ReRenderPolicy()
        self.chunk_seconds = float(chunk_seconds)
        self.volume = float(volume)
        # async_render reproduces the reference's detached-worker runtime:
        # audio chunks keep streaming the previous convolution while the
        # worker renders the new pose in the background (main.cpp:496).
        # Note: in an UNPACED offline run the chunk loop races ahead of the
        # worker, so intermediate poses coalesce (the reference behaves the
        # same when renders are slower than motion); use the synchronous
        # mode for deterministic offline exports.
        self.async_render = bool(async_render)
        self.renders = 0

    def run(self, samples: np.ndarray) -> np.ndarray:
        """Auralize ``samples`` (mono float [L]) along the trajectory.

        Returns stereo float32 [2, L].
        """
        sr = self.renderer.params.sample_rate
        length = samples.shape[0]
        out = np.zeros((2, length), np.float32)
        chunk = max(1, int(round(self.chunk_seconds * sr)))
        # Stage the dry signal on the renderer's device ONCE: every
        # re-convolution then skips the host->device copy of the whole
        # signal.
        samples = torch.as_tensor(samples, dtype=torch.float32,
                                  device=self.renderer.device)
        worker = (AsyncRenderWorker(self.renderer, samples)
                  if self.async_render else None)
        current: np.ndarray | None = None
        try:
            for start in range(0, length, chunk):
                t = start / sr
                pos, yaw = self.trajectory.at(t)
                fire = self.policy.should_render(t, pos, yaw)
                if worker is not None:
                    if fire or current is None:
                        worker.request(pos, yaw)
                    if current is None:
                        # Block only for the first IR; no timeout: the
                        # first cycle may build the kernels.
                        worker.wait_idle(timeout=None)
                    latest = worker.latest
                    if latest is not None:
                        current = latest
                elif fire or current is None:
                    current = self.renderer.full_render_cycle(pos, yaw, samples)
                    self.renders += 1
                stop = min(start + chunk, length)
                out[:, start:stop] = current[:, start:stop]
        finally:
            if worker is not None:
                worker.wait_idle(timeout=None)
                self.renders += worker.renders
                worker.close()
        return out * self.volume


class AsyncRenderWorker:
    """Background re-render worker — the reference's detached render thread.

    The reference spawns a detached ``full_render`` thread when the listener
    moves, while the audio callback keeps streaming the previous buffers
    guarded by an is_rendering flag (main.cpp:40-67, 496-497; Context
    is_rendering). This worker reproduces that runtime: ``request(pos, yaw)``
    queues the newest pose (coalescing older requests, like the reference's
    single worker), a daemon thread renders+convolves, and readers take the
    most recent completed output via ``latest`` under the renderer lock.

    ``samples=None`` is the live-mic mode: the worker only re-renders the IR
    (the audio callback convolves each block itself, main.cpp:99-135), so
    ``latest`` stays None and consumers read the renderer's current IR.

    The thread renders on the renderer's CUDA device (a new thread's current
    device is device 0) and on PyTorch's default stream, as the main thread
    does, so the IR it leaves on the device is ordered before the
    convolutions that read it.
    """

    def __init__(self, renderer, samples):
        self.renderer = renderer
        self.samples = samples
        self._pending: tuple | None = None
        self._cv = threading.Condition()
        self._latest: np.ndarray | None = None
        self._renders = 0
        self._stop = False
        self._is_rendering = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def is_rendering(self) -> bool:
        """The reference's is_rendering flag (Context.cpp:499-507)."""
        return self._is_rendering

    @property
    def renders(self) -> int:
        return self._renders

    @property
    def latest(self) -> np.ndarray | None:
        """Most recent completed stereo output [2, L] (None before the
        first render finishes)."""
        with self._cv:
            return self._latest

    def request(self, pos, yaw_deg: float) -> None:
        """Queue a re-render at this pose; newer requests supersede queued
        ones (only the latest pose matters, as in the reference)."""
        with self._cv:
            self._pending = (np.asarray(pos, np.float32).copy(), float(yaw_deg))
            self._cv.notify()

    def wait_idle(self, timeout: float = 60.0) -> None:
        """Block until no render is queued or in flight (for tests/offline).

        Re-raises a render-thread failure instead of letting callers see
        only its downstream symptoms (a stale IR / a None ``latest``).
        ``timeout=None`` waits indefinitely: the right choice when the
        wait covers the first render, which builds the kernels."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while (self._pending is not None or self._is_rendering):
                if self._error is not None:
                    raise RuntimeError("render worker failed") from self._error
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError("render worker still busy")
                self._cv.wait(0.1)
            if self._error is not None:
                raise RuntimeError("render worker failed") from self._error

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stop:
                    self._cv.wait(0.1)
                if self._stop:
                    return
                pos, yaw = self._pending
                self._pending = None
                self._is_rendering = True
            try:
                if self._error is not None:
                    return  # a previous cycle failed; stop consuming work
                with _device_of(self.renderer):
                    if self.samples is None:  # live mode: render only
                        t0 = time.perf_counter()
                        with self.renderer.lock:
                            self.renderer.set_receiver(pos, yaw)
                            self.renderer.render()
                        get_logger().event(
                            "live_rerender",
                            render_ms=round((time.perf_counter() - t0) * 1e3,
                                            3),
                            receiver=[float(x) for x in pos],
                            yaw_deg=float(yaw))
                        out = None
                    else:
                        out = self.renderer.full_render_cycle(pos, yaw,
                                                              self.samples)
                with self._cv:
                    if out is not None:
                        self._latest = out
                    self._renders += 1
            except BaseException as e:  # surfaced via wait_idle/latest
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._is_rendering = False
                    self._cv.notify_all()


def _device_of(renderer):
    """``torch.cuda.device`` of a renderer on a CUDA device, else a no-op
    context (a CPU renderer, or a stand-in without a device)."""
    device = getattr(renderer, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class LiveConvolver:
    """Block-wise live convolution with ring-buffer overlap accumulation
    (audioHandlerWithMic, main.cpp:99-135).

    ``render_guard``: anything with an ``is_rendering`` attribute (e.g. an
    :class:`AsyncRenderWorker`). While a render is in flight the block is
    answered with silence and the input is NOT convolved — the reference's
    audio callback does exactly this so the half-written IR is never heard
    (main.cpp:111, 128-132; Context is_rendering)."""

    def __init__(self, renderer, volume: float = 1.0, render_guard=None):
        self.renderer = renderer
        self.volume = float(volume)
        self.render_guard = render_guard
        self.silenced_blocks = 0
        n = renderer.params.ir_length
        self.ring = RingBuffer(2 * n + 1, dtype=np.float64)

    def process_block(self, in_block: np.ndarray) -> np.ndarray:
        """One callback block [n_frames] -> interleaved stereo [2*n_frames].

        NaN outputs are zeroed like the reference's guard (main.cpp:118-124).
        """
        n_frames = in_block.shape[0]
        if self.render_guard is not None and self.render_guard.is_rendering:
            self.silenced_blocks += 1
            return np.zeros(2 * n_frames, np.float64)
        self.renderer.convolve_live_input(in_block, self.ring)
        out = self.ring.get_and_reset(2 * n_frames) * self.volume
        return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
