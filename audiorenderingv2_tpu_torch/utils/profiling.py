"""Timing and profiling helpers.

The counterpart of ``audiorenderingv2_tpu/utils/profiling.py`` with the same
contracts on an explicit device. A CUDA call returns once its work is
queued, so every timed window here ends in a fence: ``device_fence``
synchronises the device and then reads a checksum of the result back to the
host, so a time can only come from work that ran and whose result is there
to be checked. ``timed_median`` times on CUDA events for a CUDA device (the
host clock for the CPU) and refuses a median under a physical floor.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _first_leaf(out):
    """The first tensor or array inside ``out`` (nested tuples, lists and
    dicts in order)."""
    if isinstance(out, (torch.Tensor, np.ndarray)):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for item in out:
            leaf = _first_leaf(item)
            if leaf is not None:
                return leaf
        return None
    return np.asarray(out)


def device_fence(out, device: torch.device | str | None = None) -> float:
    """Completion fence for timed device work: wait for ``device`` (default:
    the device of the first tensor in ``out``), then bring that tensor's sum
    to the host and return it as a float."""
    leaf = _first_leaf(out)
    if leaf is None:
        raise ValueError("device_fence needs a tensor or an array to read")
    if device is None and isinstance(leaf, torch.Tensor):
        device = leaf.device
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    if isinstance(leaf, torch.Tensor):
        return float(leaf.double().sum().cpu())
    return float(np.asarray(leaf, np.float64).sum())


def timed_median(fn, *args, n: int = 5, min_ms: float = 0.0,
                 device: torch.device | str = "cuda"):
    """The timing contract of the benchmarks and tuning scripts.

    Returns ``(median_ms, first_s, checksum)``: the median of ``n`` timed
    calls after a first one whose wall time (kernel builds, allocator
    warm-up) is ``first_s``. On a CUDA ``device`` each call is timed between
    two CUDA events; on the CPU by the host clock. Every call ends in
    :func:`device_fence`, outside the events, and its checksum must be
    finite and positive, so a number can only come from a computation that
    ran. ``min_ms`` is a physical floor: a median under it raises. A caller
    that needs fresh inputs per call passes a callable of the iteration
    index and no ``args``."""
    device = torch.device(device)
    on_card = device.type == "cuda"

    def call(i):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
        t0 = time.perf_counter()
        out = fn(i) if not args else fn(*args)
        if on_card:
            end.record()
        s = device_fence(out, device)
        wall = time.perf_counter() - t0
        if not (math.isfinite(s) and s > 0):
            raise RuntimeError(f"bad checksum {s}")
        return (start.elapsed_time(end) / 1e3 if on_card else wall), wall, s

    _, first_s, checksum = call(0)
    times = [call(i)[0] for i in range(1, n + 1)]
    median_ms = float(np.median(times)) * 1000.0
    if median_ms < min_ms:
        raise RuntimeError(
            f"median {median_ms:.3f} ms below the physical floor {min_ms} "
            f"ms: the timed window does not cover the work")
    return median_ms, first_s, checksum


@dataclass
class Timer:
    """Accumulating named wall-clock timer; call in a with-block. ``sync``:
    a tensor (its device is waited for) or a device to wait for before the
    clock is read."""

    name: str
    times: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) \
                else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - t0)

    @property
    def last_ms(self) -> float:
        return self.times[-1] * 1000.0 if self.times else 0.0

    @property
    def median_ms(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2] * 1000.0


@contextlib.contextmanager
def trace(log_dir: str, device: torch.device | str = "cuda"):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's when ``device`` is CUDA), written as a Chrome trace into
    ``log_dir``; yields the profiler, whose ``key_averages()`` sums times
    by kernel."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / seconds if seconds > 0 else 0.0
