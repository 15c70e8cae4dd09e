"""Timing and profiling helpers, and the program's own spans and counters.

The counterpart of ``audiorenderingv2_tpu/utils/profiling.py`` with the same
contracts on an explicit device. A CUDA call returns once its work is
queued, so every timed window here ends in a fence: ``device_fence``
synchronises the device and then reads a checksum of the result back to the
host, so a time can only come from work that ran and whose result is there
to be checked. ``timed_median`` times on CUDA events for a CUDA device (the
host clock for the CPU) and refuses a median under a physical floor.

Spans and counters are switched on by a running ``torch.profiler`` and by
nothing else (``trace`` starts one). While it records on the calling
thread, ``span(name)`` is a ``record_function`` range: a ``user_annotation``
event of the profiler's Chrome trace, on the clock of the card's kernels,
nested by time in the spans around it. ``count(name, fn)`` keeps the value
``fn`` computes (a 0-dim tensor on the device, or a host number) in the
collector ``collect()`` opened on the thread, which ``read`` brings to the
host, the integer values in one copy and the floating-point ones in
another; ``count_each`` keeps each value of a 1-dim tensor. With no
profiler running a span is one shared object that does nothing and a
counter never calls ``fn``, so nothing is launched.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time

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


@contextlib.contextmanager
def trace(log_dir: str, device: torch.device | str = "cuda"):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's when ``device`` is CUDA), written as a Chrome trace into
    ``log_dir``; yields the profiler, whose ``key_averages()`` sums times
    by kernel. While it records, the program's spans (``ar2.*``) are on:
    the trace holds them beside the operators and kernels they enclose, and
    ``full_render_cycle`` records carry the render's counters."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))



# ------------------------------------------------------- spans and counters

_profiling = torch.autograd._profiler_enabled  # per thread, ~0.1 us a call


class _Off:
    """The span and the collector of a thread no profiler records: entering
    and leaving them does nothing, and the collector reads nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def read(self) -> dict:
        return {}


_OFF = _Off()


def span(name: str):
    """A named range of the program, as a context manager. While a
    ``torch.profiler`` records on this thread it is
    ``torch.profiler.record_function(name)``; otherwise the shared no-op,
    and nothing else is called."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


_local = threading.local()


class Counters:
    """The values counted on one thread while it is open (``with``), by
    name: a list of the values of ``count(name, fn)`` in the order they were
    counted, or the one value of ``count(name, fn, once=True)``."""

    def __init__(self):
        self.values: dict = {}
        self._outer = None

    def __enter__(self) -> "Counters":
        self._outer = getattr(_local, "counters", None)
        _local.counters = self
        return self

    def __exit__(self, *exc) -> bool:
        _local.counters = self._outer
        return False

    def read(self) -> dict:
        """Every value as a Python number, name -> number or list of
        numbers: a float for a floating-point tensor, else an int; the
        integer tensors among them come to the host in one copy, the
        floating-point ones in another."""
        tensors = [v for vals in self.values.values()
                   for v in (vals if isinstance(vals, list) else [vals])
                   if isinstance(v, torch.Tensor)]

        def to_host(floating: bool, dtype):
            kept = [t.reshape(()).to(dtype) for t in tensors
                    if t.is_floating_point() == floating]
            return iter(torch.stack(kept).tolist() if kept else ())

        ints = to_host(False, torch.int64)
        floats = to_host(True, torch.float64)

        def value(v):
            if not isinstance(v, torch.Tensor):
                return int(v)
            return next(floats) if v.is_floating_point() else next(ints)

        return {name: ([value(v) for v in vals] if isinstance(vals, list)
                       else value(vals))
                for name, vals in self.values.items()}


def collect():
    """A collector of this thread's counters, as a context manager that
    yields it: a fresh :class:`Counters` while a ``torch.profiler`` records,
    otherwise the shared no-op, whose ``read`` gives ``{}``."""
    if not _profiling():
        return _OFF
    return Counters()


def counting() -> bool:
    """Whether ``count`` keeps values on this thread now: a profiler
    records and a collector is open. Code that must set a counter's tensor
    up before the work it counts asks this first, and sets nothing up when
    it is False."""
    return getattr(_local, "counters", None) is not None and _profiling()


def count(name: str, fn, *, once: bool = False) -> None:
    """Keep ``fn()`` (a 0-dim integer tensor on the device, or a host
    number) under ``name`` in the collector open on this thread, appended
    to the name's list, or with ``once`` as its one value. With no profiler
    recording or no collector open it does nothing and ``fn`` is not
    called."""
    if not counting():
        return
    if once:
        _local.counters.values[name] = fn()
    else:
        _local.counters.values.setdefault(name, []).append(fn())


def count_each(name: str, fn) -> None:
    """Keep each value of ``fn()``, a 1-dim tensor on the device, appended
    to ``name``'s list in order, as ``count`` keeps one. Where ``count``
    does nothing this does nothing and ``fn`` is not called."""
    if not counting():
        return
    _local.counters.values.setdefault(name, []).extend(fn().unbind(0))
