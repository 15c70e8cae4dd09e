"""Device trace of a steady span of the window, and its reduction.

``Tracer`` starts ``torch.profiler`` (CPU and CUDA activities, no shapes,
no stacks) once the window has run ``start_s`` seconds, marks each unit of
work with a ``perfbench.unit`` annotation, and stops after ``span_s``
seconds and at least ``min_units`` units. The trace is written as Chrome
JSON under ``perfbench/_runs/<cell>/`` and reduced by ``Summary``:

* the traced window: first unit's start to last unit's end (host clock of
  the trace);
* device busy time: the union of kernel, copy and fill intervals in it;
* time and count of kernels by name;
* idle gaps (no device activity) labelled with the innermost host event
  running at the gap's middle, summed by label.
"""
from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
UNIT = "perfbench.unit"


class Tracer:
    def __init__(self, out_path: Path, start_s: float, span_s: float,
                 min_units: int):
        self.out_path = Path(out_path)
        self.start_s = float(start_s)
        self.span_s = float(span_s)
        self.min_units = int(min_units)
        self.prof = None
        self.active = False
        self.first = self.last = None
        self._t0 = 0.0

    @property
    def units(self) -> range:
        if self.first is None:
            return range(0)
        return range(self.first, self.last)

    def warm(self) -> None:
        """Start and stop the profiler once on a small operation, so that
        its own start-up (CUPTI's, on a card) falls before the window."""
        import torch

        dev = "cuda" if torch.cuda.is_available() else "cpu"
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1024, device=dev).sum().item()

    @staticmethod
    def _activities() -> list:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def before(self, i: int, elapsed: float) -> None:
        """Called before unit ``i``, ``elapsed`` seconds into the window."""
        if self.first is None and elapsed >= self.start_s:
            self._start(i)
        elif (self.active and time.perf_counter() - self._t0 >= self.span_s
              and i - self.first >= self.min_units):
            self._stop(i)

    def finish(self, i: int) -> None:
        if self.first is None:  # a window too short to reach the start
            self._start(i)
        if self.active:
            self._stop(i)

    def _start(self, i: int) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self.first, self.active = i, True
        self._t0 = time.perf_counter()

    def _stop(self, i: int) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.last, self.active = i, False
        self.out_path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.out_path))
        self.prof = None

    def summary(self) -> "Summary":
        return Summary.from_file(self.out_path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Summary:
    """Reduction of one Chrome trace; times in seconds."""

    def __init__(self, events: list):
        ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
        units = [e for e in ev if e.get("name") == UNIT
                 and e.get("cat") == "user_annotation"]
        if units:
            self.t0 = min(e["ts"] for e in units)
            self.t1 = max(e["ts"] + e["dur"] for e in units)
        else:
            self.t0 = min((e["ts"] for e in ev), default=0.0)
            self.t1 = max((e["ts"] + e["dur"] for e in ev), default=0.0)
        self.n_units = len(units)
        self.device = [e for e in ev if e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.host = [e for e in ev if e.get("cat") in HOST_CATS]

    @classmethod
    def from_file(cls, path) -> "Summary":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self):
        return _merge((max(e["ts"], self.t0),
                       min(e["ts"] + e["dur"], self.t1))
                      for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def kernels(self, match=None) -> list:
        return [e for e in self.device if e.get("cat") == "kernel"
                and (match is None or match(e["name"]))]

    def kernel_s(self, match) -> float:
        return sum(e["dur"] for e in self.kernels(match)) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        tot = defaultdict(float)
        for e in self.device:
            tot[e["name"]] += e["dur"] * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time inside the window summed by the innermost host
        event running at each gap's middle."""
        gaps, prev = [], self.t0
        for a, b in self._busy():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # Host events by length, shortest first, so that the first bucket
        # with an event around a gap's middle holds the innermost one and
        # each gap scans only the events that start shortly before it.
        buckets = []
        lo = 0.0
        for cap in (1e3, 1e4, 1e5, float("inf")):
            evs = sorted((e for e in self.host if lo < e["dur"] <= cap),
                         key=lambda e: e["ts"])
            buckets.append((max((e["dur"] for e in evs), default=0.0), evs,
                            [e["ts"] for e in evs]))
            lo = cap
        tot = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            best = None
            for longest, evs, starts in buckets:
                i0 = bisect.bisect_left(starts, mid - longest)
                i1 = bisect.bisect_right(starts, mid)
                for e in evs[i0:i1]:
                    if e["ts"] + e["dur"] >= mid and (
                            best is None or e["dur"] < best["dur"]):
                        best = e
                if best is not None:
                    break
            tot[best["name"] if best else "(no host event)"] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]
