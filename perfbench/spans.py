"""The program's own spans in a traced run, and what the card did in them.

The program names its phases with ``ar2.*`` spans (``record_function``
ranges, ``user_annotation`` events of the Chrome trace, on the clock of the
kernels) while a profiler records; ``Spans`` takes them from the host
events of a ``devtrace.Summary``. Spans nest by time on their thread; where
spans of several threads hold one instant, the shortest is the innermost.

A kernel belongs to the innermost span that holds the host event that
launched it, the two matched by the trace's ``correlation`` id, on any
thread: the backward pass's kernels are launched from autograd's device
thread while the thread that called it waits in its span. An idle gap of
the card belongs to the span that holds its middle. Only the profiled
span's units count: kernels and gaps inside it (``Summary.device``, t0 to
t1), and spans that start inside it.
"""
from __future__ import annotations

import bisect
from collections import Counter

PREFIX = "ar2."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    def __init__(self, tr):
        self.tr = tr
        self.events = sorted(
            (e for e in tr.host if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)),
            key=lambda e: (e["ts"], -e["dur"]))
        self._segments()
        self._parents()

    def __bool__(self) -> bool:
        return bool(self.events)

    def _segments(self) -> None:
        """Cut the time line where a span starts or ends; each piece gets
        the shortest span open over it (None where none is)."""
        cuts = sorted({t for e in self.events
                       for t in (e["ts"], e["ts"] + e["dur"])})
        opening: dict = {}
        closing: dict = {}
        for i, e in enumerate(self.events):
            opening.setdefault(e["ts"], []).append(i)
            closing.setdefault(e["ts"] + e["dur"], []).append(i)
        open_now: set = set()
        self.starts, self.owner = [], []
        for t in cuts:
            open_now.difference_update(closing.get(t, ()))
            open_now.update(i for i in opening.get(t, ())
                            if self.events[i]["dur"] > 0)
            self.starts.append(t)
            self.owner.append(min(open_now, key=lambda i:
                                  self.events[i]["dur"]) if open_now
                              else None)

    def at(self, t: float):
        """The innermost span that holds instant ``t``, or None."""
        k = bisect.bisect_right(self.starts, t) - 1
        if k < 0:
            return None
        i = self.owner[k]
        return None if i is None else self.events[i]

    def _parents(self) -> None:
        """The span of the same thread that holds each span, by index."""
        self.parent = [None] * len(self.events)
        stacks: dict = {}
        for i, e in enumerate(self.events):
            stack = stacks.setdefault(e["tid"], [])
            while stack and (self.events[stack[-1]]["ts"]
                             + self.events[stack[-1]]["dur"]
                             < e["ts"] + e["dur"]):
                stack.pop()
            self.parent[i] = stack[-1] if stack else None
            stack.append(i)

    def enclosing(self, i: int) -> list:
        """The names of span ``i`` and of the spans that hold it."""
        names = []
        while i is not None:
            names.append(self.events[i]["name"])
            i = self.parent[i]
        return names

    def named(self, *names) -> list:
        """The spans of ``names`` that start inside the profiled span."""
        return [e for e in self.events if e["name"] in names
                and self.tr.t0 <= e["ts"] <= self.tr.t1]

    def kernel_owners(self) -> Counter:
        """Kernels of the profiled span by the span they belong to (its
        event's index in ``events``; None for a kernel whose launch no
        ``ar2.`` span holds or that has no launch event)."""
        launches = {e["args"]["correlation"]: e for e in self.tr.host
                    if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        index = {id(e): i for i, e in enumerate(self.events)}
        out: Counter = Counter()
        for k in self.tr.kernels():
            launch = launches.get(k.get("args", {}).get("correlation"))
            span = self.at(launch["ts"]) if launch is not None else None
            out[index[id(span)] if span is not None else None] += 1
        return out

    def kernels_in(self, *names) -> int:
        """Kernels of the profiled span that belong to a span of ``names``
        or to a span nested in one."""
        n = 0
        for i, c in self.kernel_owners().items():
            if i is not None and set(self.enclosing(i)) & set(names):
                n += c
        return n

    def idle_gaps(self) -> list:
        """The card's idle gaps in the profiled span, (start, end) in the
        trace's microseconds: no kernel, copy or fill runs."""
        tr = self.tr
        busy = []
        for a, b in sorted((max(e["ts"], tr.t0),
                            min(e["ts"] + e["dur"], tr.t1))
                           for e in tr.device):
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        gaps, prev = [], tr.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if tr.t1 > prev:
            gaps.append((prev, tr.t1))
        return gaps

    def idle_in_spans_s(self) -> float:
        """Seconds of the card's idle gaps whose middle an ``ar2.`` span
        holds."""
        return 1e-6 * sum(b - a for a, b in self.idle_gaps()
                          if self.at((a + b) / 2) is not None)


def of(run) -> Spans | None:
    """The spans of ``run``'s traced span, or None where it has no trace,
    no unit or no ``ar2.`` span."""
    tr = run.trace
    if tr is None or tr.n_units == 0:
        return None
    sp = Spans(tr)
    return sp if sp else None
