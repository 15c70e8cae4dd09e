"""The readers of the program's spans and counters, on a hand-built trace.

Two units of 100 us on the main thread (tid 1): a fit step that records
(a round with its keys and sort) and replays, and a walk cycle with two
rounds. Each kernel is matched to its launch by ``correlation``; one is
launched from a second thread (tid 2) inside the main thread's
``ar2.fit.backward``, one outside every span, one has no launch event and
one lies outside the window. The last idle gap lies outside every span.
"""
from __future__ import annotations

import pytest

from perfbench import devtrace, harness, spans


def _ev(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if args:
        e["args"] = args
    return e


SPANS = [
    ("ar2.fit.step", 0, 90), ("ar2.fit.record", 0, 20),
    ("ar2.trace.round", 2, 16), ("ar2.trace.keys", 5, 3),
    ("ar2.trace.sort", 8, 4), ("ar2.fit.forward", 20, 20),
    ("ar2.fit.backward", 40, 30), ("ar2.fit.adam", 70, 10),
    ("ar2.cycle", 100, 90), ("ar2.trace.round", 110, 40),
    ("ar2.trace.keys", 115, 10), ("ar2.trace.sort", 125, 10),
    ("ar2.trace.round", 150, 20),
]
# (launch time, launching thread, kernel start, kernel length)
KERNELS = [(6, 1, 10, 2), (9, 1, 13, 2), (25, 1, 26, 4), (45, 2, 46, 14),
           (116, 1, 117, 1), (126, 1, 127, 2), (160, 1, 161, 4),
           (195, 1, 196, 2), (299, 1, 300, 10)]


def trace_events() -> list:
    ev = [_ev("user_annotation", devtrace.UNIT, 0.0, 100.0),
          _ev("user_annotation", devtrace.UNIT, 100.0, 100.0)]
    ev += [_ev("user_annotation", n, float(t), float(d)) for n, t, d in SPANS]
    ev.append(_ev("user_annotation", "perfbench.other", 0.0, 200.0))
    for c, (lt, tid, kt, kd) in enumerate(KERNELS):
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", float(lt), 0.5,
                      tid, correlation=c))
        ev.append(_ev("kernel", f"k{c}", float(kt), float(kd), 7,
                      correlation=c))
    ev.append(_ev("kernel", "unlaunched", 170.0, 1.0, 7, correlation=99))
    return ev


RECORDS = [
    {"render_ms": 1.0, "rays_alive": [100, 60, 30], "n_rays": 100,
     "sched_candidates": [10, 20, 30], "n_tiles": 4},
    {"render_ms": 1.0},                      # an untraced cycle's record
    {"render_ms": 1.0, "rays_alive": [100, 50], "n_rays": 100},
]


def run_of(events=None, records=()) -> "harness.Run":
    run = harness.Run(None, 0)
    run.trace = devtrace.Summary(events) if events is not None else None
    run.records = list(records)
    return run


def test_spans_nest_and_own_the_kernels():
    sp = spans.Spans(devtrace.Summary(trace_events()))
    assert len(sp.events) == len(SPANS)        # ar2. spans only
    assert sp.at(6)["name"] == "ar2.trace.keys"
    assert sp.at(45)["name"] == "ar2.fit.backward"
    assert sp.at(95) is None and sp.at(195) is None
    keys = next(i for i, e in enumerate(sp.events)
                if e["name"] == "ar2.trace.keys")
    assert sp.enclosing(keys) == ["ar2.trace.keys", "ar2.trace.round",
                                  "ar2.fit.record", "ar2.fit.step"]
    owners = sp.kernel_owners()
    assert sum(owners.values()) == 9            # the one past t1 left out
    assert owners[None] == 2                    # outside spans, unlaunched
    assert sp.kernels_in("ar2.fit.backward") == 1   # from the second thread
    assert sp.kernels_in("ar2.fit.record") == 2     # its nested keys, sort
    assert sp.kernels_in("ar2.cycle") == 3
    assert len(sp.named("ar2.trace.round")) == 3
    gaps = sp.idle_gaps()
    assert sum(b - a for a, b in gaps) == pytest.approx(168.0)
    assert sp.idle_in_spans_s() == pytest.approx(166e-6)


@pytest.mark.parametrize("name,value", [
    ("program_idle_ms.walk", 0.083), ("program_idle_ms.fit", 0.083),
    ("program_idle_ms.matrix", 0.083),
    ("keys_launches_per_round.walk", 4 / 3),
    ("replay_launches_per_step.fit", 1.0),
    ("record_ms.fit", 0.01),
    ("alive_share.walk", 68.0),
    ("candidates_per_tile.walk", 5.0),
])
def test_reader_values(name, value):
    run = run_of(trace_events(), RECORDS)
    assert harness.read_metric(name, run) == pytest.approx(value)


NEW = ["program_idle_ms.walk", "program_idle_ms.fit",
       "program_idle_ms.matrix", "keys_launches_per_round.walk",
       "replay_launches_per_step.fit", "record_ms.fit", "alive_share.walk",
       "candidates_per_tile.walk"]


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_where_nothing_is(name):
    """No trace and no records; a trace without the program's spans (the
    parent's program) and records without counters (untraced cycles); a
    trace with spans but no kernel (a run on the CPU) reads no device
    metric."""
    assert harness.read_metric(name, run_of()) is None
    bare = [e for e in trace_events()
            if not e["name"].startswith(spans.PREFIX)]
    assert harness.read_metric(name, run_of(bare, [RECORDS[1]])) is None
    host_only = [e for e in trace_events() if e["cat"] != "kernel"]
    got = harness.read_metric(name, run_of(host_only))
    source = next(m["source"] for m in harness.load_manifest()["per_layer"]
                  if m["name"] == name)
    if source == "device_trace":
        assert got is None


def test_new_metrics_are_in_the_manifest():
    names = [m["name"] for m in harness.load_manifest()["per_layer"]]
    assert names[-len(NEW):] == [
        "alive_share.walk", "candidates_per_tile.walk",
        "keys_launches_per_round.walk", "program_idle_ms.walk",
        "program_idle_ms.fit", "program_idle_ms.matrix",
        "replay_launches_per_step.fit", "record_ms.fit"]
    assert sorted(NEW) == sorted(names[-len(NEW):])
