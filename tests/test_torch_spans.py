"""The port's spans and counters (``utils/profiling.py``): off, nothing is
entered and nothing is counted; on, under ``profiling.trace`` on the CPU,
the render, the rounds of both routes, the matrix and the fit export their
``ar2.`` spans nested as the program runs them, and the counters read what
the state holds."""
import json

import numpy as np
import pytest
import torch

from audiorenderingv2_tpu_torch import diff, multi
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.core.tracer import (packed_scene,
                                                    scene_to_arrays)
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import schedule_cuda
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
from audiorenderingv2_tpu_torch.utils import logging as arlog
from audiorenderingv2_tpu_torch.utils import profiling

torch.set_num_threads(1)

N_RAYS = 1024
SIGNAL = 8064


def box_renderer(max_bounces: int = 20) -> AudioRenderer:
    v, t = tt.box_room((4.0, 3.0, 3.0))
    r = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), ir_seconds=1,
                      sample_rate=8000, n_rays=N_RAYS,
                      max_bounces=max_bounces, device="cpu", seed=5)
    r.set_emitter_pos(np.zeros(3, np.float32))
    r.set_receiver(np.array([1.0, 0.5, 0.0], np.float32), 30.0)
    return r


def office_renderer() -> AudioRenderer:
    """652 triangles: the clustered route of ``tuned.auto_options``."""
    r = AudioRenderer(tt.office_scene(700), ir_seconds=1, sample_rate=8000,
                      n_rays=N_RAYS, max_bounces=4, device="cpu", seed=5)
    r.set_emitter_pos(np.zeros(3, np.float32))
    r.set_receiver(np.array([6.0, 1.0, -8.0], np.float32), 0.0)
    return r


def span_tree(path) -> list:
    """The ``ar2.`` spans of a Chrome trace in order of start, each as
    (name, names of the spans that hold it, innermost first)."""
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"
          and e["name"].startswith("ar2.")]
    ev.sort(key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in ev:
        while stack and (stack[-1]["ts"] + stack[-1]["dur"]
                         < e["ts"] + e["dur"]):
            stack.pop()
        out.append((e["name"], [s["name"] for s in reversed(stack)]))
        stack.append(e)
    return out


def traced(tmp_path, fn):
    with profiling.trace(str(tmp_path / "prof"), device="cpu"):
        out = fn()
    return out, span_tree(tmp_path / "prof" / "trace.json")


def rounds_of(tree) -> list:
    """The names of each ``ar2.trace.round``'s child spans, a list a
    round."""
    out = []
    for name, parents in tree:
        if name == "ar2.trace.round":
            out.append([])
        elif parents and parents[0] == "ar2.trace.round":
            out[-1].append(name)
    return out


# ------------------------------------------------------------------- off

def test_off_enters_nothing_and_counts_nothing(tmp_path, monkeypatch):
    """With no profiler running a span is the one shared no-op, no
    ``record_function`` is entered, no counter's callable is called, and a
    cycle's record keeps exactly the fields it had."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    def uncalled():
        raise AssertionError("a counter's callable ran with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("ar2.cycle") is profiling.span("ar2.render")
    with profiling.span("ar2.cycle"):
        pass
    with profiling.collect() as c:
        profiling.count("rays_alive", uncalled)
        profiling.count("n_rays", uncalled, once=True)
    assert c.read() == {}
    with profiling.Counters() as opened:  # open, but no profiler records
        profiling.count("rays_alive", uncalled)
    assert opened.read() == {}
    profiling.count("rays_alive", uncalled)  # no collector open

    path = tmp_path / "cycle.jsonl"
    arlog.configure(path=str(path))
    try:
        r = office_renderer()
        r.full_render_cycle(np.array([6.0, 1.0, -8.0]), 0.0,
                            torch.ones(SIGNAL))
    finally:
        arlog.configure()
    rec = json.loads(path.read_text().strip().splitlines()[-1])
    assert set(rec) == {"ts", "event", "render_ms", "convolve_ms",
                        "receiver", "yaw_deg"}
    assert r.counters == {}


def test_off_launches_no_reduction(monkeypatch):
    """Untraced, every counter of a render of either route is reached and
    none of their callables runs, so no reduction is launched."""
    reached = []
    real = profiling.count

    def guarded(name, fn, **kw):
        def refuse():
            raise AssertionError(f"counter {name} computed untraced")

        reached.append(name)
        return real(name, refuse, **kw)

    monkeypatch.setattr(profiling, "count", guarded)
    for r in (box_renderer(), office_renderer()):
        with profiling.collect():
            r.render()
    assert {"rays_alive", "sched_candidates", "n_tiles",
            "n_rays"} <= set(reached)


# -------------------------------------------------------------------- on

def test_box_cycle_spans(tmp_path):
    """A box cycle: ``ar2.cycle`` > ``ar2.render`` > the rounds, one round
    a budget, the partition in every round but the last, the binning once,
    the IR's copy and the convolution."""
    r = box_renderer()
    r.render()
    _, tree = traced(tmp_path, lambda: r.full_render_cycle(
        np.array([1.0, 0.5, 0.0]), 30.0, torch.ones(SIGNAL)))
    parents = dict((n, p) for n, p in tree)
    assert tree[0] == ("ar2.cycle", [])
    assert parents["ar2.render"] == ["ar2.cycle"]
    assert parents["ar2.trace.round"] == ["ar2.render", "ar2.cycle"]
    assert parents["ar2.trace.kernel"][0] == "ar2.trace.round"
    assert parents["ar2.trace.partition"][0] == "ar2.trace.round"
    assert parents["ar2.bin"] == ["ar2.render", "ar2.cycle"]
    assert parents["ar2.ir_to_host"] == ["ar2.render", "ar2.cycle"]
    assert parents["ar2.convolve"] == ["ar2.cycle"]
    budgets = r.opts.round_budgets
    assert len(budgets) >= 2
    assert rounds_of(tree) == ([["ar2.trace.kernel", "ar2.trace.partition"]]
                               * (len(budgets) - 1) + [["ar2.trace.kernel"]])
    names = [n for n, _ in tree]
    assert names.count("ar2.bin") == 1 and names.count("ar2.cycle") == 1
    assert names.count("ar2.trace.init") >= 1


def test_clustered_round_spans(tmp_path):
    """The clustered route: the schedule, K2, the keys and the sort a round;
    no keys or sort in the last."""
    r = office_renderer()
    assert r.sc.cluster_boxes is not None and r.opts.schedule
    r.render()
    _, tree = traced(tmp_path, r.render)
    per_round = rounds_of(tree)
    assert len(per_round) == 4
    full = ["ar2.trace.schedule", "ar2.trace.kernel", "ar2.trace.keys",
            "ar2.trace.sort"]
    assert per_round == [full] * 3 + [full[:2]]


def _spy_rounds(monkeypatch):
    """Count the rays not done after each round's kernel, read from the
    state, through ``trace_state``'s own hook; and the schedule's column 0."""
    after, sched_sums = [], []
    real_rounds = rc.trace_state
    real_sched = schedule_cuda.tile_schedule

    def rounds(*a, **k):
        assert k.get("harvest") is None
        k["harvest"] = lambda i, st: after.append(
            int((st[rc._C_DONE] == 0.0).sum()))
        return real_rounds(*a, **k)

    def sched(state, boxes):
        out = real_sched(state, boxes)
        sched_sums.append(int(schedule_cuda.tile_schedule_plain(
            state, boxes)[:, 0].sum()))
        return out

    monkeypatch.setattr(rc, "trace_state", rounds)
    monkeypatch.setattr(schedule_cuda, "tile_schedule", sched)
    return after, sched_sums


@pytest.mark.parametrize("route", ["rows", "clustered"])
def test_counter_values(route, tmp_path, monkeypatch):
    """``rays_alive``: the rays launched first, never rising, then at each
    round's start the rays not done that the state held after the round
    before; ``sched_candidates``: the schedule's column 0 summed, each
    round; ``n_rays``, ``n_tiles`` once; the cycle's record carries them."""
    r = box_renderer() if route == "rows" else office_renderer()
    r.render()
    after, sched_sums = _spy_rounds(monkeypatch)
    path = tmp_path / "cycle.jsonl"
    arlog.configure(path=str(path))
    try:
        traced(tmp_path, lambda: r.full_render_cycle(
            r.receiver_pos, r.receiver_yaw_deg, torch.ones(SIGNAL)))
    finally:
        arlog.configure()
    got = r.counters
    alive = got["rays_alive"]
    assert got["n_rays"] == N_RAYS and alive[0] == N_RAYS
    assert alive[1:] == after[:-1] and len(alive) == len(after)
    assert all(b <= a for a, b in zip(alive, alive[1:]))
    assert alive[-1] > 0
    if route == "clustered":
        assert got["sched_candidates"] == sched_sums
        assert len(sched_sums) == len(alive) == 4
        assert got["n_tiles"] == -(-N_RAYS // 128)
    else:
        assert "sched_candidates" not in got and sched_sums == []
    rec = json.loads(path.read_text().strip().splitlines()[-1])
    for k, v in got.items():
        assert rec[k] == v


def _spy_k2_visits(monkeypatch) -> list:
    """The ``visits`` each K2 call of the rounds is given (None, or the
    tensor the kernel adds to, cloned after the call)."""
    seen = []
    real = schedule_cuda.trace_round_sched

    def spy(*a, **k):
        out = real(*a, **k)
        v = a[7] if len(a) > 7 else k.get("visits")
        seen.append(None if v is None else v.clone())
        return out

    monkeypatch.setattr(schedule_cuda, "trace_round_sched", spy)
    return seen


def test_warp_visits_only_while_counting(tmp_path, monkeypatch):
    """Untraced, K2 is given no counter (the kernel then gets a null
    pointer); traced, ``sched_warp_visits`` holds each round's (warp,
    candidate) tests, the sum of what that round's K2 added, at most four
    times the round's candidates, and fewer over the cycle than the tile
    union's four a candidate."""
    r = office_renderer()
    seen = _spy_k2_visits(monkeypatch)
    r.render()
    assert len(seen) == 4 and all(v is None for v in seen)
    assert "sched_warp_visits" not in r.counters
    seen.clear()
    traced(tmp_path, lambda: r.full_render_cycle(
        r.receiver_pos, r.receiver_yaw_deg, torch.ones(SIGNAL)))
    got = r.counters
    visits, cand = got["sched_warp_visits"], got["sched_candidates"]
    assert visits == [int(v.sum()) for v in seen]
    assert len(visits) == len(cand) == 4
    assert all(0 < v <= 4 * c for v, c in zip(visits, cand))
    assert 0 < sum(visits) < 4 * sum(cand)


def test_counters_read_in_one_copy():
    """Tensors and host numbers under one collector come back as ints, in
    the order counted; ``once`` keeps the last value."""
    with torch.profiler.profile():
        with profiling.collect() as c:
            profiling.count("a", lambda: torch.tensor(3, dtype=torch.int32))
            profiling.count("a", lambda: 4)
            profiling.count("b", lambda: torch.tensor(7))
            profiling.count("n", lambda: 1, once=True)
            profiling.count("n", lambda: torch.tensor(9), once=True)
        with profiling.collect() as inner_free:
            pass
        assert inner_free.read() == {}
    assert c.read() == {"a": [3, 4], "b": [7], "n": 9}


def test_collectors_nest_and_close():
    """A render inside another collector counts into its own; closing it
    gives the outer one back."""
    with torch.profiler.profile():
        with profiling.collect() as outer:
            profiling.count("x", lambda: 1)
            with profiling.collect() as inner:
                profiling.count("x", lambda: 2)
            profiling.count("x", lambda: 3)
        profiling.count("x", lambda: 4)  # none open
    assert outer.read() == {"x": [1, 3]} and inner.read() == {"x": [2]}


def test_matrix_spans(tmp_path):
    """One ``ar2.matrix`` a call around its pair batches, each an
    ``ar2.matrix.batch`` with its rounds and binning, then its copy."""
    v, t = tt.box_room((4.0, 3.0, 3.0))
    sc = scene_to_arrays(tt.scene_from_arrays(v, t, 0.3), 128, device="cpu")
    params = TraceParams(sample_rate=8000, ir_length=8000, max_bounces=8)
    rows, boxes = packed_scene(sc, params, None, None)
    em = np.array([[0.0, 0.0, 0.0]], np.float32)
    rec = np.array([[1.0, 0.5, 0.0], [-1.0, 0.5, 0.5]], np.float32)
    irs, tree = traced(tmp_path, lambda: multi.render_ir_matrix(
        sc, 3, em, rec, [0.0, 90.0], 256, params, pair_batch=1, rows=rows,
        boxes=boxes))
    assert irs.shape == (1, 2, 2, 8000)
    names = [n for n, _ in tree]
    assert names.count("ar2.matrix") == 1
    assert names.count("ar2.matrix.batch") == 2
    assert names.count("ar2.matrix.to_host") == 2
    parents = dict(tree)
    assert parents["ar2.matrix.batch"] == ["ar2.matrix"]
    assert parents["ar2.matrix.to_host"] == ["ar2.matrix"]
    assert parents["ar2.trace.round"][-2:] == ["ar2.matrix.batch",
                                               "ar2.matrix"]


def test_fit_step_spans(tmp_path):
    """A 2-step replay fit: each step's spans in order, the recording (with
    its rounds) in step 0 only."""
    v, t = tt.box_room((4.0, 3.0, 3.0))
    scene = tt.scene_from_arrays(v, t, 0.3)
    params = TraceParams(sample_rate=8000, ir_length=8000, base_power=3.62,
                         max_bounces=4)
    target = torch.rand(2, 8000) * 1e-4
    res, tree = traced(tmp_path, lambda: diff.fit_scene_parameters(
        scene, target, params, n_rays=256, steps=2, method="replay",
        receiver_pos=(1.0, 0.5, 0.0), device="cpu", seed=1))
    assert len(res.losses) == 2
    parts = ["ar2.fit.forward", "ar2.fit.loss", "ar2.fit.backward",
             "ar2.fit.adam", "ar2.fit.loss_read"]
    steps = []
    for name, parents in tree:
        if name == "ar2.fit.step":
            steps.append([])
        elif parents == ["ar2.fit.step"]:
            steps[-1].append(name)
    assert steps == [["ar2.fit.record"] + parts, parts]
    rounds = [p for n, p in tree if n == "ar2.trace.round"]
    assert len(rounds) == 4
    assert all(p == ["ar2.fit.record", "ar2.fit.step"] for p in rounds)
