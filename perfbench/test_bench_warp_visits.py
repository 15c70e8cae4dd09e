"""The reader of ``warp_visit_share.walk`` on hand-built records: the
(warp, candidate) pairs K2's warps tested over four times the schedule's
candidates, over the traced cycles' records; nothing where the program
keeps no ``sched_warp_visits`` (a program without the per-warp cull, or an
untraced cycle)."""
from __future__ import annotations

import pytest

from perfbench import harness

NAME = "warp_visit_share.walk"

CULLED = [
    {"render_ms": 1.0, "sched_candidates": [10, 20, 30], "n_tiles": 4,
     "sched_warp_visits": [20, 40, 60]},
    {"render_ms": 1.0},                      # an untraced cycle's record
    {"render_ms": 1.0, "sched_candidates": [40], "n_tiles": 4,
     "sched_warp_visits": [100]},
]


def run_of(records) -> "harness.Run":
    run = harness.Run(None, 0)
    run.trace = None
    run.records = list(records)
    return run


def test_share_of_the_tile_union():
    # (20 + 40 + 60 + 100) / (4 x (10 + 20 + 30 + 40))
    assert harness.read_metric(NAME, run_of(CULLED)) == pytest.approx(55.0)


@pytest.mark.parametrize("records", [
    [],
    [{"render_ms": 1.0}],
    [{"render_ms": 1.0, "sched_candidates": [10, 20], "n_tiles": 4}],
    [{"render_ms": 1.0, "rays_alive": [100, 50], "n_rays": 100}],
])
def test_reads_nothing_without_the_counter(records):
    assert harness.read_metric(NAME, run_of(records)) is None


def test_in_the_manifest_for_both_offices():
    m = next(m for m in harness.load_manifest()["per_layer"]
             if m["name"] == NAME)
    assert m["workloads"] == ["office.walk", "office_octave.walk_banded"]
    assert m["source"] == "program_counter" and m["moves"] == "cycle_ms"
