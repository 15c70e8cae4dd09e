"""kernels: the share of K2's tile-union work that its per-warp cull
leaves, from the program's counters in the ``full_render_cycle`` records
of the traced cycles: 100 x the sum of ``sched_warp_visits`` (one a round:
the (warp, candidate) pairs whose cluster rows a warp of 32 rays tested)
over 4 x the sum of ``sched_candidates`` (the pairs a tile of four warps
would test without the cull). A program without the counter reads
nothing. Moves ``cycle_ms``."""


def read(run):
    recs = [r for r in run.records
            if r.get("sched_warp_visits") and r.get("sched_candidates")]
    pairs = 4 * sum(sum(r["sched_candidates"]) for r in recs)
    if pairs <= 0:
        return None
    return 100.0 * sum(sum(r["sched_warp_visits"]) for r in recs) / pairs
