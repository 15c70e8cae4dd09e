"""kernels: the clusters the schedule gives a tile of 128 rays, which K2
tests, on average over the rounds of the traced cycles, from the program's
counters in their ``full_render_cycle`` records: the sum of
``sched_candidates`` (one a round) over the rounds times ``n_tiles``.
Moves ``cycle_ms``."""


def read(run):
    recs = [r for r in run.records
            if r.get("sched_candidates") and "n_tiles" in r]
    tiles = sum(len(r["sched_candidates"]) * int(r["n_tiles"]) for r in recs)
    if tiles <= 0:
        return None
    return sum(sum(r["sched_candidates"]) for r in recs) / tiles
