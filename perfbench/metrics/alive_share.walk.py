"""trace driver (core/tracer.py, ops/raytrace_cuda.py): the share of the
ray slots a round's work runs over that hold a ray not yet done, from the
program's counters in the ``full_render_cycle`` records of the traced
cycles: 100 x the sum of ``rays_alive`` (one a round) over the rounds
times ``n_rays``. Moves ``cycle_ms``."""


def read(run):
    recs = [r for r in run.records if r.get("rays_alive") and "n_rays" in r]
    slots = sum(len(r["rays_alive"]) * int(r["n_rays"]) for r in recs)
    if slots <= 0:
        return None
    return 100.0 * sum(sum(r["rays_alive"]) for r in recs) / slots
