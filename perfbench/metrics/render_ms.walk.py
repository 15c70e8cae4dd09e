"""facade (renderer.py): mean ``render_ms`` of the program's
``full_render_cycle`` records (set the pose, render, the IR's copy to the
host; host clock, fenced by that copy) over the window's cycles outside the
profiled span. Moves ``cycle_ms``."""


def read(run):
    recs = [r for i, r in enumerate(run.records) if i not in run.traced_units]
    if not recs:
        return None
    return sum(float(r["render_ms"]) for r in recs) / len(recs)
