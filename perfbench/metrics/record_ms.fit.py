"""gradient (diff/replay.py, diff/inverse.py): host milliseconds a fit step
of the path recording, the program's ``ar2.fit.record`` spans that start in
the profiled span (a whole number of ``replay_refresh`` periods) summed
over its steps. Moves ``step_ms``."""
from perfbench import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    rec = sp.named("ar2.fit.record")
    if not rec:
        return None
    return 1e-3 * sum(e["dur"] for e in rec) / sp.tr.n_units
