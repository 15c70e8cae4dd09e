"""host (the program's Python and launches): the card's idle time a unit
(a walk's cycle, a fit's step, a matrix call) that the program holds, the
reader of every ``program_idle_ms.<traffic>``: the milliseconds of the idle
gaps in the profiled span whose middle lies inside one of the program's
``ar2.`` spans, over the span's units. Each moves its cell's rate or time a
unit."""
from perfbench import spans


def read(run):
    sp = spans.of(run)
    if sp is None or sp.tr.busy_s <= 0.0:
        return None
    return 1e3 * sp.idle_in_spans_s() / sp.tr.n_units
