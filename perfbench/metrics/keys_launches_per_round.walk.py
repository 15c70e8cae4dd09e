"""trace driver (the coherent sort): the kernels launched a round by the
clustered route's reorder, those that belong to the program's
``ar2.trace.keys`` or ``ar2.trace.sort`` spans in the profiled span, over
its ``ar2.trace.round`` spans. Moves ``cycle_ms``."""
from perfbench import spans


def read(run):
    sp = spans.of(run)
    if sp is None or not sp.tr.kernels():
        return None
    rounds = len(sp.named("ar2.trace.round"))
    if rounds == 0 or not sp.named("ar2.trace.keys"):
        return None
    return sp.kernels_in("ar2.trace.keys", "ar2.trace.sort") / rounds
