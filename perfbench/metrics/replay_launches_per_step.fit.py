"""gradient (diff/replay.py, diff/inverse.py): the kernels launched a fit
step by the replay and its backward pass, those that belong to the
program's ``ar2.fit.forward`` or ``ar2.fit.backward`` spans (the backward's
from autograd's device thread) in the profiled span, over its steps. Moves
``step_ms``."""
from perfbench import spans


def read(run):
    sp = spans.of(run)
    if sp is None or not sp.tr.kernels() or not sp.named("ar2.fit.forward"):
        return None
    return (sp.kernels_in("ar2.fit.forward", "ar2.fit.backward")
            / sp.tr.n_units)
