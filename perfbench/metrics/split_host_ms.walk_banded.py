"""auralization (ops/filterbank.py, ops/convolve.py): host milliseconds a
cycle of the program's ``ar2.convolve.split`` spans that start in the
profiled span: the band gains built on the host, their upload and the
split's launches. Moves ``cycle_ms``."""
from perfbench import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    split = sp.named("ar2.convolve.split")
    if not split:
        return None
    return 1e-3 * sum(e["dur"] for e in split) / sp.tr.n_units
