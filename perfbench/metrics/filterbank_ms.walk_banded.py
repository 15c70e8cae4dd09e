"""auralization (ops/filterbank.py, ops/convolve.py): device milliseconds
a cycle of the kernels that belong to the program's ``ar2.convolve.split``
or ``ar2.convolve.bands`` spans in the profiled span (the band split and
the per-band convolutions with their sum), each kernel given to the
innermost span that holds its launch. Moves ``cycle_ms``."""
from perfbench import spans

NAMES = ("ar2.convolve.split", "ar2.convolve.bands")


def read(run):
    sp = spans.of(run)
    if sp is None or not sp.named(*NAMES):
        return None
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in sp.tr.host
                 if e.get("cat") in spans.LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    us = 0.0
    for k in sp.tr.kernels():
        ts = launch_ts.get(k.get("args", {}).get("correlation"))
        span = sp.at(ts) if ts is not None else None
        if span is not None and span["name"] in NAMES:
            us += k["dur"]
    if us <= 0.0:
        return None
    return 1e-3 * us / sp.tr.n_units
