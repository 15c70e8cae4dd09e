"""convolution (ops/convolve.py): mean ``convolve_ms`` of the program's
``full_render_cycle`` records (the signal convolved with the IR and the
stereo output's copy to the host; host clock) over the window's cycles
outside the profiled span. Moves ``cycle_ms``."""


def read(run):
    recs = [r for i, r in enumerate(run.records) if i not in run.traced_units]
    if not recs:
        return None
    return sum(float(r["convolve_ms"]) for r in recs) / len(recs)
