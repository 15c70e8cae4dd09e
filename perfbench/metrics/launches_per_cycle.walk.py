"""trace driver (core/tracer.py, ops/raytrace_cuda.py): device kernels
launched a cycle, counted in the device trace of the profiled span. Moves
``cycle_ms``."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_units == 0 or not tr.kernels():
        return None
    return len(tr.kernels()) / tr.n_units
