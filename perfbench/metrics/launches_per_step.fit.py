"""gradient (diff/replay.py, diff/inverse.py): device kernels launched a
fit step (recording, replay, loss, backward, Adam), counted in the device
trace of the profiled span. Moves ``step_ms``."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_units == 0 or not tr.kernels():
        return None
    return len(tr.kernels()) / tr.n_units
