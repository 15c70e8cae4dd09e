"""kernels: device milliseconds a fit step of the replay's backward, the
kernels named ``replay_bwd_kernel`` in the profiled span over its steps.
Moves ``step_ms``."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_units == 0:
        return None
    s = tr.kernel_s(lambda n: "replay_bwd_kernel" in n)
    if s <= 0.0:
        return None
    return 1e3 * s / tr.n_units
