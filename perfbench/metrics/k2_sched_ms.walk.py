"""kernels: device milliseconds a cycle of the clustered route's schedule
kernel and K2 (kernels named ``tile_schedule_kernel`` and
``trace_sched_kernel``) in the profiled span. Moves ``cycle_ms``."""

NAMES = ("tile_schedule_kernel", "trace_sched_kernel")


def read(run):
    tr = run.trace
    if tr is None or tr.n_units == 0:
        return None
    s = tr.kernel_s(lambda n: any(k in n for k in NAMES))
    if s <= 0.0:
        return None
    return 1e3 * s / tr.n_units
