"""kernels: device milliseconds a matrix call of the posed schedule and
posed K2 (kernels named ``tile_schedule_kernel`` and
``trace_sched_kernel``) in the profiled span, read as
``k2_sched_ms.walk`` reads a cycle's. Moves ``rays_per_s``."""
from perfbench import harness


def read(run):
    return harness.read_metric("k2_sched_ms.walk", run)
