"""kernels: K1's share of its roofline on the box, the reader of every
``k1_roofline.<traffic>``. K1's least time a unit (a walk's cycle, a
matrix call) is the reference's ray-bounce steps a unit, from the checked
cycles or pairs, times the scene's triangles times 40 float32 operations
at 67 TFLOP/s, or its rays' state read and written once at 3.35 TB/s,
whichever is larger (``yardstick.trace_bound_s``); its device time a unit
is the summed time of the kernels named ``trace_rows_kernel`` /
``trace_chunks_kernel`` in the profiled span over its units."""
from perfbench import yardstick

K1 = ("trace_rows_kernel", "trace_chunks_kernel")


def read(run):
    tr, ref = run.trace, run.reference
    if tr is None or tr.n_units == 0 or "ray_steps_per_unit" not in ref:
        return None
    k1_s = tr.kernel_s(lambda n: any(k in n for k in K1)) / tr.n_units
    if k1_s <= 0.0:
        return None
    return 100.0 * yardstick.trace_bound_s(
        ref["ray_steps_per_unit"], ref["n_triangles"], ref["n_rays"]) / k1_s
