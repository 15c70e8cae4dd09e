"""kernels: device milliseconds a fit step of the pose replay pair, the
kernels named ``replay_pose_kernel`` and ``replay_pose_bwd_kernel`` in the
profiled span (every receiver's) over its steps. Reckoned only where the
traced recordings' ``fit_record`` counters say the replay is the pose
pair (``replay_pose`` 1); a program without the counters reads nothing.
Moves ``step_ms``."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_units == 0 or not any(
            r.get("replay_pose") == 1 for r in run.records):
        return None
    s = tr.kernel_s(lambda n: "replay_pose_kernel" in n
                    or "replay_pose_bwd_kernel" in n)
    if s <= 0.0:
        return None
    return 1e3 * s / tr.n_units
