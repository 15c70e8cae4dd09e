"""kernels: the pose replay pair's share of its roofline in a source
localization. The pair's least time a step is the bytes any pose replay
must move over the paths of a recording (``replay_pose_bytes.
pair_bound_s``, from the counters of the program's ``fit_record`` events
of the traced recordings whose ``replay_pose`` is 1, averaged: their
deposits and steps are summed over the receivers, and the scene's bands
and triangles that ``drivers/fit_pose.py`` keeps in ``run.reference``) at
3.35 TB/s; its device time a step is the summed time of the kernels named
``replay_pose_kernel`` and ``replay_pose_bwd_kernel`` in the profiled span
over its steps. 100 x the first over the second. A program without the
counters reads nothing. Moves ``step_ms``."""
from perfbench import replay_pose_bytes

KEYS = ("replay_deposits", "replay_steps", "replay_pose")


def read(run):
    tr = run.trace
    recs = [r for r in run.records
            if all(k in r for k in KEYS) and r["replay_pose"] == 1]
    scene = run.reference
    if (tr is None or tr.n_units == 0 or not recs
            or "n_bands" not in scene or "n_triangles" not in scene):
        return None
    s = tr.kernel_s(lambda n: "replay_pose_kernel" in n
                    or "replay_pose_bwd_kernel" in n) / tr.n_units
    if s <= 0.0:
        return None
    bound = sum(replay_pose_bytes.pair_bound_s(
        int(scene["n_bands"]), int(scene["n_triangles"]),
        int(r["replay_deposits"]), int(r["replay_steps"]))
        for r in recs) / len(recs)
    return 100.0 * bound / s
