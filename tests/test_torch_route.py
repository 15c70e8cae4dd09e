"""The route table: which kernel every trace entry runs, for each
combination of the options that pick one, on a clustered scene or not, at
one band or three.

``core.tracer.trace_route`` decides; this test records, on CPU tensors,
which kernel wrapper each entry actually calls (the wrappers are
monkeypatched to record, then run their plain versions), holds every entry
to the one table below, and every refused combination to the error text
its entry raises. The entries: ``trace_ir``, ``render_ir`` with and
without ``native_rng``, ``render_ir_pose_batch``, ``render_ir_matrix``
fused (``pair_batch=2``) and pair by pair (``pair_batch=1``), and
``diff.record_paths_kernels``.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from audiorenderingv2_tpu_torch import accel, diff, multi
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.ops import group_cuda, schedule_cuda
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.ops import traverse_cuda, v1_cuda

torch.set_num_threads(1)

N_RAYS = 128
REC = np.array([1.0, 0.5, -1.0], np.float32)

# wrapper -> (module, attribute, index of its scalar row argument)
WRAPPERS = {
    "k1": (rc, "trace_round", 2),
    "k6": (group_cuda, "trace_round_group", 3),
    "k7": (v1_cuda, "trace_round_v1", 2),
    "sched": (schedule_cuda, "trace_round_sched", 4),
    "k5": (traverse_cuda, "trace_traverse", 3),
    "k4": (rc, "init_state_native", None),
    "autograd": (tracer, "_trace_events_autograd", None),
}

GROUP_BOXES = "group layout cannot carry cluster boxes"
FORWARD_ONLY = "runs the forward-only kernels; it has no backend='autograd'"
SOFT = "render_ir_pose_batch is a forward-rendering path"
VERSION_2 = "render_ir_pose_batch requires the kernels backend with version=2"
NEEDS_SCHEDULE = "pose-batched tracing on clustered scenes requires schedule"


def table(backend, version, layout, schedule, clustered, n_bands):
    """The route of the options: a kernel name, or the error text."""
    if backend == "autograd":
        return "autograd"
    if version == 1:
        return "autograd" if n_bands > 1 else "k7"
    if layout == "group":
        return GROUP_BOXES if clustered else "k6"
    if not clustered:
        return "k1"
    return "sched" if schedule else "k5"


def _scene(clustered: bool, n_bands: int):
    """A 12-triangle box, or a 1,280-triangle icosphere sorted into
    clusters of 32, at ``n_bands`` absorption bands."""
    v, t = (tt.icosphere(radius=6.0, subdivisions=3) if clustered
            else tt.box_room((4.0, 3.0, 3.0)))
    absorb = (0.3 if n_bands == 1 else
              np.tile(np.linspace(0.1, 0.7, n_bands, dtype=np.float32),
                      (len(t), 1)))
    scene = tt.scene_from_arrays(v, t, absorb)
    clusters = None
    if clustered:
        scene, clusters = accel.prepare_scene(scene, cluster_size=32)
    return tracer.scene_to_arrays(scene, 128, device="cpu",
                                  clusters=clusters)


SCENES = {(c, b): _scene(c, b) for c in (False, True) for b in (1, 3)}


def _recording(monkeypatch):
    """The wrappers' calls, as (kernel, posed) in order."""
    calls = []
    for name, (module, attr, scal_at) in WRAPPERS.items():
        real = getattr(module, attr)

        def wrapped(*a, _real=real, _name=name, _at=scal_at, **k):
            posed = _at is not None and a[_at].dim() == 2
            calls.append((_name, posed))
            return _real(*a, **k)

        monkeypatch.setattr(module, attr, wrapped)
    return calls


def _entries(sc, params, opts):
    """Each entry as a call of no argument."""
    dirs = torch.randn(N_RAYS, 3, generator=torch.Generator().manual_seed(1))
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    native = dataclasses.replace(opts, native_rng=True)
    poses = (np.zeros((1, 3), np.float32), np.stack([REC, -REC]), [0.0, 90.0])

    def render(o):
        return lambda: tracer.render_ir(sc, torch.Generator().manual_seed(2),
                                        N_RAYS, np.zeros(3), REC, 30.0,
                                        params, o)

    return {
        "trace_ir": lambda: tracer.trace_ir(sc, dirs, np.zeros(3), REC, 30.0,
                                            params, opts),
        "render_ir": render(opts),
        "render_ir_native": render(native),
        "pose_batch": lambda: tracer.render_ir_pose_batch(
            sc, 3, N_RAYS, np.zeros((2, 3)), np.stack([REC, -REC]),
            np.array([0.0, 90.0]), params, opts),
        "matrix_fused": lambda: multi.render_ir_matrix(
            sc, 3, *poses, N_RAYS, params, opts, pair_batch=2),
        "matrix_pairs": lambda: multi.render_ir_matrix(
            sc, 3, *poses, N_RAYS, params, opts, pair_batch=1),
        "record": lambda: diff.record_paths_kernels(
            sc, dirs, np.zeros(3), REC, 30.0, params, opts),
    }


def _expected(entry, route, backend, version, layout, schedule, soft,
              clustered, n_bands):
    """(kernel, posed) the entry calls, or the error text it raises."""
    if entry == "record":  # version 2's kernels whatever the options say
        return table("kernels", 2, layout, schedule, clustered, n_bands), False
    if entry == "pose_batch":
        if backend == "autograd":
            return FORWARD_ONLY, None
        if soft:
            return SOFT, None
        if version == 1:
            return VERSION_2, None
        if route == "k5":
            return NEEDS_SCHEDULE, None
        return route, True
    if entry == "render_ir_native":
        if backend == "autograd" and version == 2:
            return FORWARD_ONLY, None
        if route in ("k1", "k6", "sched", "k5"):
            return "k4+" + route, False
    if entry == "matrix_fused" and route in ("k1", "k6", "sched") \
            and not soft:
        return route, True
    return route, False


GRID = list(itertools.product(("kernels", "autograd"), (2, 1),
                              ("rows", "group"), (False, True),
                              (False, True), (False, True), (1, 3)))


@pytest.mark.parametrize(
    "backend,version,layout,schedule,soft,clustered,n_bands", GRID,
    ids=["-".join(map(str, g)) for g in GRID])
def test_every_entry_takes_the_route_of_the_table(
        monkeypatch, backend, version, layout, schedule, soft, clustered,
        n_bands):
    opts = tracer.TracerOptions(backend=backend, version=version,
                                layout=layout, schedule=schedule,
                                soft_binning=soft, block_size=256,
                                tri_chunk=128)
    params = TraceParams(sample_rate=8000, ir_length=800, base_power=3.62,
                         max_bounces=2, n_bands=n_bands)
    sc = SCENES[(clustered, n_bands)]
    route = table(backend, version, layout, schedule, clustered, n_bands)
    if route == GROUP_BOXES:
        with pytest.raises(ValueError, match=GROUP_BOXES):
            tracer.trace_route(opts, n_bands, clustered)
    elif route == "autograd":
        assert tracer.trace_route(opts, n_bands, clustered) is None
    else:
        assert tracer.trace_route(opts, n_bands, clustered).kernel == route
    calls = _recording(monkeypatch)
    for entry, run in _entries(sc, params, opts).items():
        want, posed = _expected(entry, route, backend, version, layout,
                                schedule, soft, clustered, n_bands)
        del calls[:]
        if posed is None or want == GROUP_BOXES:
            with pytest.raises(ValueError, match=want):
                run()
            continue
        out = run()
        kernels = sorted({name for name, _ in calls})
        got = "+".join(kernels) if "k4" not in kernels else \
            "k4+" + "".join(k for k in kernels if k != "k4")
        assert got == want, (entry, calls)
        assert {p for _, p in calls} == {posed}, (entry, calls)
        if entry != "record":
            assert np.isfinite(np.asarray(out)).all()
