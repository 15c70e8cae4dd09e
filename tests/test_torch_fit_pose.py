"""The pose replay pair (the replay that carries the emitter's tangents) and
the source localization's fit, on the CPU at test size.

The pair's plain version (``replay_cuda.replay_plain`` with the tangents
and ``replay_bwd_plain`` with the pose, what the CPU runs) against the eager
chain's autograd on the office at test size and on the box; the replay's
dispatch; ``fit_scene_parameters(fit_emitter=True, method="replay")`` over
three receivers held to the benchmark's float64 reference of it
(``perfbench/reference_fit_pose.py``) step by step, and each of the
benchmark's planted faults failing that comparison; the fit's counters.
"""
import functools
import inspect
import json

import numpy as np
import pytest
import torch

from audiorenderingv2_tpu_torch import diff
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch import tuned
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.core.tracer import scene_to_arrays
from audiorenderingv2_tpu_torch.diff import replay
from audiorenderingv2_tpu_torch.ops import _build
from audiorenderingv2_tpu_torch.ops import replay_cuda as rc
from audiorenderingv2_tpu_torch.utils import logging as arlog
from audiorenderingv2_tpu_torch.utils import profiling
from perfbench import calibrate_pose, harness, reference
from perfbench import reference_fit_pose as rfp

torch.set_num_threads(2)

CONFIG = harness.load_json("configs", "office_locate")
TRAFFIC = harness.load_json("traffic", "fit_pose")
RECEIVERS = np.asarray(CONFIG["receivers"], np.float64)
N_RAYS = 4096
SEED = 2**31 + 2903
TRACE = {"sample_rate": 16000, "ir_seconds": 2, "base_power": 3.62,
         "energy_threshold": 0.0, "max_bounces": 16,
         "hrtf_absorption_rate": 0.9}
START = np.array([0.35, -0.45, 0.6])   # 0.83 m from the true source
LR, STEPS, RADIUS = TRAFFIC["learning_rate"], 3, TRAFFIC["smooth_radius"]
# Tolerances of the fit against the float64 reference. At 16 bounces the
# float32 recording takes the float64 reference's paths (here), so the two
# differ by float32 rounding, mostly in where a deposit lands; the
# emitter's gradient, a sum of signed terms over every deposit's arrival and
# chord under the smoothed log loss, parts the most. Measured here: the loss
# 3.2e-7, the logit's gradient 1.9e-6 and change 3.9e-8, the emitter's
# gradient 4.9e-4 and change 2.0e-4 (relative L2). Each tolerance is fifteen
# times its reading or more; every planted fault reads 0.59 or more in the
# emitter's gradient (half the rays; the tangent faults 0.99 or more).
TOL = {"loss_gap": 3e-5, "grad_gap": 3e-5, "change_gap": 3e-6,
       "emitter_grad_gap": 2e-2, "emitter_change_gap": 3e-2}


def office_mesh():
    return reference.scene_mesh(dict(CONFIG["scene"], n_triangles_target=700))


def params(max_bounces: int = TRACE["max_bounces"]) -> TraceParams:
    return TraceParams(sample_rate=TRACE["sample_rate"],
                       ir_length=TRACE["ir_seconds"] * TRACE["sample_rate"],
                       base_power=TRACE["base_power"],
                       max_bounces=max_bounces,
                       hrtf_absorption_rate=TRACE["hrtf_absorption_rate"])


def directions(n: int = N_RAYS, seed: int = SEED) -> torch.Tensor:
    return reference.directions(n, reference.generator_from_seed(seed, "cpu"),
                                "cpu", torch.float32)


@functools.lru_cache(maxsize=None)
def recorded(scene: str):
    """(scene arrays, tri_ids, recv_step, directions) of the office at test
    size or the box, recorded from START for the first receiver; the
    box's receiver is its configuration's."""
    mesh = office_mesh() if scene == "office" else reference.box_mesh(
        harness.load_json("configs", "box")["scene"]["size"])
    rec = RECEIVERS[0] if scene == "office" else np.asarray(
        harness.load_json("configs", "box")["receiver"])
    p = params()
    opts, s2, clusters = tuned.prepare(tt.scene_from_arrays(*mesh, 0.3),
                                       p.max_bounces)
    sc = scene_to_arrays(s2, 128, device="cpu", clusters=clusters)
    d = directions()
    ids, recv = replay.record_paths_kernels(sc, d, START.astype(np.float32),
                                            rec.astype(np.float32), 30.0, p,
                                            opts)
    assert (recv >= 0).sum() > 30 and (recv == 0).any()
    return sc, ids, recv, d, rec


def _pair_and_chain(scene: str, dtype):
    """The pose pair's plain version and the chain's autograd on the same
    recorded paths in ``dtype``: [(events, emitter gradient, table
    gradient)] for each, under a seeded weighting of ev_bin and ev_w."""
    sc, ids, recv, d, rec = recorded(scene)
    gen = torch.Generator().manual_seed(7)
    a0 = (0.1 + 0.5 * torch.rand((sc.plane_d.shape[0], 1), generator=gen)
          ).to(dtype)
    wb = torch.randn(ids.shape[0], generator=gen).to(dtype)
    ww = torch.rand((ids.shape[0], 1), generator=gen).to(dtype)
    rows = [getattr(sc, f).to(dtype) for f in ("plane_n", "plane_d",
                                                "normal")]
    y = torch.deg2rad(torch.tensor(30.0, dtype=dtype))
    rec_t = torch.as_tensor(rec, dtype=dtype)
    e0 = TRACE["base_power"] / (N_RAYS * 4.18879020478)
    rate = TRACE["sample_rate"] / 343.0
    out = []
    for path in ("pair", "chain"):
        a = a0.clone().requires_grad_(True)
        em = torch.as_tensor(START, dtype=dtype).requires_grad_(True)
        if path == "pair":
            ev = rc.replay_pose_pair(
                a, em, ids, recv, d.to(dtype),
                torch.cat([rec_t, torch.sin(y)[None], torch.cos(y)[None]]),
                *rows, e0, rate)
        else:
            ev = rc.chain_events(*rows, a, ids, recv, d.to(dtype), em, rec_t,
                                 torch.sin(y), torch.cos(y), e0, rate)[:3]
        ((ev[0] * wb).sum() + (ev[1] * ww).sum()).backward()
        out.append(([x.detach() for x in ev], em.grad, a.grad))
    return out


@pytest.mark.parametrize("scene", ["office", "box"])
def test_plain_pose_pair_equals_chain_autograd(scene):
    """The events bit for bit in both precisions (the same arithmetic).
    The emitter's gradient in float64 to 1e-6 of the chain's autograd: the
    pair mirrors each ray's line by the triangle's unit normal where the
    chain follows the hit along its plane row, and the scene holds the two
    rounded to float32 apart (measured 3.2e-8 on the box and 4.9e-7 on the
    office, whose rows come from 1 m icospheres). The table's gradient as
    ``test_replay_plain_equals_chain``'s."""
    for dtype in (torch.float32, torch.float64):
        (ev_p, ge_p, ga_p), (ev_c, ge_c, ga_c) = _pair_and_chain(scene,
                                                                 dtype)
        for got, want in zip(ev_p, ev_c):
            assert got.dtype == want.dtype and torch.equal(got, want)
        assert ev_p[0].requires_grad is False
        rtol, atol = ((1e-12, 1e-14) if dtype == torch.float64
                      else (1e-5, 1e-6))
        torch.testing.assert_close(ga_p, ga_c, rtol=rtol,
                                   atol=atol * float(ga_c.abs().max()))
    assert float((ge_p - ge_c).norm() / ge_c.norm()) <= 1e-6
    assert float(ge_c.norm()) > 0 and torch.isfinite(ge_p).all()


@pytest.mark.parametrize("scene", ["office", "box"])
def test_float32_tangents_against_float64(scene):
    """Each deposit's tangents in float32 against float64 on the same
    paths. They scale as 1 / s (s the half chord), and s near a grazing
    entry is a difference of squares of the distance, 2e-5 or more of
    float32 rounding against an s^2 of 1e-4: the pair takes s again in
    float64 from the float32 position, so what is left is the position's
    own rounding, about 1e-6 m after a few bounces, which moves s^2 by
    about 2e-6. So every deposit holds to 5e-4 + 1e-5 / s^2 of its float64
    tangents (measured: 1.6e-4 at most where s is above 0.1; the box's
    most grazing deposit, s = 0.0027, 0.13 against 1.4 allowed), where the
    forward's s alone left 0.32 at s = 0.01 on the office (measured)."""
    sc, ids, recv, d, rec = recorded(scene)
    out = {}
    for dt in (torch.float32, torch.float64):
        scal = torch.cat([torch.as_tensor(START, dtype=dt),
                          torch.as_tensor(rec, dtype=dt),
                          torch.tensor([0.5, 0.75 ** 0.5], dtype=dt)])
        rows = [getattr(sc, f).to(dt) for f in ("plane_n", "plane_d",
                                                 "normal")]
        a = torch.full((sc.plane_d.shape[0], 1), 0.3, dtype=dt)
        out[dt] = rc.replay(ids, recv, d.to(dt), scal, *rows, a, 1e-4, 46.6,
                            pose=True)
    t32, t64 = out[torch.float32][4].double(), out[torch.float64][4]
    half = out[torch.float64][3] / 2
    dep = half > 0
    err = (t32 - t64).norm(dim=1)[dep] / t64.norm(dim=1)[dep]
    assert dep.sum() > 30 and bool((err <= 5e-4 + 1e-5 / half[dep] ** 2
                                    ).all()), float(err.max())


def test_pose_pair_without_a_table_gradient():
    """An emitter-only fit: the table needs no gradient, the backward
    skips it and the emitter's is the same."""
    sc, ids, recv, d, rec = recorded("office")
    scal = torch.cat([torch.as_tensor(START, dtype=torch.float32),
                      torch.as_tensor(rec, dtype=torch.float32),
                      torch.tensor([0.0, 1.0])])
    a0 = torch.full((sc.plane_d.shape[0], 1), 0.3)
    args = (ids, recv, d, scal, sc.plane_n, sc.plane_d, sc.normal, a0, 1e-4,
            46.6)
    ev_bin, ev_w, _, chord, tan = rc.replay(*args, pose=True)
    assert not tan[chord == 0].any() and tan[chord != 0].abs().sum() > 0
    g_bin = torch.randn(ids.shape[0])
    g_w = torch.rand((ids.shape[0], 1))
    both = rc.replay_bwd(ids, recv, chord, g_w, a0, 1e-4,
                         pose=(g_bin, ev_w, tan))
    alone = rc.replay_bwd(ids, recv, chord, g_w, a0, 1e-4,
                          pose=(g_bin, ev_w, tan), table=False)
    assert alone[0] is None and torch.equal(alone[1], both[1])
    assert torch.equal(both[0], rc.replay_bwd(ids, recv, chord, g_w, a0,
                                              1e-4))


@pytest.mark.parametrize("leaf", ["emitter", "absorption_and_emitter",
                                  "receiver", "yaw", "plane_d"])
def test_dispatch_takes_the_pose_pair_for_the_emitter_alone(monkeypatch,
                                                           leaf):
    """The emitter alone (with or without the table) takes the pose pair
    under ``ar2.replay.kernel``, and ev_bin carries its gradient; the
    receiver, the yaw or a triangle row takes the chain under
    ``ar2.replay.chain``, with the emitter requiring a gradient too."""
    sc, ids, recv, d, rec = recorded("office")
    em = torch.as_tensor(START, dtype=torch.float32).requires_grad_(True)
    rec_t = torch.as_tensor(rec, dtype=torch.float32)
    yaw = torch.tensor(30.0)
    if leaf == "absorption_and_emitter":
        sc = sc._replace(absorption=sc.absorption.clone().requires_grad_())
    elif leaf == "receiver":
        rec_t.requires_grad_(True)
    elif leaf == "yaw":
        yaw.requires_grad_(True)
    elif leaf == "plane_d":
        sc = sc._replace(plane_d=sc.plane_d.clone().requires_grad_(True))
    calls = []
    for name in ("chain_events", "replay_absorption", "replay_pose_pair"):
        def spy(*a, _fn=getattr(rc, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(rc, name, spy)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ev = replay.replay_events(sc, ids, recv, d, em, rec_t, yaw, params())
    pose = leaf in ("emitter", "absorption_and_emitter")
    assert calls[0] == ("replay_pose_pair" if pose else "chain_events")
    assert "replay_absorption" not in calls
    spans = {e.name for e in prof.events() if e.name.startswith("ar2.")}
    assert spans == {"ar2.replay.kernel" if pose else "ar2.replay.chain"}
    assert ev[0].requires_grad and ev[1].requires_grad
    ev[0].sum().backward()
    assert em.grad is not None and em.grad.abs().sum() > 0


def test_pose_kernels_are_declared_and_launched():
    """The replay's two C entries take the pose's own arguments (``tan``,
    and the backward's ``g_bin``, ``ev_w``, ``tan`` and ``grad_e``), which
    _build's signatures declare, and their wrappers launch them; the
    kernels, absorption and pose, keep their names."""
    cu = (_build.CSRC / "replay.cu").read_text()
    for entry, fn, n_args in (("ar2_replay", rc.replay, 23),
                              ("ar2_replay_bwd", rc.replay_bwd, 16)):
        assert f'extern "C" int {entry}(' in cu
        assert len(_build._SIGNATURES[entry]) == n_args
        assert f".{entry}(" in inspect.getsource(fn)
    assert "ar2_replay_pose" not in cu
    for name in ("replay_kernel(", "replay_bwd_kernel(", "replay_pose_kernel(",
                 "replay_pose_bwd_kernel("):
        assert f"\n{name}" in cu


@pytest.mark.parametrize("bad", ["g_bin", "tan", "meta"])
def test_pose_bwd_rejects(bad):
    ids = torch.zeros((64, 6), dtype=torch.int32)
    recv = torch.zeros(64, dtype=torch.int32)
    pose = dict(g_bin=torch.zeros(64), ev_w=torch.zeros((64, 1)),
                tan=torch.zeros((64, 6)))
    args = dict(tri_ids=ids, recv_step=recv, chord=torch.zeros(64),
                g=torch.zeros((64, 1)), absorb=torch.zeros((10, 1)), e0=1.0)
    if bad == "meta":
        args = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}
        pose = {k: v.to("meta") for k, v in pose.items()}
        with pytest.raises(ValueError, match="no replay kernel"):
            rc.replay_bwd(**args, pose=tuple(pose.values()))
        return
    pose[bad] = pose[bad][:-1]
    with pytest.raises(ValueError, match="replay_bwd needs"):
        rc.replay_bwd(**args, pose=tuple(pose.values()))


# --------------------------------------------------- the localization's fit

@functools.lru_cache(maxsize=None)
def fit_case():
    """(the office at test size as the program's scene, its mesh, the
    directions, the targets [3, 2, bins]): the traffic's targets, drawn as
    its driver draws them."""
    mesh = office_mesh()
    rng = np.random.default_rng([SEED, 6])
    sr, nb = TRACE["sample_rate"], TRACE["ir_seconds"] * TRACE["sample_rate"]
    dist = np.linalg.norm(RECEIVERS, axis=1)
    time_s = np.arange(nb) / sr
    env = np.where(time_s[None] >= (dist / 343.0)[:, None], np.exp(
        -np.maximum(time_s[None] - (dist / 343.0)[:, None], 0.0) / 0.2), 0.0)
    target = (2e-5 * (dist[0] / dist)[:, None, None] ** 2 * env[:, None]
              * rng.uniform(0.0, 1.0, (3, 2, nb))).astype(np.float32)
    return (tt.scene_from_arrays(*mesh, 0.3), mesh, directions(),
            torch.as_tensor(target))


def program_fit():
    """3 steps of the port's localization: [(loss, the material logit's
    gradient, the logit, the emitter's gradient, the emitter)]."""
    scene, _, dirs, target = fit_case()
    seen = []

    def keep(i, loss, theta):
        a, e = theta["absorption_logits"], theta["emitter"]
        seen.append((loss, float(a.grad[0]), float(a.detach()[0]),
                     e.grad.clone(), e.detach().clone()))

    diff.fit_scene_parameters(
        scene, target, params(), n_rays=N_RAYS, fit_absorption=True,
        fit_emitter=True, init_emitter=START.astype(np.float32),
        receiver_pos=RECEIVERS.astype(np.float32), init_absorption=0.5,
        steps=STEPS, learning_rate=LR, smooth_radius=RADIUS,
        method="replay", device="cpu", directions=dirs, callback=keep)
    return seen


@functools.lru_cache(maxsize=None)
def reference_fit():
    _, mesh, dirs, target = fit_case()
    geo = reference.Geometry(*mesh, 0.3, "cpu", torch.float64)
    d = dirs.double()
    paths = [rfp.trace_paths(geo, d, START, r, TRACE) for r in RECEIVERS]
    assert all(p["ray"].numel() > 50 for p in paths)
    return rfp.fit_steps(geo, paths, d, RECEIVERS, 0.0, target.double(),
                         TRACE, N_RAYS, 0.5, START, LR, STEPS, RADIUS)


def gaps(got) -> dict:
    from perfbench.drivers import fit_pose

    return fit_pose.Driver.judge(got, reference_fit(), 0.5, START)


def test_fit_matches_the_reference_step_by_step():
    got = program_fit()
    d = gaps(got)
    print(d)
    assert all(d[k] <= TOL[k] for k in TOL), d
    # The fit moves the emitter and the absorption, by lr on the first step.
    assert np.allclose(np.abs(got[0][4].numpy() - START), LR, rtol=1e-3)


@pytest.mark.parametrize("fault", calibrate_pose.FAULTS)
def test_planted_faults_fail(fault):
    """The benchmark's planted faults, each in the program: the Jacobian
    left at the identity, the chord's tangent dropped, the receiver entry's
    tangent dropped (each through the pair's plain version, as
    ``perfbench.calibrate_pose`` plants them on the card) and half of the
    rays with the energy spread over them."""
    class Holder:
        def _fit(self, dirs):
            return dirs

    holder = Holder()
    with calibrate_pose.planted(holder, fault):
        if fault == "half":
            scene, _, dirs, target = fit_case()
            seen = []
            diff.fit_scene_parameters(
                scene, target, params(), n_rays=N_RAYS // 2,
                fit_absorption=True, fit_emitter=True,
                init_emitter=START.astype(np.float32),
                receiver_pos=RECEIVERS.astype(np.float32),
                init_absorption=0.5, steps=STEPS, learning_rate=LR,
                smooth_radius=RADIUS, method="replay", device="cpu",
                directions=holder._fit(dirs),
                callback=lambda i, loss, th: seen.append((
                    loss, float(th["absorption_logits"].grad[0]),
                    float(th["absorption_logits"][0]),
                    th["emitter"].grad.clone(),
                    th["emitter"].detach().clone())))
            got = seen
        else:
            got = program_fit()
    d = gaps(got)
    print(fault, d)
    assert d["emitter_grad_gap"] >= 0.5, d
    assert any(d[k] > TOL[k] for k in TOL), d


def test_fit_record_counts_receivers_and_the_pose(tmp_path):
    """Traced, each recording's ``fit_record`` counts the three receivers'
    path sets and the pose pair; untraced, nothing is written."""
    scene, _, dirs, target = fit_case()
    for traced in (True, False):
        path = tmp_path / f"events{int(traced)}.jsonl"
        arlog.configure(path=str(path))
        try:
            run = lambda: diff.fit_scene_parameters(  # noqa: E731
                scene, target, params(8), n_rays=1024, fit_emitter=True,
                init_emitter=START.astype(np.float32),
                receiver_pos=RECEIVERS.astype(np.float32), steps=2,
                learning_rate=LR, method="replay", device="cpu",
                directions=dirs[:1024])
            if traced:
                with profiling.trace(str(tmp_path / "tr"), device="cpu"):
                    run()
            else:
                run()
        finally:
            arlog.configure()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        fit = [r for r in recs if r.get("event") == "fit_record"]
        if not traced:
            assert not fit
            continue
        assert len(fit) == 1 and fit[0]["step"] == 0, fit
        assert fit[0]["replay_receivers"] == 3 and fit[0]["replay_pose"] == 1
        assert fit[0]["replay_deposits"] > 0
