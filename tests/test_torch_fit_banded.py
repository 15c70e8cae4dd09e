"""The port's banded material fit held to the benchmark's float64
reference of it (``perfbench/reference_fit_banded.py``), entry by entry.

A small furnished office (the benchmark's office mesh at about 1,000
triangles, so that ``tuned.prepare`` clusters it and the recording runs
through the schedule and K2) with the octave office's four materials, a
seeded random ``[5, B]`` starting table and a seeded random banded target.
``diff.fit_scene_parameters(method="replay")`` runs 3 steps on the CPU at
4,096 rays and 16 bounces, 48 kHz; the reference traces the same
directions in float64 and runs its own Adam. Compared: each step's loss,
each entry of the first gradient and each logit's change after 3 steps.
Planted faults each fail the comparison: the table's bands reversed, one
band's gradient scaled by 1.5, two materials swapped, half of the rays at
twice the energy. The same banded fit held to the JAX package's on shared
directions. The fit's counters.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.core import tracer as j_tracer
from audiorenderingv2_tpu.diff import inverse as j_inverse
from audiorenderingv2_tpu.diff import replay as j_replay
from audiorenderingv2_tpu.scene import build_scene as j_build_scene
from audiorenderingv2_tpu_torch import diff
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.diff import inverse, replay
from audiorenderingv2_tpu_torch.ops import replay_cuda
from audiorenderingv2_tpu_torch.scene import build_scene
from audiorenderingv2_tpu_torch.utils import logging as arlog
from audiorenderingv2_tpu_torch.utils import profiling
from perfbench import harness, reference
from perfbench import reference_banded as banded
from perfbench import reference_fit_banded as rfb

torch.set_num_threads(2)

CONFIG = harness.load_json("configs", "office_octave_fit")
N_RAYS = 4096
N_SLOTS = len(CONFIG["materials"]) + 1
SEED = 2**31 + 2617
TRACE = {"sample_rate": 48000, "ir_seconds": 1, "base_power": 3.62,
         "energy_threshold": 0.0, "max_bounces": 16,
         "hrtf_absorption_rate": 0.9}
RECEIVER, YAW = [6.0, 1.0, -8.0], 30.0
LR, STEPS = 0.05, 3
# Tolerances. At 16 bounces every ray takes the same triangles in float32
# as in float64, so the sound program differs from the reference by float32
# rounding alone, mostly in where a deposit lands: its arrival, about 3e4
# bins into the IR at 48 kHz, is summed in float32 over up to 16 legs and
# rounds to about 1e-3 of a bin, which moves that share of its energy to
# the other bin of its split. Measured here: the loss 3.2e-6 (1 band) and
# 3.1e-5 (8 bands: the log loss weighs a deposit most in the upper bands,
# whose target lies lowest); a gradient entry 1.4e-4 and 1.0e-3 of its
# band's largest; a logit's change after 3 steps 1.6e-5 and 2.8e-5 of the
# largest change. Each tolerance is ten times the larger reading. Every
# planted fault reads 1.2e-3 or more in the loss, 2.1e-2 or more in the
# gradient or 1.4e-2 in the change: 4 to 40 times its tolerance.
LOSS_TOL = 3e-4
GRAD_TOL = 1e-2
CHANGE_TOL = 3e-4
FAULTS = [(8, "bands_reversed"), (8, "band_grad_scaled"),
          (8, "materials_swapped"), (8, "half_rays"),
          (1, "band_grad_scaled"), (1, "materials_swapped"),
          (1, "half_rays")]


def small_office():
    spec = dict(CONFIG["scene"], n_triangles_target=1000)
    return reference.scene_mesh(spec)


def case(n_bands: int):
    """(mesh, material ids, the program's scene, starting table [5, B],
    target [2, B, bins], directions): the octave office's materials in
    their first ``n_bands`` bands, a random start and a random target."""
    mesh = small_office()
    materials = {k: v[:n_bands] for k, v in CONFIG["materials"].items()}
    table = banded.material_table(*mesh, materials)
    ids = rfb.material_ids(*mesh, materials)
    scene = build_scene(tt.mesh_from_arrays(
        *mesh, tri_material=ids.astype(np.int32),
        material_names=list(materials)), table)
    rng = np.random.default_rng([SEED, n_bands])
    init = rng.uniform(0.05, 0.6, (N_SLOTS, n_bands)).astype(np.float32)
    # Each band its own level and decay, so that no two bands can stand in
    # for each other.
    nb = TRACE["ir_seconds"] * TRACE["sample_rate"]
    band = np.arange(n_bands)[:, None]
    env = 2e-5 * 0.5 ** band * np.exp(
        -np.arange(nb) / (0.1 * 0.7 ** band * TRACE["sample_rate"]))
    target = (env * rng.uniform(0.0, 1.0, (2, n_bands, nb))).astype(
        np.float32)
    dirs = reference.directions(N_RAYS, reference.generator_from_seed(
        SEED, "cpu"), "cpu")
    return mesh, ids, scene, init, torch.as_tensor(target), dirs


def program_fit(scene, init, target, dirs):
    """3 steps of the port's replay fit: [(loss, gradient, logits)]."""
    n_bands = target.shape[1]
    params = TraceParams(
        sample_rate=TRACE["sample_rate"],
        ir_length=TRACE["ir_seconds"] * TRACE["sample_rate"],
        base_power=TRACE["base_power"], max_bounces=TRACE["max_bounces"],
        hrtf_absorption_rate=TRACE["hrtf_absorption_rate"], n_bands=n_bands)
    seen = []

    def keep(i, loss, theta):
        p = theta["absorption_logits"]
        seen.append((loss, p.grad.detach().clone().reshape(N_SLOTS, -1),
                     p.detach().clone().reshape(N_SLOTS, -1)))

    diff.fit_scene_parameters(
        scene, target if n_bands > 1 else target[:, 0], params,
        n_rays=dirs.shape[0], init_emitter=(0.0, 0.0, 0.0),
        receiver_pos=RECEIVER, receiver_yaw_deg=YAW,
        init_absorption=init if n_bands > 1 else init[:, 0], steps=STEPS,
        learning_rate=LR, method="replay", device="cpu",
        directions=dirs.float(), callback=keep)
    return seen


@functools.lru_cache(maxsize=None)
def banded_case(n_bands: int):
    """``case(n_bands)`` and the reference's 3 steps on it."""
    mesh, ids, scene, init, target, dirs = case(n_bands)
    deps, steps = rfb.trace_deposits(*mesh, ids, dirs, [0.0, 0.0, 0.0],
                                     RECEIVER, YAW, TRACE, N_SLOTS)
    assert steps > N_RAYS and sum(d[0].numel() for d in deps) > 50
    ref = rfb.fit_steps(deps, target.double(), TRACE, N_RAYS, init, LR,
                        STEPS, N_SLOTS)
    return scene, init, target, dirs, ref


def gaps(got, ref, init) -> dict:
    """The worst relative gaps: a step's loss; a first-gradient entry, of
    its band's largest; a logit's change, of the largest change."""
    theta0_p = torch.logit(torch.as_tensor(init))
    theta0_r = torch.logit(torch.as_tensor(init, dtype=torch.float64))
    g, r = got[0][1].double(), ref[0][1]
    dp = got[-1][2].double() - theta0_p.double()
    dr = ref[-1][2] - theta0_r
    return {
        "loss": max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref)),
        "grad": float(((g - r).abs() / r.abs().amax(0)).max()),
        "change": float((dp - dr).abs().max() / dr.abs().max())}


def within(d: dict) -> bool:
    return (d["loss"] <= LOSS_TOL and d["grad"] <= GRAD_TOL
            and d["change"] <= CHANGE_TOL)


@pytest.mark.parametrize("n_bands", [1, 8])
def test_port_matches_the_reference_entry_by_entry(n_bands):
    scene, init, target, dirs, ref = banded_case(n_bands)
    got = program_fit(scene, init, target, dirs)
    assert len(got) == STEPS and got[0][1].shape == (N_SLOTS, n_bands)
    # The no-material slot: no triangle has it, so no gradient on either
    # side.
    assert float(got[0][1][-1].abs().max()) == 0.0
    assert float(ref[0][1][-1].abs().max()) == 0.0
    assert all(float(r[1][:-1].abs().min()) > 0 for r in ref)
    d = gaps(got, ref, init)
    assert within(d), d


def _plant(kind, n_bands, monkeypatch):
    if kind == "bands_reversed":
        real = inverse.with_material_absorption
        monkeypatch.setattr(inverse, "with_material_absorption",
                            lambda sc, ids, t: real(sc, ids, t.flip(-1)))
    elif kind == "band_grad_scaled":
        real = replay_cuda.replay_bwd

        def scaled(*a, **k):
            grad = real(*a, **k)
            grad[:, n_bands // 2] *= 1.5
            return grad
        monkeypatch.setattr(replay_cuda, "replay_bwd", scaled)
    elif kind == "materials_swapped":
        real = inverse.material_ids_padded

        def swapped(scene, t_padded):
            ids = real(scene, t_padded)
            return torch.where(ids == 0, 1, torch.where(ids == 1, 0, ids))
        monkeypatch.setattr(inverse, "material_ids_padded", swapped)


@pytest.mark.parametrize("n_bands,kind", FAULTS)
def test_planted_faults_fail(n_bands, kind, monkeypatch):
    scene, init, target, dirs, ref = banded_case(n_bands)
    _plant(kind, n_bands, monkeypatch)
    if kind == "half_rays":
        dirs = dirs[:N_RAYS // 2]
    d = gaps(program_fit(scene, init, target, dirs), ref, init)
    assert not within(d), d


# ------------------------------------------------------ against JAX

# The JAX package fits the same [n_materials + 1, n_bands] table. Both
# sides get JAX's directions and record the same paths (every ray's
# recv_step equal at 4 and 8 bands), so they differ by float32 rounding
# alone, and JAX's replay rounds the larger share: against the float64
# reference on these directions JAX's first gradient reads 5.4e-3 (8
# bands) and 7.1e-3 (4 bands) of its band's largest, the port's 3.6e-4
# and 5.5e-4, mostly where an arrival splits between two bins. Measured
# port against JAX: the loss 1.1e-5 and 8.0e-6, a gradient entry 5.6e-3
# and 6.9e-3 of its band's largest, a logit's change after 3 steps
# 2.7e-4 and 2.3e-4 of the largest change. Each tolerance is three to ten
# times the larger reading; a band's gradient scaled by 1.5 reads 0.3 or
# more.
JAX_SEED = 7
JAX_LOSS_TOL = 1e-4
JAX_GRAD_TOL = 2e-2
JAX_CHANGE_TOL = 3e-3


@functools.lru_cache(maxsize=None)
def jax_case(n_bands: int):
    """``case(n_bands)`` with JAX's directions, the JAX package's 3 steps
    on it and its gradient at the start: (scene, start, target,
    directions, [loss], [logits after each step], first gradient)."""
    mesh, ids, scene, init, target, _ = case(n_bands)
    materials = {k: v[:n_bands] for k, v in CONFIG["materials"].items()}
    j_scene = j_build_scene(jt.mesh_from_arrays(
        *mesh, tri_material=ids.astype(np.int32),
        material_names=list(materials)), banded.material_table(
            *mesh, materials))
    params = ar.TraceParams(
        sample_rate=TRACE["sample_rate"],
        ir_length=TRACE["ir_seconds"] * TRACE["sample_rate"],
        base_power=TRACE["base_power"], max_bounces=TRACE["max_bounces"],
        hrtf_absorption_rate=TRACE["hrtf_absorption_rate"], n_bands=n_bands)
    opts = ar.TracerOptions(block_size=512, tri_chunk=256)
    target_j = jnp.asarray(target.numpy())
    logits = []
    res = j_inverse.fit_scene_parameters(
        j_scene, target_j, params, n_rays=N_RAYS, steps=STEPS,
        learning_rate=LR, receiver_pos=RECEIVER, receiver_yaw_deg=YAW,
        init_absorption=init, seed=JAX_SEED, opts=opts, method="replay",
        callback=lambda i, loss, th: logits.append(
            np.asarray(th["absorption_logits"])))
    # The gradient of the fit's first step, from the JAX package's own
    # pieces as its fit composes them: the paths recorded at the start,
    # the table gathered per triangle, the soft replay and the log loss.
    dirs = j_sampling.sample_directions(jax.random.PRNGKey(JAX_SEED),
                                        N_RAYS)
    opts = j_inverse._diff_opts(opts)
    sc = j_tracer.scene_to_arrays(j_scene, opts.tri_chunk)
    mat_ids = j_inverse.material_ids_padded(j_scene, sc.absorption.shape[0])
    theta0 = jnp.asarray(np.log(init / (1.0 - init)), jnp.float32)
    rec = jnp.asarray(RECEIVER, jnp.float32)
    paths = j_replay.record_paths(
        j_inverse.with_material_absorption(sc, mat_ids,
                                           jax.nn.sigmoid(theta0)),
        dirs, jnp.zeros(3), rec, YAW, params, opts)

    def loss(theta):
        sc_t = j_inverse.with_material_absorption(sc, mat_ids,
                                                  jax.nn.sigmoid(theta))
        ir = j_replay.render_ir_replay(sc_t, *paths, dirs, jnp.zeros(3),
                                       rec, YAW, params, soft_binning=True)
        return j_inverse.ir_loss(ir, target_j, "log", 0)

    grad = np.asarray(jax.grad(loss)(theta0))
    return (scene, init, target, torch.as_tensor(np.array(dirs)),
            list(res.losses), logits, grad)


@pytest.mark.parametrize("n_bands", [4, 8])
def test_port_tracks_the_jax_banded_fit(n_bands):
    scene, init, target, dirs, losses, logits, grad = jax_case(n_bands)
    got = program_fit(scene, init, target, dirs)
    assert grad.shape == (N_SLOTS, n_bands) and len(logits) == STEPS
    assert max(abs(g[0] - j) / abs(j) for g, j in zip(got, losses)) \
        <= JAX_LOSS_TOL
    g = got[0][1].numpy()
    assert float(np.abs(grad[-1]).max()) == 0.0
    assert float((np.abs(g - grad) / np.abs(grad).max(0)).max()) \
        <= JAX_GRAD_TOL
    theta0 = np.log(init / (1.0 - init))
    for (_, _, p), q in zip(got, logits):
        dp, dq = p.numpy() - theta0, q - theta0
        assert float(np.abs(dp - dq).max() / np.abs(dq).max()) \
            <= JAX_CHANGE_TOL


# ------------------------------------------------------------ counters


def _fit_traced(tmp_path, traced: bool):
    _, _, scene, init, target, dirs = case(8)
    log = tmp_path / "events.jsonl"
    arlog.configure(path=str(log))
    try:
        if traced:
            with profiling.trace(str(tmp_path / "prof"), device="cpu"):
                program_fit(scene, init, target, dirs)
        else:
            program_fit(scene, init, target, dirs)
    finally:
        arlog.configure()
    return [json.loads(x) for x in log.read_text().splitlines()]


def test_fit_record_counts_the_replays_work(tmp_path):
    """Traced, one ``fit_record`` a recording whose counters are the
    recorded paths': the depositing rays and their steps up to
    ``recv_step``, one receiver's path set, no pose replay, and nothing
    else."""
    recs = _fit_traced(tmp_path, traced=True)
    fit = [r for r in recs if r["event"] == "fit_record"]
    assert len(fit) == 1 and fit[0]["step"] == 0
    _, _, scene, _, _, dirs = case(8)
    from audiorenderingv2_tpu_torch import tuned
    from audiorenderingv2_tpu_torch.core.tracer import scene_to_arrays

    params = TraceParams(sample_rate=48000, ir_length=48000, base_power=3.62,
                         max_bounces=16, n_bands=8)
    opts, s2, clusters = tuned.prepare(scene, params.max_bounces)
    sc = scene_to_arrays(s2, 128, device="cpu", clusters=clusters)
    ids, recv = replay.record_paths_kernels(
        sc, dirs.float(), (0.0, 0.0, 0.0), RECEIVER, YAW, params, opts)
    dep = recv[recv >= 0].long()
    assert set(fit[0]) - {"ts", "event", "step"} == {
        "replay_deposits", "replay_steps", "replay_receivers", "replay_pose"}
    assert fit[0]["replay_receivers"] == 1 and fit[0]["replay_pose"] == 0
    assert fit[0]["replay_deposits"] == dep.numel() > 50
    assert fit[0]["replay_steps"] == int(dep.sum())
    # Every step before a deposit left a surface.
    assert int((ids[recv >= 0] >= 0).sum()) == int(dep.sum())


def test_untraced_fit_counts_nothing(tmp_path, monkeypatch):
    """Untraced, no counter's callable runs, ``recv_step`` is not copied
    and no ``fit_record`` is written."""
    real = profiling.count

    def guarded(name, fn, **kw):
        def refuse():
            raise AssertionError(f"counter {name} computed untraced")
        return real(name, refuse, **kw)

    monkeypatch.setattr(profiling, "count", guarded)
    recs = _fit_traced(tmp_path, traced=False)
    assert not [r for r in recs if r["event"] == "fit_record"]
