"""Each cell rehearsed at a tiny size on the CPU through the program's
plain versions, its check against the control and the planted faults, and
the reference against the program's CPU path.

The rehearsals skip the harness's look for a card (``run.run_cell`` with
``device="cpu"``) and cut the rays (and the office's spheres); everything
else is the cell as the benchmark runs it. ``test_cell_on_card`` runs the
real command and skips without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness, reference
from perfbench.run import run_cell

M = harness.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
SEED = 2**31 + 977


# The fit's limits were set from readings at 1M rays. At the test's 1,024
# rays on two icospheres its sound gaps read up to 2.7e-6 (loss), 5.5e-3
# (gradient) and 4.5e-4 (change), so the test holds it to limits ten times
# those; its control and faults read 3e-3 to 1 (gradient 0.4 to 1.6).
TEST_LIMITS = {"office.fit": {"loss_gap": 1e-4, "grad_gap": 5e-2,
                              "change_gap": 5e-3}}


def tiny(name: str) -> "harness.Cell":
    cell = harness.cell_from_manifest(M, name)
    cell.config["rays"] = 1024
    if cell.config["scene"]["kind"] == "office":
        cell.config["scene"]["n_triangles_target"] = 700
    cell.limits.update(TEST_LIMITS.get(name, {}))
    return cell


def quiet(_line):
    pass


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name, trace):
    cell = tiny(name)
    out, checks = run_cell(cell, SEED, 0.5, bool(trace), "cpu", log=quiet)
    assert out["correct"], checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(checks) == set(cell.limits)
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # Nothing ran on a device here: the device's readers read nothing.
        assert all(m["source"] != "device_trace" or m["name"] not in
                   out["metrics"] for m in cell.per_layer)
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference in bfloat16 in the program's place is not correct."""
    cell = tiny(name)
    d = cell.driver.Driver(cell, "cpu", log=quiet)
    d.setup(SEED)
    d.begin(SEED)
    harness.run_window(d, 0.2)
    got = d.check(control=torch.bfloat16)
    assert any(v > cell.limits[n] for n, v in got.items()), got


def _render_ir_fault(kind):
    """A wrapper of the tracer's ``render_ir`` with a fault planted."""
    from audiorenderingv2_tpu_torch.core import tracer

    orig = tracer.render_ir
    first = []

    def faulty(sc, generator, n_rays, *args, **kw):
        if kind == "unchanged":
            ir = orig(sc, generator, n_rays, *args, **kw)
            first.append(ir)
            return first[0]
        if kind == "half":
            return orig(sc, generator, n_rays // 2, *args, **kw)
        ir = orig(sc, generator, n_rays, *args, **kw)
        ir[1] *= 1.5  # one ear altered where it is produced
        return ir
    return faulty


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith(".walk")])
def test_walk_faults_are_caught(name, kind, monkeypatch):
    from audiorenderingv2_tpu_torch import renderer

    monkeypatch.setattr(renderer, "render_ir", _render_ir_fault(kind))
    out, checks = run_cell(tiny(name), SEED, 0.3, False, "cpu", log=quiet)
    assert not out["correct"], checks


def test_walk_output_fault_is_caught(monkeypatch):
    """The convolved output altered where it is produced."""
    from audiorenderingv2_tpu_torch import renderer

    orig = renderer.AudioRenderer.convolve_audio_file_device
    monkeypatch.setattr(renderer.AudioRenderer, "convolve_audio_file_device",
                        lambda self, s: torch.roll(orig(self, s), 1, -1))
    out, checks = run_cell(tiny("box.walk"), SEED, 0.3, False, "cpu",
                           log=quiet)
    assert not out["correct"] and checks["out_rel_l2"]["value"] > \
        checks["out_rel_l2"]["limit"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_matrix_faults_are_caught(kind, monkeypatch):
    from audiorenderingv2_tpu_torch import multi

    orig = multi.render_ir_matrix
    first = []

    def faulty(sc, seed, emitters, receivers, yaws, n_rays, *a, **kw):
        if kind == "half":
            return orig(sc, seed, emitters, receivers, yaws, n_rays // 2,
                        *a, **kw)
        out = orig(sc, seed, emitters, receivers, yaws, n_rays, *a, **kw)
        if kind == "unchanged":
            first.append(out)
            return first[0]
        out[:, :, 0] *= 1.5
        return out

    monkeypatch.setattr(multi, "render_ir_matrix", faulty)
    out, checks = run_cell(tiny("box.matrix"), SEED, 0.3, False, "cpu",
                           log=quiet)
    assert not out["correct"], checks


@pytest.mark.parametrize("kind", ["box", "office"])
def test_reference_agrees_with_the_program_on_the_cpu(kind):
    """The float64 reference against the program's CPU path on the same
    directions, both scenes, at a small size."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer

    cfg = harness.load_json("configs", kind)
    spec = dict(cfg["scene"])
    if kind == "office":
        spec["n_triangles_target"] = 1300
    v, t = reference.scene_mesh(spec)
    n = 2048
    tr = {k: cfg[k] for k in ("sample_rate", "ir_seconds", "base_power",
                              "energy_threshold", "max_bounces",
                              "hrtf_absorption_rate")}
    rnd = AudioRenderer(testing.scene_from_arrays(v, t, cfg["absorption"]),
                        tr["ir_seconds"], tr["sample_rate"], n,
                        base_power=tr["base_power"],
                        max_bounces=tr["max_bounces"],
                        hrtf_absorption_rate=tr["hrtf_absorption_rate"],
                        device="cpu", seed=31)
    rnd.set_emitter_pos(cfg["emitter"])
    rnd.set_receiver(cfg["receiver"], 40.0)
    ir = rnd.render()
    geo = reference.Geometry(v, t, cfg["absorption"], "cpu")
    dirs = reference.directions(n, reference.generator_from_seed(31, "cpu"),
                                "cpu")
    ref, steps = reference.trace_ir(geo, dirs, cfg["emitter"],
                                    cfg["receiver"], 40.0, tr)
    ref = ref.numpy()
    assert steps > n
    assert np.abs(ir - ref).sum() / np.abs(ref).sum() < 1e-2
    np.testing.assert_allclose(ir.sum(1), ref.sum(1), rtol=1e-2)


def test_overlap_add_is_the_programs_convolution():
    from audiorenderingv2_tpu_torch.ops import convolve

    g = torch.Generator().manual_seed(3)
    ir = torch.rand((2, 32000), generator=g, dtype=torch.float64)
    x = torch.randn(80000 + 123, generator=g, dtype=torch.float64)
    want = convolve.convolve_file_stereo(x.float(), ir.float(), 16000)
    got = reference.overlap_add(x, ir, 16000)
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-3 * float(got.abs().max()))


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        CELLS[0], "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=harness.CHECKOUT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "No CPU fallback" in p.stderr


def test_cell_on_card(card):
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        CELLS[0], "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=harness.CHECKOUT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1])["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fit_faults_are_caught(kind, monkeypatch):
    """A step that leaves the parameters unchanged, half of the rays with
    the energy spread over them, the replayed IR altered where it is
    produced."""
    from audiorenderingv2_tpu_torch.diff import replay

    from perfbench.drivers import fit

    if kind == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif kind == "half":
        orig = fit.Driver._fit
        monkeypatch.setattr(
            fit.Driver, "_fit", lambda self, dirs, *a, **k: orig(
                self, dirs[:dirs.shape[0] // 2], *a, **k))
    else:
        render = replay.render_ir_replay
        monkeypatch.setattr(replay, "render_ir_replay",
                            lambda *a, **k: render(*a, **k) * 1.5)
    out, checks = run_cell(tiny("office.fit"), SEED, 0.3, False, "cpu",
                           log=quiet)
    assert not out["correct"], checks
