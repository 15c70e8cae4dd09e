"""The port's seven demos (audiorenderingv2_tpu_torch/examples/) on the CPU,
each ``main(device="cpu")`` at its CPU size, against the JAX package where
the JAX demo computes a number that can be held.

Demos 1 and 2 trace the JAX demos' own directions (``PRNGKey(0)``; demo 2's
first 16,384 of its 100,000) and are held to JAX's XLA tracer on the
reference's statistical bar, ``assert_ir_close(exact=False)`` (per-ear
energy within 1e-3, relative L1 below 1e-2). Demo 6 draws each pair's
directions as JAX's ``fold_in(PRNGKey(0), pair)`` and is held to JAX's
matrix (its Pallas kernel in interpret mode, as the JAX demo runs on the
CPU) on the same bar. Demo 4 asserts the JAX demo's own bars with 30 Adam
steps instead of its 200. Demos 3 and 5 and the live duplex: finite output
of the right length.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import multi as j_multi
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.renderer import AudioRenderer as JAudioRenderer
from audiorenderingv2_tpu_torch import renderer as t_renderer
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import sampling as t_sampling
from audiorenderingv2_tpu_torch.examples import (demo_1_sphere,
                                                 demo_2_banded,
                                                 demo_3_realtime,
                                                 demo_4_inverse,
                                                 demo_5_sharded,
                                                 demo_6_multipose,
                                                 demo_live_duplex)
from audiorenderingv2_tpu_torch.io import wav as t_wav

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _jax_ir(scene, dirs, emitter, receiver, yaw, params):
    """JAX's XLA trace of the same scene (a host Scene of either package:
    both are the same copied dataclass) and directions."""
    import dataclasses

    jparams = ar.TraceParams(**dataclasses.asdict(params))
    return np.asarray(ar.trace_ir(
        ar.scene_to_arrays(scene), jnp.asarray(dirs),
        jnp.asarray(emitter, jnp.float32), jnp.asarray(receiver, jnp.float32),
        yaw, jparams, ar.TracerOptions(backend="xla")))


def test_demo_1_matches_jax_and_convolves(tmp_path):
    """The JAX demo's 10,000 directions: the port's IR against JAX's XLA
    tracer; a given WAV is convolved and written at its length."""
    d = np.array(j_sampling.sample_directions(jax.random.PRNGKey(0),
                                              demo_1_sphere.N_RAYS))
    sig = (np.random.default_rng(1).standard_normal(16000) * 0.1).astype(
        np.float32)
    t_wav.write_wav(tmp_path / "in.wav", sig, 16000)
    out = demo_1_sphere.main(tmp_path / "out.wav", tmp_path / "in.wav",
                             device="cpu", directions=d)
    assert out["n_triangles"] == 320
    ref = _jax_ir(demo_1_sphere.scene(), d, demo_1_sphere.EMITTER,
                  demo_1_sphere.RECEIVER, demo_1_sphere.YAW,
                  demo_1_sphere.trace_params())
    assert out["ir"].shape == ref.shape == (2, 16000)
    tt.assert_ir_close(out["ir"], ref, exact=False)
    assert out["nonzero"] == int((ref != 0).sum())
    wav = t_wav.read_wav(tmp_path / "out.wav")
    assert wav.samples.shape == (2, 16000) and out["seconds"] == 1.0
    assert np.isfinite(wav.samples).all()
    # its own seeded directions
    own = demo_1_sphere.main(device="cpu")
    assert own["nonzero"] > 50 and "seconds" not in own


def test_demo_2_matches_jax():
    """The first 16,384 of the JAX demo's 100,000 directions through the
    1,280-triangle, 4-band scene (mesh_from_arrays, K1's plain version over
    the rows in chunks) against JAX's XLA tracer, per (ear, band) row."""
    d = np.array(j_sampling.sample_directions(
        jax.random.PRNGKey(0), demo_2_banded.N_RAYS))[:16384]
    out = demo_2_banded.main(device="cpu", directions=d)
    assert out["n_triangles"] == 1280
    ref = _jax_ir(demo_2_banded.scene(), d, demo_2_banded.EMITTER,
                  demo_2_banded.RECEIVER, demo_2_banded.YAW,
                  demo_2_banded.trace_params())
    assert out["ir"].shape == ref.shape == (2, 4, 16000)
    tt.assert_ir_close(out["ir"].reshape(8, -1), ref.reshape(8, -1),
                       exact=False)
    energy = out["band_energy"]
    np.testing.assert_allclose(energy, ref.sum(axis=(0, 2)), rtol=1e-3)
    assert np.all(np.diff(energy) < 0)  # the absorbent bands keep less


def test_demo_3_auralizes_and_pins_the_empty_irs_outside_the_room(
        monkeypatch, tmp_path):
    """10 s at 50,000 rays: every render's IR recorded. The JAX demo's walk
    starts at (2.5, 9.9, 0), past the box's y = 5 wall: every render whose
    receiver sphere lies wholly outside the box (y - 1 >= 5, t < 3.98 s)
    sees an empty IR, and every render with the receiver's centre inside
    does not. JAX's renderer agrees at the walk's start (empty) and end.
    (At 1M rays a few rays in a million leave the box at an edge and reach
    the receiver outside, in the float64 oracle too: chip_smoke.py phase
    23 holds those on the card.)"""
    renders = []
    orig = t_renderer.AudioRenderer.render

    def recording(self, *a, **kw):
        ir = orig(self, *a, **kw)
        renders.append((self.receiver_pos.copy(), float(ir.sum())))
        return ir

    monkeypatch.setattr(t_renderer.AudioRenderer, "render", recording)
    out = demo_3_realtime.main(tmp_path / "walk.wav", device="cpu")
    assert out["n_rays"] == 50_000
    assert out["out"].shape == (2, 16000 * 10)
    assert np.isfinite(out["out"]).all() and np.abs(out["out"]).max() > 0
    assert np.isfinite(out["rtf"]) and out["rtf"] > 0
    assert len(renders) == out["renders"] + 1  # the warm-up cycle first
    outside = [e for p, e in renders if p[1] - 1.0 >= 5.0]
    inside = [e for p, e in renders if p[1] < 5.0]
    assert len(outside) >= 8 and all(e == 0.0 for e in outside), renders
    assert inside and all(e > 0.0 for e in inside), renders
    wav = t_wav.read_wav(tmp_path / "walk.wav")
    assert wav.samples.shape == (2, 16000 * 10)

    v, t = jt.box_room(demo_3_realtime.ROOM)
    traj = demo_3_realtime.trajectory()
    jr = JAudioRenderer(jt.scene_from_arrays(v, t, 0.25), ir_seconds=2,
                        sample_rate=16000, n_rays=8192, base_power=3.62,
                        max_bounces=8, opts=ar.TracerOptions(backend="xla"))
    for time_s, empty in ((0.0, True), (10.0, False)):
        pos, yaw = traj.at(time_s)
        jr.set_receiver(jnp.asarray(pos), yaw)
        energy = float(np.asarray(jr.render()).sum())
        assert (energy == 0.0) == empty, (time_s, energy)


def test_demo_4_fit_meets_the_jax_bars():
    """Stage A's grid and 30 Adam steps of stage B on the CPU: the demo
    asserts absorption within 0.08 and the source within 0.5 m."""
    out = demo_4_inverse.main(device="cpu", steps=30)
    assert len(out["grid"]) == 60 and len(out["losses"]) == 30
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert abs(out["absorption"] - demo_4_inverse.TRUE_ABSORPTION) < 0.08
    assert out["emitter_err"] < 0.5


def test_demo_5_world_of_one():
    """16,384 rays in a world of one: the sharded IR and the 2 x 2 matrix,
    finite and of the right length."""
    out = demo_5_sharded.main(device="cpu")
    assert (out["world"], out["n_rays"], out["pair_rays"]) == (1, 16384,
                                                               1024)
    ir = out["ir"].numpy()
    assert ir.shape == (2, 32000) and np.isfinite(ir).all()
    assert out["ir_sum"] == pytest.approx(float(ir.sum())) and ir.sum() > 0
    assert out["irs"].shape == (2, 2, 2, 32000) and out["finite"]
    assert (out["irs"].reshape(4, -1).sum(axis=1) > 0).all()
    assert demo_5_sharded.scene().n_triangles == 332


def test_demo_5_under_torchrun_on_two_gloo_ranks(tmp_path):
    """``torchrun --nproc-per-node 2`` on the CPU: each rank joins the gloo
    group from torchrun's environment and prints the same IR sum.

    Each rank's stdout goes to a file of its own (``--log-dir``, ``-r 1``):
    two ranks printing into one pipe can splice their lines under load.
    ``--standalone`` binds the rendezvous on a port the agent picks itself,
    so no other process can take it between its choice and its use."""
    import signal

    # Its own process group, so that a timeout also ends torchrun's workers.
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--log-dir", str(tmp_path), "-r", "1",
         "-m", "audiorenderingv2_tpu_torch.examples.demo_5_sharded",
         "--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    logs = [sorted(tmp_path.glob(f"*/attempt_0/{rank}/stdout.log"))
            for rank in (0, 1)]
    ranks = [p[0].read_text() if len(p) == 1 else "" for p in logs]
    shown = (f"rank 0:\n{ranks[0][-3000:]}\nrank 1:\n{ranks[1][-3000:]}\n"
             f"stdout:\n{out[-2000:]}\nstderr:\n{err[-3000:]}")
    assert proc.returncode == 0, shown
    assert [len(p) for p in logs] == [1, 1], shown
    sums = []
    for text in ranks:
        lines = [x for x in text.splitlines() if "sharded render" in x]
        assert len(lines) == 1 and "over 2 devices" in lines[0], shown
        sums.append(lines[0].split("IR sum")[1])
        assert text.count("mesh: 2 x cpu devices") == 1, shown
    assert sums[0] == sums[1], shown


def test_demo_6_matches_jax_matrix(monkeypatch, tmp_path):
    """4,096 rays a pair, each pair's directions JAX's fold_in(PRNGKey(0),
    pair): the fused 2 x 4 matrix against JAX's (interpret mode), per
    (pair, ear) row; one finite stereo WAV per listener."""
    key = jax.random.PRNGKey(0)
    n_rays = demo_6_multipose.n_rays("cpu")
    by_seed = {}
    for i in range(8):
        d = np.asarray(j_sampling.sample_directions(jax.random.fold_in(key, i),
                                                    n_rays))
        by_seed[t_sampling.pose_generator(0, i, "cpu").initial_seed()] = d

    def shared(n, generator, device):
        d = by_seed[generator.initial_seed()]
        assert d.shape[0] == n
        return torch.tensor(d, device=device)

    monkeypatch.setattr(t_sampling, "sample_directions", shared)
    out = demo_6_multipose.main(tmp_path, device="cpu", seed=0)

    v, t = jt.box_room(demo_6_multipose.ROOM)
    p = demo_6_multipose.trace_params()
    import dataclasses

    ref = j_multi.render_ir_matrix(
        ar.scene_to_arrays(jt.scene_from_arrays(v, t, 0.25), 128), key,
        demo_6_multipose.EMITTERS, demo_6_multipose.LISTENERS,
        demo_6_multipose.YAWS, n_rays,
        ar.TraceParams(**dataclasses.asdict(p)),
        ar.TracerOptions(backend="pallas", pallas_version=2,
                         pallas_layout="rows", pallas_unroll=8,
                         pallas_round_budgets=(8, 32), pallas_interpret=True,
                         rng_impl="threefry"), pair_batch=8)
    irs = out["irs"]
    assert irs.shape == ref.shape == (2, 4, 2, 32000)
    tt.assert_ir_close(irs.reshape(16, -1), np.asarray(ref).reshape(16, -1),
                       exact=False)
    assert out["out"].shape == (4, 2, 32000) and np.isfinite(out["out"]).all()
    assert [pth.name for pth in out["paths"]] == [
        f"listener_{i}.wav" for i in range(4)]
    for pth in out["paths"]:
        wav = t_wav.read_wav(pth)
        assert wav.samples.shape == (2, 32000)
        assert np.isfinite(wav.samples).all()
        assert np.abs(wav.samples).max() == pytest.approx(1.0, abs=1e-3)


def test_demo_live_duplex_streams_every_block(tmp_path):
    """Six seconds in blocks of 4,096: 23 whole blocks, 94,208 stereo
    frames through the native engine (built with g++ here), finite, and
    the WAV of that length; the raw sink is removed."""
    out = demo_live_duplex.main(tmp_path / "live.wav", device="cpu")
    assert out["blocks"] == 23 and out["frames"] == 23 * 4096
    assert out["native"] and out["frames_streamed"] == 23 * 4096
    assert out["data"].shape == (2, 23 * 4096)
    assert np.isfinite(out["data"]).all() and np.abs(out["data"]).max() > 0
    wav = t_wav.read_wav(tmp_path / "live.wav")
    assert wav.samples.shape == (2, 23 * 4096)
    assert not (tmp_path / "live.f64").exists()
