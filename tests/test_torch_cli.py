"""The port's CLI in its ``main`` and ``walkthrough`` modes (the cases of
tests/test_cli.py for those modes, on ``--device cpu``), and the main-mode
WAV against the JAX package's on shared directions."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiorenderingv2_tpu import cli as j_cli
from audiorenderingv2_tpu import streaming as j_streaming
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu.io import wav as j_wav
from audiorenderingv2_tpu_torch import cli
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import sampling as t_sampling
from audiorenderingv2_tpu_torch.io import wav as wav_io

torch.set_num_threads(1)

SR = 8000


def _write_config(tmp_path, rays=(8, 8, 8), bounces=4, audio=True):
    tt.write_box_obj(tmp_path / "room.obj", (10.0, 8.0, 9.0),
                     material="walls")
    sig = (np.sin(np.linspace(0, 300, 2 * SR)) * 0.5).astype(np.float32)
    wav_io.write_wav(tmp_path / "in.wav", sig[None, :], SR)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "renderer_parameters": {"ir_length_in_seconds": 1},
        "scene_parameters": {
            "audio_file_path": "in.wav" if audio else "",
            "scene_file_path": "room.obj",
            "initial_receiver_pos": {"x": 2.0, "y": 0.0, "z": 1.0},
            "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0}},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": dict(zip("xyz", rays)),
            "ray_max_bounces": bounces, "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls", "mat_absorption": 0.3}]},
    }))
    return cfg


def test_main_mode_duration(tmp_path, capsys):
    cfg = _write_config(tmp_path)
    out = tmp_path / "walk.wav"
    assert cli.main([str(cfg), "main", str(out), "--duration", "1.0",
                     "--device", "cpu"]) == 0
    assert "IR renders" in capsys.readouterr().out
    audio = wav_io.read_wav(out)
    assert audio.n_channels == 2 and audio.sample_rate == SR
    assert audio.n_frames == SR
    assert np.isfinite(audio.samples).all()
    assert np.isclose(np.abs(audio.samples).max(), 1.0, atol=1e-4)


def test_main_mode_recorded_trajectory(tmp_path):
    """A browser-recorded trajectory JSON drives the main mode."""
    cfg = _write_config(tmp_path)
    traj = tmp_path / "traj.json"
    traj.write_text(json.dumps({
        "times": [0.0, 0.5, 1.0],
        "positions": [[2.0, 0.0, 1.0], [2.5, 0.0, 1.5], [3.0, 0.0, 2.0]],
        "yaws_deg": [0.0, 20.0, 45.0]}))
    out = tmp_path / "walked.wav"
    assert cli.main([str(cfg), "main", str(out), "--duration", "1.0",
                     "--trajectory", str(traj), "--device", "cpu"]) == 0
    audio = wav_io.read_wav(out)
    assert audio.n_frames == SR and np.isfinite(audio.samples).all()


def test_live_mode_main_exits_1(tmp_path, capsys):
    cfg = _write_config(tmp_path, audio=False)
    assert cli.main([str(cfg), "--device", "cpu"]) == 1  # main is the default
    assert "LiveConvolver" in capsys.readouterr().err


def test_walkthrough_mode(tmp_path, capsys):
    """The config and the scene only: no renderer, so no device, and the
    WAV given to ``--embed-audio`` inside the page."""
    cfg = _write_config(tmp_path)
    out = tmp_path / "walk.html"
    assert cli.main([str(cfg), "walkthrough", str(out), "--embed-audio",
                     str(tmp_path / "in.wav"), "--device", "meta"]) == 0
    html = out.read_text()
    assert "<canvas" in html and "const DATA" in html
    assert "data:audio/wav;base64," in html
    assert f"walkthrough {out}" in capsys.readouterr().out


def test_bad_mode_rejected(tmp_path):
    cfg = _write_config(tmp_path)
    with pytest.raises(SystemExit):
        cli.main([str(cfg), "nonsense"])
    with pytest.raises(SystemExit):  # the experimentation mode's flags
        cli.main([str(cfg), "main", "--layout", "group"])


def test_default_trajectory_equals_jax_orbit(tmp_path, monkeypatch):
    """The default half orbit (9 keys around the emitter over the duration,
    facing it) and the policy's thresholds are those the JAX CLI hands its
    Auralizer, caught there by a stand-in: the same times, positions and
    yaws bit for bit."""
    cfg = _write_config(tmp_path)
    caught = {}

    class Catch:
        def __init__(self, renderer, trajectory, policy, volume):
            caught.update(points=trajectory.points, policy=policy,
                          volume=volume)
            self.renders = 0

        def run(self, samples):
            return np.ones((2, samples.shape[0]), np.float32)

    monkeypatch.setattr(j_streaming, "Auralizer", Catch)
    assert j_cli.main([str(cfg), "main", str(tmp_path / "j.wav")]) == 0
    pts = cli.default_trajectory([2.0, 0.0, 1.0], [0.0, 0.0, 0.0], 2.0)
    assert len(pts) == len(caught["points"]) == 9
    for p, q in zip(pts, caught["points"]):
        assert p.time == q.time and p.yaw_deg == q.yaw_deg
        np.testing.assert_array_equal(p.position, q.position)
    np.testing.assert_allclose(pts[-1].position, [-2.0, 0.0, -1.0],
                               atol=1e-6)
    facing = np.array([np.cos(np.radians(pts[3].yaw_deg)), 0.0,
                       np.sin(np.radians(pts[3].yaw_deg))])
    np.testing.assert_allclose(facing, -pts[3].position / np.sqrt(5.0),
                               atol=1e-5)
    policy = caught["policy"]
    assert (policy.distance_threshold, policy.angle_threshold) == (3.0, 5.0)


def test_main_mode_wav_equals_jax(tmp_path, monkeypatch):
    """The main mode of both packages on the same config (2 s of signal,
    the default half orbit, the config's thresholds), every render of both
    from the same 2048 seeded directions: the normalised WAVs within 1e-2
    relative L2 (the bar of tests/test_torch_context.py)."""
    d = np.random.default_rng(9).normal(size=(2048, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    monkeypatch.setattr(j_sampling, "sample_directions",
                        lambda key, n, **kw: jnp.asarray(d))
    monkeypatch.setattr(t_sampling, "sample_directions",
                        lambda n, generator, device: torch.tensor(d))
    cfg = _write_config(tmp_path, rays=(16, 16, 8), bounces=12)
    ref_path, got_path = tmp_path / "j.wav", tmp_path / "t.wav"
    assert j_cli.main([str(cfg), "main", str(ref_path)]) == 0
    assert cli.main([str(cfg), "main", str(got_path), "--device",
                     "cpu"]) == 0
    ref, got = j_wav.read_wav(ref_path), wav_io.read_wav(got_path)
    assert got.samples.shape == ref.samples.shape == (2, 2 * SR)
    rel = (np.linalg.norm(got.samples - ref.samples)
           / np.linalg.norm(ref.samples))
    assert rel < 1e-2, rel
