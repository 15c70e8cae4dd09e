"""The export slice end to end: the port against the JAX package on the
same directions, each package's own export, the facade's flags, the CLI."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import context as j_context
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.io import wav as j_wav
from audiorenderingv2_tpu.ops import convolve as j_conv
from audiorenderingv2_tpu_torch import cli, context, convert
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.io import wav as t_wav
from audiorenderingv2_tpu_torch.ops import convolve as t_conv
from audiorenderingv2_tpu_torch.renderer import AudioRenderer

torch.set_num_threads(1)

SR = 8000
ROOM = (9.0, 6.0, 7.0)


def _write_config(tmp_path, rays=(64, 32, 32), mono=False, audio=True,
                  scene="room.obj", bounces=30):
    tt.write_box_obj(tmp_path / "room.obj", ROOM, material="walls")
    rng = np.random.default_rng(0)
    dry = rng.uniform(-0.5, 0.5, size=2 * SR + 300).astype(np.float32)
    t_wav.write_wav(tmp_path / "dry.wav", dry[None, :], SR)
    cfg = {
        "renderer_parameters": {"ir_length_in_seconds": 1},
        "scene_parameters": {
            "mono": mono, "audio_file_path": "dry.wav" if audio else "",
            "scene_file_path": scene,
            "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0},
            "initial_receiver_pos": {"x": 2.0, "y": 1.0, "z": 1.5}},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": dict(zip("xyz", rays)),
            "ray_max_bounces": bounces, "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls", "mat_absorption": 0.3}]},
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def test_same_directions_through_both_slices():
    """Trace + histogram + convolution in both packages from the same
    scene arrays and numpy directions. IR: the reference's statistical bar.
    Audio: the convolution is linear, so its relative L2 error is bounded
    by the IR's relative L1 (< 1e-2); allow 1e-2."""
    v, t = jt.box_room(ROOM)
    scene = jt.scene_from_arrays(v, t, 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    sct = convert.scene_arrays_from_jax(
        {k: None if x is None else np.asarray(x)
         for k, x in sc._asdict().items()}, device="cpu")
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=30, hrtf_absorption_rate=0.9)
    d = np.random.default_rng(8).normal(size=(16384, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rec = np.array([2.0, 1.0, 1.5], np.float32)
    ir_j = ar.trace_ir(sc, jnp.asarray(d), jnp.zeros(3), jnp.asarray(rec),
                       40.0, params, ar.TracerOptions(block_size=4096,
                                                      tri_chunk=128))
    ir_t = t_tracer.trace_ir(sct, torch.from_numpy(d), np.zeros(3), rec,
                             40.0, convert.trace_params_from_jax(params))
    jt.assert_ir_close(ir_t.numpy(), np.asarray(ir_j), exact=False)

    x = np.random.default_rng(2).uniform(-1, 1, 3 * SR).astype(np.float32)
    y_j = np.asarray(j_conv.convolve_file_stereo(jnp.asarray(x), ir_j, SR))
    y_t = t_conv.convolve_file_stereo(torch.from_numpy(x), ir_t, SR).numpy()
    rel = np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j)
    assert rel < 1e-2, rel


def _ear_energy(ctx):
    return ctx.renderer.ir.reshape(2, -1).sum(axis=1)


def test_export_energy_within_jax_seed_spread(tmp_path):
    """Each package's own export at 64k rays with its own RNG. The per-ear
    energy of the port's IR must lie within 6 standard deviations of the
    JAX export's spread over 4 seeds (Monte-Carlo noise; a 6-sigma bound
    on the 4-seed estimate keeps a false failure below ~1e-3)."""
    cfg = _write_config(tmp_path)
    energies = []
    for seed in range(4):
        ctx = j_context.load_context(cfg, seed=seed)
        out = j_context.export_audio(ctx, tmp_path / f"j{seed}.wav")
        energies.append(_ear_energy(ctx))
    energies = np.array(energies)
    mean, std = energies.mean(axis=0), energies.std(axis=0, ddof=1)
    assert np.all(std > 0) and np.all(std < 0.05 * mean), (mean, std)

    ctx = context.load_context(cfg, seed=0, device="cpu")
    got = context.export_audio(ctx, tmp_path / "t.wav")
    e = _ear_energy(ctx)
    assert np.all(np.abs(e - mean) < 6 * std), (e, mean, std)
    assert got.shape == out.shape == (2, 2 * SR + 300)
    assert np.allclose(np.abs(got).max(axis=1), 1.0)
    audio = j_wav.read_wav(tmp_path / "t.wav")
    assert audio.n_channels == 2 and audio.sample_rate == SR
    assert np.all((ctx.renderer.ir > 0).sum(axis=1) > 500)


def test_mono_fold_gives_identical_channels(tmp_path):
    ctx = context.load_context(_write_config(tmp_path, rays=(16, 16, 16),
                                             mono=True), device="cpu")
    out = context.export_audio(ctx, tmp_path / "mono.wav")
    ir = ctx.renderer.ir
    assert ir.sum() > 0
    np.testing.assert_array_equal(ir[0], ir[1])
    np.testing.assert_array_equal(out[0], out[1])
    assert torch.equal(ctx.renderer.ir_device[0].cpu(),
                       torch.from_numpy(ir[0]))


def test_error_paths(tmp_path):
    with pytest.raises(FileNotFoundError):
        context.load_context(_write_config(tmp_path, scene="missing.obj"),
                             device="cpu")
    live = context.load_context(_write_config(tmp_path, audio=False),
                                device="cpu")
    assert live.is_live and live.sample_rate == 16000
    with pytest.raises(RuntimeError, match="audio file"):
        context.export_audio(live, tmp_path / "x.wav")
    with pytest.raises(RuntimeError, match="render"):
        live.renderer.convolve_audio_file(np.zeros(16000, np.float32))
    v, t = tt.box_room()
    banded = tt.scene_from_arrays(v, t, np.full((12, 3), 0.2, np.float32))
    r = AudioRenderer(banded, 1, SR, 128, device="cpu")  # banded is ported
    assert r.params.n_bands == 3 and r.render().shape == (2, 3, SR)
    nine = tt.scene_from_arrays(v, t, np.full((12, 9), 0.2, np.float32))
    with pytest.raises(ValueError, match="at most 8 bands"):
        AudioRenderer(nine, 1, SR, 128, device="cpu")


def test_cli_export_reads_back_in_jax(tmp_path, capsys):
    cfg = _write_config(tmp_path, rays=(16, 16, 16))
    out = tmp_path / "cli.wav"
    assert cli.main([str(cfg), "export", str(out), "--device", "cpu"]) == 0
    assert "exported" in capsys.readouterr().out
    audio = j_wav.read_wav(out)
    assert audio.n_channels == 2 and audio.sample_rate == SR
    assert audio.n_frames == 2 * SR + 300
    assert np.isclose(np.abs(audio.samples).max(), 1.0, atol=1e-4)
    # the two other modes run too: a WAV of the main mode's length that the
    # JAX package reads back, and the walkthrough page
    walk = tmp_path / "walk.wav"
    assert cli.main([str(cfg), "main", str(walk), "--device", "cpu",
                     "--duration", "1"]) == 0
    audio = j_wav.read_wav(walk)
    assert audio.n_channels == 2 and audio.n_frames == SR
    assert np.isclose(np.abs(audio.samples).max(), 1.0, atol=1e-4)
    assert cli.main([str(cfg), "walkthrough", str(tmp_path / "w.html")]) == 0
    assert "const DATA" in (tmp_path / "w.html").read_text()


def test_renderer_setters_and_dumps(tmp_path):
    v, t = tt.box_room(ROOM)
    r = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), 1, SR, 2048,
                      max_bounces=10, base_power=3.62, device="cpu")
    assert sum(r.opts.round_budgets) == 10
    r.set_thresholds(0.0, 200)
    assert sum(r.opts.round_budgets) == 200 and r.params.max_bounces == 200
    r.set_thresholds(0.0, 20)
    r.set_emitter_pos([0.0, 0.0, 0.0])
    r.set_receiver([2.0, 1.0, 1.5], 30.0)
    r.set_base_power(7.24)
    r.set_hrtf_absorption_rate(0.5)
    r.dump_dir = str(tmp_path)
    r.write_ir_to_file_flag = True
    r.write_output_to_file_flag = True
    ir = r.render()
    assert r.params.base_power == 7.24 and ir.shape == (2, SR)
    assert not r.write_ir_to_file_flag  # one-shot
    left = np.loadtxt(tmp_path / "output_ir_left.txt")
    np.testing.assert_allclose(left, ir[0], rtol=1e-6)
    out = r.convolve_audio_file(np.ones(SR, np.float32))
    assert out.shape == (2, SR)
    assert (tmp_path / "output_convolute_right.txt").exists()
    # a fresh draw from the generator gives a different, equally valid IR
    ir2 = r.render()
    assert not np.array_equal(ir, ir2)
    assert abs(ir2.sum() / ir.sum() - 1) < 0.2
