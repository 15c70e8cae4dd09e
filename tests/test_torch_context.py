"""The port's context against the JAX package's: a banded config's
crossover frequencies (``absorption_band_edges``) reach the renderer, and
the export through both contexts agrees."""
import json

import jax
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import context as j_context
from audiorenderingv2_tpu.core import sampling as j_sampling
from audiorenderingv2_tpu_torch import context as t_context
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import sampling as t_sampling
from audiorenderingv2_tpu_torch.io import wav as t_wav

torch.set_num_threads(1)

SR = 8000


def _write_config(tmp_path, edges, absorption):
    tt.write_box_obj(tmp_path / "room.obj", (9.0, 6.0, 7.0),
                     material="walls")
    dry = np.random.default_rng(0).uniform(-0.5, 0.5, 2 * SR + 300).astype(
        np.float32)
    t_wav.write_wav(tmp_path / "dry.wav", dry[None, :], SR)
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "renderer_parameters": {"ir_length_in_seconds": 1},
        "scene_parameters": {
            "mono": False, "audio_file_path": "dry.wav",
            "scene_file_path": "room.obj",
            "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0},
            "initial_receiver_pos": {"x": 2.0, "y": 1.0, "z": 1.5}},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": {"x": 16, "y": 16, "z": 16},
            "ray_max_bounces": 12, "hrtf_absorption_rate": 0.9,
            "absorption_band_edges": list(edges),
            "materials": [{"name": "walls",
                           "mat_absorption": list(absorption)}]}}))
    return path


@pytest.mark.parametrize("edges, absorption", [
    ((300.0, 1200.0, 5000.0), (0.1, 0.2, 0.4, 0.8)),  # tests/test_bands.py
    ((800.0,), (0.15, 0.55)),
])
def test_export_uses_the_config_band_edges(tmp_path, monkeypatch, edges,
                                           absorption):
    """A banded config whose edges are not the filterbank's default
    (250, 1000, 4000) Hz, exported through both packages' contexts with
    the directions of the JAX renderer's first render: the port's renderer
    holds the config's edges and its normalised WAV is the JAX one within
    1e-2 relative L2 (the bar of tests/test_torch_filterbank.py's banded
    export)."""
    cfg = _write_config(tmp_path, edges, absorption)
    j_ctx = j_context.load_context(cfg, opts=ar.TracerOptions(
        block_size=4096, tri_chunk=128), seed=0)
    ref = j_context.export_audio(j_ctx, tmp_path / "j.wav")
    d = np.asarray(j_sampling.sample_directions(
        jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(0)), 4096))
    monkeypatch.setattr(t_sampling, "sample_directions",
                        lambda n, generator, device: torch.tensor(d))
    t_ctx = t_context.load_context(cfg, device="cpu")
    got = t_context.export_audio(t_ctx, tmp_path / "t.wav")
    r = t_ctx.renderer
    assert r.band_edges == edges == tuple(j_ctx.renderer.band_edges)
    assert r.params.n_bands == len(edges) + 1
    assert r.ir.shape == (2, len(edges) + 1, SR)
    assert got.shape == ref.shape == (2, 2 * SR + 300)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-2, rel
    written = t_wav.read_wav(tmp_path / "t.wav")
    assert written.n_channels == 2 and written.sample_rate == SR
