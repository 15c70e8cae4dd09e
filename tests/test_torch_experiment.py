"""The port's experimentation mode: ``run_experiment``, the CLI mode that
drives it, the renderer's checksum fence and ``utils/profiling.py``, on the
CPU and against the JAX package's summary format."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiorenderingv2_tpu import experiment as j_experiment
from audiorenderingv2_tpu_torch import cli, context, experiment
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
from audiorenderingv2_tpu_torch.io import wav as t_wav
from audiorenderingv2_tpu_torch.ops import group_cuda, raytrace_cuda, v1_cuda
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
from audiorenderingv2_tpu_torch.utils import profiling

torch.set_num_threads(1)

SR = 8000
ROOM = (9.0, 6.0, 7.0)
SUMMARY_KEYS = [
    "rounds", "avg render time", "median render time", "avg convolute time",
    "median convolute time", "avg convolute process time",
    "median convolute process time", "IR peak mean", "IR peak stddev",
    "IR peak coefficient of variation"]


def _renderer(opts=None, seed=0, n_rays=1024):
    v, t = tt.box_room(ROOM)
    r = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), 1, SR, n_rays,
                      max_bounces=8, base_power=3.62, opts=opts, seed=seed,
                      device="cpu")
    r.set_receiver((2.0, 1.0, 1.5), 20.0)
    return r


def _write_config(tmp_path, audio=True):
    tt.write_box_obj(tmp_path / "room.obj", ROOM, material="walls")
    dry = np.random.default_rng(0).uniform(-0.5, 0.5, 2 * SR).astype(
        np.float32)
    t_wav.write_wav(tmp_path / "dry.wav", dry[None, :], SR)
    cfg = {
        "renderer_parameters": {"ir_length_in_seconds": 1},
        "scene_parameters": {
            "mono": False, "audio_file_path": "dry.wav" if audio else "",
            "scene_file_path": "room.obj",
            "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0},
            "initial_receiver_pos": {"x": 2.0, "y": 1.0, "z": 1.5}},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": {"x": 16, "y": 8, "z": 8},
            "ray_max_bounces": 8, "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls", "mat_absorption": 0.3}]},
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def _keys(summary: str):
    return [line.split(":")[0] for line in summary.splitlines()]


def test_run_experiment_counts_and_statistics():
    """3 rounds after 1 warm-up: three times per stage, three peaks, a
    finite coefficient of variation, and the JAX package's summary lines."""
    samples = np.random.default_rng(1).uniform(-1, 1, SR).astype(np.float32)
    res = experiment.run_experiment(_renderer(), samples, rounds=3, warmup=1)
    assert res.rounds == 3 and res.ir_peaks.shape == (3,)
    for stage in (res.render, res.convolute, res.convolute_process):
        assert len(stage.times_ms) == 3
        assert stage.average > 0 and stage.median > 0
    assert res.peak_mean > 0 and np.isfinite(res.peak_cov)
    assert res.peak_cov == pytest.approx(res.peak_stddev / res.peak_mean)
    assert 0 < res.peak_cov < 1  # three independent draws differ
    lines = res.summary().splitlines()
    assert len(lines) == 10 and _keys(res.summary()) == SUMMARY_KEYS
    # the same lines as the JAX package prints for the same numbers
    ref = j_experiment.ExperimentResults(
        rounds=3,
        render=j_experiment.StageStats(list(res.render.times_ms)),
        convolute=j_experiment.StageStats(list(res.convolute.times_ms)),
        convolute_process=j_experiment.StageStats(
            list(res.convolute_process.times_ms)),
        ir_peaks=res.ir_peaks)
    assert res.summary() == ref.summary()


def test_run_experiment_without_samples_times_only_the_render():
    res = experiment.run_experiment(_renderer(), None, rounds=2, warmup=0)
    assert len(res.render.times_ms) == 2
    assert res.convolute.times_ms == [] and res.convolute.average == 0.0
    assert res.convolute_process.median == 0.0
    assert "avg convolute time: 0.00 ms" in res.summary()


def test_equal_generators_give_equal_peaks():
    """Round i draws from its own generator: two runs with one seed agree
    peak for peak, whatever the renderer's own generator has drawn, and
    another seed gives other peaks."""
    a = experiment.run_experiment(_renderer(seed=0), rounds=3, warmup=1)
    used = _renderer(seed=7)
    used.render()
    b = experiment.run_experiment(used, rounds=3, warmup=0)
    np.testing.assert_array_equal(a.ir_peaks, b.ir_peaks)
    c = experiment.run_experiment(_renderer(), rounds=3, warmup=1, seed=1)
    assert not np.array_equal(a.ir_peaks, c.ir_peaks)
    g1 = experiment.round_generator(0, 2, "cpu")
    g2 = experiment.round_generator(0, 2, "cpu")
    assert g1.initial_seed() == g2.initial_seed()
    assert g1.initial_seed() != experiment.round_generator(0, 1,
                                                           "cpu").initial_seed()
    assert experiment.round_generator(0, -1, "cpu").initial_seed() >= 0


@pytest.mark.parametrize("opts", [
    TracerOptions(layout="group"), TracerOptions(version=1),
    TracerOptions(layout="group", precision="high")],
    ids=["group", "v1", "group-high"])
def test_experiment_under_manual_options(opts):
    """The experiment times whatever renderer it is given; the manual
    routes see the same directions as the rows route, so at f32 their peaks
    equal its peaks."""
    rows = experiment.run_experiment(_renderer(TracerOptions()), rounds=2,
                                     warmup=0)
    res = experiment.run_experiment(_renderer(opts), rounds=2, warmup=0)
    if opts.precision == "highest":
        np.testing.assert_array_equal(res.ir_peaks, rows.ir_peaks)
    else:
        np.testing.assert_allclose(res.ir_peaks, rows.ir_peaks, rtol=0.05)


def test_convolve_checksum_is_the_sum_of_the_convolution():
    r = _renderer()
    samples = np.random.default_rng(2).uniform(-1, 1, SR).astype(np.float32)
    with pytest.raises(RuntimeError, match="render"):
        r.convolve_audio_file_device_checksum(samples)
    r.render()
    s = r.convolve_audio_file_device_checksum(torch.from_numpy(samples))
    out = r.convolve_audio_file(samples)
    assert isinstance(s, float) and np.isfinite(s)
    assert s == pytest.approx(float(out.sum()), rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("flags,counter", [
    ([], None),
    (["--layout", "group"], "group"),
    (["--kernel-version", "1"], "v1"),
    (["--layout", "group", "--precision", "high"], "group"),
], ids=["default", "group", "v1", "group-high"])
def test_cli_experimentation_prints_the_summary(tmp_path, capsys, flags,
                                                counter):
    """The mode on a written config: ten lines, the JAX mode's; on the CPU
    no kernel launches."""
    cfg = _write_config(tmp_path)
    group_cuda.trace_round_group_launches = 0
    v1_cuda.trace_round_v1_launches = raytrace_cuda.launches = 0
    assert cli.main([str(cfg), "experimentation", "--rounds", "2",
                     "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert len(lines) == 10 and _keys(out.strip()) == SUMMARY_KEYS
    assert lines[0] == "rounds: 2"
    assert float(lines[7].split(":")[1]) > 0          # IR peak mean
    assert float(lines[3].split(":")[1].split()[0]) > 0  # convolute ms
    assert group_cuda.trace_round_group_launches == 0
    assert v1_cuda.trace_round_v1_launches == raytrace_cuda.launches == 0


def test_cli_options_reach_the_renderer(tmp_path, monkeypatch):
    """No flag leaves the options to the renderer; any flag makes them
    explicit."""
    cfg = _write_config(tmp_path)
    seen = []
    real = context.load_context

    def spy(path, opts=None, seed=0, device="cuda"):
        seen.append((opts, device))
        return real(path, opts=opts, seed=seed, device=device)

    monkeypatch.setattr(context, "load_context", spy)
    cli.main([str(cfg), "experimentation", "--rounds", "1", "--device",
              "cpu"])
    cli.main([str(cfg), "experimentation", "--rounds", "1", "--device",
              "cpu", "--kernel-version", "1"])
    cli.main([str(cfg), "experimentation", "--rounds", "1", "--device",
              "cpu", "--layout", "group", "--precision", "high"])
    cli.main([str(cfg), "export", str(tmp_path / "o.wav"), "--device", "cpu"])
    assert seen == [(None, "cpu"), (TracerOptions(version=1), "cpu"),
                    (TracerOptions(layout="group", precision="high"), "cpu"),
                    (None, "cpu")]
    # the three flags are the experimentation mode's, as in the JAX CLI
    with pytest.raises(SystemExit):
        cli.main([str(cfg), "export", str(tmp_path / "o.wav"), "--device",
                  "cpu", "--layout", "group"])
    # main renders on --device through the same context; walkthrough loads
    # only the config and the scene, so it builds no context at all
    assert cli.main([str(cfg), "main", str(tmp_path / "m.wav"), "--device",
                     "cpu", "--duration", "0.5"]) == 0
    assert cli.main([str(cfg), "walkthrough",
                     str(tmp_path / "w.html")]) == 0
    assert seen[4:] == [(None, "cpu")]


def test_cli_experimentation_live_config_skips_the_convolution(tmp_path,
                                                               capsys):
    cfg = _write_config(tmp_path, audio=False)
    assert cli.main([str(cfg), "experimentation", "--rounds", "1",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "avg convolute process time: 0.00 ms" in out


def test_module_entry_point_runs_the_mode(tmp_path):
    """``python -m audiorenderingv2_tpu_torch <config> experimentation``."""
    cfg = _write_config(tmp_path)
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "audiorenderingv2_tpu_torch", str(cfg),
         "experimentation", "--rounds", "1", "--device", "cpu"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _keys(proc.stdout.strip()) == SUMMARY_KEYS


# ---------------------------------------------------------------- profiling

def test_timed_median_contract_and_floor():
    calls = []

    def work(i):
        calls.append(i)
        return torch.full((4,), float(i + 1))

    med, first_s, checksum = profiling.timed_median(work, n=3, device="cpu")
    assert calls == [0, 1, 2, 3] and checksum == 4.0
    assert med >= 0 and first_s >= 0
    x = torch.ones(8)
    med, _, checksum = profiling.timed_median(lambda t: t * 2, x, n=2,
                                              device="cpu")
    assert checksum == 16.0
    with pytest.raises(RuntimeError, match="below the physical floor"):
        profiling.timed_median(lambda t: t, x, n=2, min_ms=1e6, device="cpu")
    with pytest.raises(RuntimeError, match="bad checksum"):
        profiling.timed_median(lambda t: t * 0, x, n=1, device="cpu")
    with pytest.raises(RuntimeError, match="bad checksum"):
        profiling.timed_median(lambda t: t * float("nan"), x, n=1,
                               device="cpu")


def test_device_fence_reads_the_first_leaf():
    assert profiling.device_fence(torch.arange(4.0)) == 6.0
    assert profiling.device_fence((torch.ones(3), torch.zeros(2))) == 3.0
    assert profiling.device_fence({"a": [np.full(2, 2.5)]}) == 5.0
    assert profiling.device_fence(1.5) == 1.5
    with pytest.raises(ValueError, match="needs a tensor"):
        profiling.device_fence(())


def test_timer_rays_per_second_and_trace(tmp_path):
    """``trace()``, the operator's switch of the port's spans (the timer and
    the rays-a-second helper it once sat beside gave way to them): its
    Chrome trace holds a render's ``ar2.`` spans beside the operators they
    enclose, and no span is entered outside it."""
    v, t = tt.box_room((4.0, 3.0, 3.0))
    r = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), ir_seconds=1,
                      sample_rate=8000, n_rays=256, max_bounces=4,
                      device="cpu")
    assert not hasattr(profiling, "Timer")
    assert not hasattr(profiling, "rays_per_second")
    with profiling.trace(str(tmp_path / "prof"), device="cpu") as prof:
        r.render()
    r.render()
    path = tmp_path / "prof" / "trace.json"
    assert path.stat().st_size > 0
    assert len(prof.key_averages()) > 0
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("ar2.render") == 1
    assert {"ar2.trace.init", "ar2.trace.round", "ar2.trace.kernel",
            "ar2.bin", "ar2.ir_to_host"} <= set(names)
    assert r.counters == {}  # the untraced render after it counts nothing
