"""Experimentation / measurement harness.

The counterpart of ``audiorenderingv2_tpu/experiment.py`` (the reference's
experimentation mode, main.cpp:531-626): run N timed render + convolve
rounds, report the average and median stage times, and measure Monte-Carlo
noise as the mean, standard deviation and coefficient of variation of the
IR's peak across rounds. Round ``i`` draws its directions from its own
explicit ``torch.Generator``, so the CoV is the variance of the estimator
and a run repeats.

Times are host-clock times around work that ends in a fence: ``render()``
copies the IR to the host, which waits for the device; the device-only
convolution ends in the renderer's one-float checksum.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class StageStats:
    times_ms: list = field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.times_ms.append(seconds * 1000.0)

    @property
    def average(self) -> float:
        return float(np.mean(self.times_ms)) if self.times_ms else 0.0

    @property
    def median(self) -> float:
        return float(np.median(self.times_ms)) if self.times_ms else 0.0


@dataclass
class ExperimentResults:
    """Stage timings and the IR peak's Monte-Carlo statistics."""

    rounds: int
    render: StageStats
    convolute: StageStats
    convolute_process: StageStats
    ir_peaks: np.ndarray

    @property
    def peak_mean(self) -> float:
        return float(np.mean(self.ir_peaks))

    @property
    def peak_stddev(self) -> float:
        return float(np.std(self.ir_peaks))

    @property
    def peak_cov(self) -> float:
        """Coefficient of variation of the IR peak across rounds
        (Utils.cpp:34-64)."""
        m = self.peak_mean
        return self.peak_stddev / m if m else 0.0

    def summary(self) -> str:
        return "\n".join([
            f"rounds: {self.rounds}",
            f"avg render time: {self.render.average:.2f} ms",
            f"median render time: {self.render.median:.2f} ms",
            f"avg convolute time: {self.convolute.average:.2f} ms",
            f"median convolute time: {self.convolute.median:.2f} ms",
            f"avg convolute process time: {self.convolute_process.average:.2f} ms",
            f"median convolute process time: {self.convolute_process.median:.2f} ms",
            f"IR peak mean: {self.peak_mean:.6e}",
            f"IR peak stddev: {self.peak_stddev:.6e}",
            f"IR peak coefficient of variation: {self.peak_cov:.4f}",
        ])


def round_generator(seed: int, index: int,
                    device: torch.device | str) -> torch.Generator:
    """The direction generator of round ``index`` (warm-up rounds have
    negative indices) of an experiment seeded ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(index)) % (2 ** 63))
    return g


def run_experiment(renderer, samples: np.ndarray | None = None,
                   rounds: int = 100, warmup: int = 1,
                   seed: int = 0) -> ExperimentResults:
    """Time ``rounds`` render (+ convolve) cycles of ``renderer`` after
    ``warmup`` untimed ones.

    ``samples``: optional mono signal; with it each round also times the
    file convolution, split as the reference splits it: "convolute process"
    is the whole ``convolve_audio_file`` call (upload, compute, the copy
    back to the host and any dump), "convolute" the device's share alone,
    ``convolve_audio_file_device_checksum`` on samples already on the
    renderer's device, fenced by its one float."""
    render = StageStats()
    convolute = StageStats()
    convolute_process = StageStats()
    peaks = []

    samples_dev = None
    if samples is not None:
        samples_dev = torch.as_tensor(np.asarray(samples, np.float32)).to(
            renderer.device)

    for i in range(-warmup, rounds):
        generator = round_generator(seed, i, renderer.device)
        t0 = time.perf_counter()
        ir = renderer.render(generator)  # the IR on the host: a fence
        t_render = time.perf_counter() - t0

        t_conv = t_proc = 0.0
        if samples is not None:
            t0 = time.perf_counter()
            out = renderer.convolve_audio_file(samples)
            t_proc = time.perf_counter() - t0
            del out
            t0 = time.perf_counter()
            s_check = renderer.convolve_audio_file_device_checksum(
                samples_dev)
            t_conv = time.perf_counter() - t0
            if not np.isfinite(s_check):
                raise RuntimeError(f"convolution checksum {s_check}")
        if i >= 0:
            render.add(t_render)
            if samples is not None:
                convolute.add(t_conv)
                convolute_process.add(t_proc)
            peaks.append(float(np.max(np.abs(ir))))

    return ExperimentResults(rounds=rounds, render=render, convolute=convolute,
                             convolute_process=convolute_process,
                             ir_peaks=np.asarray(peaks))
