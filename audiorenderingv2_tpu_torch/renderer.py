"""AudioRenderer: the render/convolve facade.

The counterpart of ``audiorenderingv2_tpu/renderer.py``. It owns the scene
tensors on one device (built once per scene: the receiver is an analytic
sphere, so pose changes never touch geometry), the trace parameters, an
explicit ``torch.Generator`` for the ray directions, and the last IR, kept
on the device for the convolutions.

A scene with per-band absorption ([T, n_bands]) switches the whole pipeline
to per-band IRs and filterbank auralization (``ops/filterbank.py``).

Public surface as in the JAX package: ``render``, ``convolve_audio_file``,
``convolve_live_input`` (the live path of ``streaming.LiveConvolver``), the
setters and ``full_render_cycle``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from . import constants, tuned
from .core.params import TraceParams
from .core.tracer import (TracerOptions, packed_scene, render_ir,
                          scene_to_arrays)
from .ops import convolve, filterbank
from .scene import Scene
from .utils import profiling
from .utils.logging import get_logger


class AudioRenderer:
    """Renders binaural impulse responses and convolves audio with them.

    Args:
      scene: host-side Scene (absorptions already resolved).
      ir_seconds: IR length in seconds.
      sample_rate: audio sample rate; the IR bin rate equals it.
      n_rays: rays per render.
      base_power, energy_threshold, max_bounces, hrtf_absorption_rate,
      is_mono: pathtracer parameters (config.json).
      opts: tracer options; None = ``tuned.auto_options`` for the scene.
        ``tuned.prepare`` sorts the scene into its clusters for them, and
        ``core.tracer.trace_route`` picks the kernels.
      seed: seed of the direction generator; renders draw from it in turn,
        so the sequence of IRs is reproducible.
      device: where the scene, the trace and the IR live. A CUDA device
        runs the kernels, the CPU their plain versions.
      band_edges: crossover frequencies [Hz] of the filterbank that
        auralizes a banded IR; n_bands - 1 of them.
    """

    def __init__(
        self,
        scene: Scene,
        ir_seconds: int,
        sample_rate: int,
        n_rays: int,
        *,
        base_power: float = 100.0,
        energy_threshold: float = 0.0,
        max_bounces: int = 10,
        hrtf_absorption_rate: float = constants.DEFAULT_HRTF_ABSORPTION,
        is_mono: bool = False,
        opts: TracerOptions | None = None,
        seed: int = 0,
        device: torch.device | str = "cuda",
        band_edges: tuple = filterbank.DEFAULT_BAND_EDGES,
    ):
        self.device = torch.device(device)
        self.n_rays = int(n_rays)
        self._auto_opts = opts is None
        opts, scene, clusters = tuned.prepare(scene, int(max_bounces), opts)
        self.opts = opts
        self.scene = scene
        self.sc = scene_to_arrays(scene, tri_chunk=128, device=self.device,
                                  clusters=clusters)
        self.params = TraceParams(
            sample_rate=int(sample_rate),
            ir_length=int(ir_seconds) * int(sample_rate),
            base_power=float(base_power),
            energy_threshold=float(energy_threshold),
            max_bounces=int(max_bounces),
            hrtf_absorption_rate=float(hrtf_absorption_rate),
            is_mono=bool(is_mono),
            n_bands=(scene.absorption.shape[1]
                     if scene.absorption.ndim == 2 else 1),
        )
        self.band_edges = tuple(band_edges)
        # The triangles as the options' kernel reads them (and the cluster
        # boxes), packed once: the trim at the last valid triangle reads it
        # back to the host.
        self.rows, self.boxes = packed_scene(self.sc, self.params, None,
                                             None, opts)
        self.emitter_pos = np.zeros(3, np.float32)
        self.receiver_pos = np.zeros(3, np.float32)
        self.receiver_yaw_deg = 0.0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._ir_dev: torch.Tensor | None = None
        self._ir: np.ndarray | None = None
        # The last render's counters (profiling.count), {} when no profiler
        # recorded it.
        self.counters: dict = {}
        # One-shot debug dumps (config write_first_* keys).
        self.write_ir_to_file_flag = False
        self.write_output_to_file_flag = False
        self.dump_dir = "."
        # Serialises full_render_cycle against concurrent audio pulls.
        self.lock = threading.RLock()

    # ------------------------------------------------------------- setters
    def set_emitter_pos(self, pos) -> None:
        self.emitter_pos = np.asarray(pos, np.float32)

    def set_receiver(self, pos, yaw_deg: float) -> None:
        self.receiver_pos = np.asarray(pos, np.float32)
        self.receiver_yaw_deg = float(yaw_deg)

    def set_thresholds(self, energy_threshold: float, max_bounces: int) -> None:
        self.params = dataclasses.replace(
            self.params, energy_threshold=float(energy_threshold),
            max_bounces=int(max_bounces))
        if self._auto_opts:
            # Auto options carry round budgets scaled to max_bounces; rescale
            # them so a deeper limit never trips the budget-sum guard.
            self.opts, _ = tuned.auto_options(self.scene.n_triangles,
                                              int(max_bounces))

    def set_base_power(self, base_power: float) -> None:
        self.params = dataclasses.replace(self.params,
                                          base_power=float(base_power))

    def set_hrtf_absorption_rate(self, rate: float) -> None:
        self.params = dataclasses.replace(self.params,
                                          hrtf_absorption_rate=float(rate))

    def set_mono_output(self, is_mono: bool) -> None:
        self.params = dataclasses.replace(self.params, is_mono=bool(is_mono))

    # ------------------------------------------------------------- render
    def render(self, generator: torch.Generator | None = None) -> np.ndarray:
        """Trace a fresh IR from the renderer's generator (or ``generator``)
        and return it as float32 [2, ir_length] (left, right), or
        [2, n_bands, ir_length] for a banded scene. The IR also
        stays on the device (``ir_device``) for the convolutions. While a
        ``torch.profiler`` records, the trace's counters of the render
        (``rays_alive`` and, on the schedule route, ``sched_candidates`` a
        round; ``n_rays``, ``n_tiles``; for a banded IR ``n_bands`` and
        ``band_energy``, each band's energy summed over both ears and every
        bin) are read after the IR's copy and kept in ``counters``."""
        if generator is None:
            generator = self.generator
        with profiling.span("ar2.render"), profiling.collect() as counters:
            ir = render_ir(self.sc, generator, self.n_rays,
                           self.emitter_pos, self.receiver_pos,
                           self.receiver_yaw_deg, self.params, self.opts,
                           rows=self.rows, boxes=self.boxes)
            if self.params.is_mono:
                # addIRs fold: both ears carry the sum (kernels.cu:519-536).
                ir = ir.sum(dim=0, keepdim=True).expand_as(ir).contiguous()
            self._ir_dev = ir
            if ir.dim() == 3:  # banded: the bands and each one's energy
                profiling.count("n_bands", lambda: ir.shape[1], once=True)
                profiling.count_each("band_energy",
                                     lambda: ir.sum(dim=(0, 2)))
            with profiling.span("ar2.ir_to_host"):
                self._ir = ir.cpu().numpy()
            self.counters = counters.read()
        if self.write_ir_to_file_flag:
            self.dump_ir()
            self.write_ir_to_file_flag = False  # one-shot, like the reference
        return self._ir

    @property
    def ir(self) -> np.ndarray | None:
        """Last rendered IR on the host, [2(, n_bands), ir_length]."""
        return self._ir

    @property
    def ir_device(self) -> torch.Tensor | None:
        """Last rendered IR on the renderer's device, [2(, n_bands),
        ir_length]."""
        return self._ir_dev

    def dump_ir(self, prefix: str = "output_ir") -> tuple[str, str]:
        """Write the current IR as one-value-per-line text files."""
        if self._ir is None:
            raise RuntimeError("render() an IR first")
        paths = []
        for name, channel in (("left", self._ir[0]), ("right", self._ir[1])):
            path = os.path.join(self.dump_dir, f"{prefix}_{name}.txt")
            np.savetxt(path, channel, fmt="%.9g")
            paths.append(path)
        return tuple(paths)

    # --------------------------------------------------------- convolution
    def convolve_audio_file_device(self, samples) -> torch.Tensor:
        """Convolve a full signal with the current IR on the device; returns
        the f32 [2, L] tensor there, with no host copy and no dump."""
        if self._ir_dev is None:
            raise RuntimeError("render() an IR first")
        if self._ir_dev.dim() == 3:  # banded IR: filterbank auralization
            return filterbank.convolve_file_banded(
                samples, self._ir_dev, self.params.sample_rate,
                self.band_edges)
        return convolve.convolve_file_stereo(samples, self._ir_dev,
                                             self.params.sample_rate)

    def convolve_audio_file_device_checksum(self, samples) -> float:
        """The device convolution of ``samples`` (an array, or a tensor
        already on the device) reduced to the sum of its output, read back
        as one float: the fence of a timed convolution. The float exists
        only once the convolution has run, where the call alone returns
        as soon as a CUDA device has the work queued."""
        return float(self.convolve_audio_file_device(samples).sum())

    def convolve_audio_file(self, samples) -> np.ndarray:
        """Convolve a full signal (an array, or a tensor on any device,
        which moves to the renderer's) with the current IR: overlap-add per
        1 s segment, output truncated to the input length. Returns float32
        [2, L] on the host."""
        if not isinstance(samples, torch.Tensor):
            samples = np.asarray(samples, np.float32)
        with profiling.span("ar2.convolve"):
            out = self.convolve_audio_file_device(samples).cpu().numpy()
        if self.write_output_to_file_flag:
            for name, channel in (("left", out[0]), ("right", out[1])):
                np.savetxt(os.path.join(self.dump_dir,
                                        f"output_convolute_{name}.txt"),
                           channel, fmt="%.9g")
            self.write_output_to_file_flag = False
        return out

    def convolve_live_input(self, block, ring_buffer) -> None:
        """Convolve one live input block [n_frames] with the current IR and
        add it to ``ring_buffer`` (``streaming.RingBuffer`` or
        ``native.NativeRingBuffer``; convoluteLiveInput,
        AudioRenderer.cpp:593-660). The block is zero-padded to ir_length on
        the IR's device and circularly convolved with both ears (through the
        filterbank for a banded IR); the LRLR interleave of the two comes to
        the host in one copy, [2 * ir_length] f32, for the ring's
        accumulate."""
        if self._ir_dev is None:
            raise RuntimeError("render() an IR first")
        n = self.params.ir_length
        block = torch.as_tensor(block, dtype=torch.float32,
                                device=self._ir_dev.device)
        if block.shape[0] > n:
            raise ValueError("live block longer than the IR")
        padded = torch.nn.functional.pad(block, (0, n - block.shape[0]))
        if self._ir_dev.dim() == 3:
            out = filterbank.convolve_live_banded(
                padded, self._ir_dev, self.params.sample_rate,
                self.band_edges)
        else:
            out = convolve.convolve_live(padded, self._ir_dev)
        ring_buffer.add(convolve.interleave_stereo(out[0], out[1])
                        .cpu().numpy())

    # ---------------------------------------------------------- full cycle
    def full_render_cycle(self, receiver_pos, receiver_yaw_deg: float,
                          samples) -> np.ndarray:
        """Move the listener, re-render, convolve; returns the stereo
        output [2, L] on the host. ``samples``: an array, or a tensor on
        any device (``streaming.Auralizer`` stages it once on the
        renderer's).

        Emits one ``full_render_cycle`` record through ``utils.logging``
        (silent until configured): ``render_ms``, fenced by ``render``'s
        copy of the IR to the host, and ``convolve_ms``, fenced by the
        output's; a cycle a ``torch.profiler`` recorded adds the render's
        ``counters``."""
        with self.lock, profiling.span("ar2.cycle"):
            t0 = time.perf_counter()
            self.set_receiver(receiver_pos, receiver_yaw_deg)
            self.render()
            t_render = time.perf_counter() - t0
            out = self.convolve_audio_file(samples)
            get_logger().event(
                "full_render_cycle",
                render_ms=round(t_render * 1e3, 3),
                convolve_ms=round((time.perf_counter() - t0 - t_render)
                                  * 1e3, 3),
                receiver=list(np.asarray(receiver_pos, dtype=float)),
                yaw_deg=float(receiver_yaw_deg), **self.counters)
            return out
