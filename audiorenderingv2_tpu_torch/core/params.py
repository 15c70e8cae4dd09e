"""Static trace parameters, shared by the tracer, its kernels and the tests.

The counterpart of ``audiorenderingv2_tpu/core/tracer_ref.py:TraceParams``:
same fields, same defaults, same derived thresholds.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import constants


@dataclass(frozen=True)
class TraceParams:
    """Static tracing parameters."""

    sample_rate: int
    ir_length: int  # bins = ir_seconds * sample_rate
    base_power: float = 100.0
    energy_threshold: float = 0.0
    max_bounces: int = 10
    hrtf_absorption_rate: float = constants.DEFAULT_HRTF_ABSORPTION
    is_mono: bool = False
    # Frequency bands for per-band absorption (1 = broadband). With B > 1
    # the scene's absorption is [T, B] and the IR gains a band axis.
    n_bands: int = 1

    @property
    def distance_threshold(self) -> float:
        ir_seconds = max(constants.IR_SECONDS_MIN,
                         min(self.ir_length // self.sample_rate,
                             constants.IR_SECONDS_MAX))
        return ir_seconds * constants.SPEED_OF_SOUND + 1.0

    @property
    def cross_ear_delay(self) -> int:
        # C truncation, not rounding (devicePrograms.cu:125).
        return int(self.sample_rate * constants.HEAD_DELAY_SECONDS)
