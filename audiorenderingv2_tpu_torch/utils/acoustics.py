"""[Copy of audiorenderingv2_tpu/utils/acoustics.py: numpy only, kept equal to it by tests/test_torch_utils.py.]

Room-acoustics metrics computed from rendered impulse responses.

The reference ships only raw IR dumps and eyeball plots (utils/printIR.py);
production acoustic work reads standard ISO 3382-style metrics off the IR.
All functions take an ENERGY impulse response (the tracer's histograms are
already energy, not pressure; for a pressure IR pass ``ir**2``).

Implemented: Schroeder backward integration, RT60 via T20/T30 fits, EDT,
clarity (C50/C80), definition (D50), direct-to-reverberant ratio, and a
one-call summary.
"""
from __future__ import annotations

import numpy as np


def schroeder_curve(energy_ir: np.ndarray) -> np.ndarray:
    """Backward-integrated energy decay in dB (0 dB at t=0)."""
    e = np.asarray(energy_ir, np.float64)
    tail = np.cumsum(e[::-1])[::-1]
    total = tail[0] if tail[0] > 0 else 1.0
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(np.maximum(tail / total, 1e-30))


def _decay_fit_rt60(curve_db: np.ndarray, sample_rate: int,
                    hi: float, lo: float) -> float:
    """RT60 by linear fit of the Schroeder curve between hi and lo dB."""
    idx = np.arange(len(curve_db))
    mask = (curve_db <= hi) & (curve_db >= lo)
    if mask.sum() < 2:
        return float("nan")
    t = idx[mask] / sample_rate
    y = curve_db[mask]
    slope, _ = np.polyfit(t, y, 1)
    if slope >= 0:
        return float("nan")
    return float(-60.0 / slope)


def rt60(energy_ir: np.ndarray, sample_rate: int, kind: str = "t30") -> float:
    """Reverberation time [s] from the decay curve.

    kind: 't30' fits -5..-35 dB, 't20' fits -5..-25 dB (both extrapolated
    to 60 dB of decay, per ISO 3382-1).
    """
    curve = schroeder_curve(energy_ir)
    if kind == "t30":
        return _decay_fit_rt60(curve, sample_rate, -5.0, -35.0)
    if kind == "t20":
        return _decay_fit_rt60(curve, sample_rate, -5.0, -25.0)
    raise ValueError(kind)


def edt(energy_ir: np.ndarray, sample_rate: int) -> float:
    """Early decay time [s]: 0..-10 dB fit extrapolated to 60 dB."""
    return _decay_fit_rt60(schroeder_curve(energy_ir), sample_rate, 0.0, -10.0)


def _split_energy(energy_ir: np.ndarray, sample_rate: int, ms: float):
    k = int(round(ms * 1e-3 * sample_rate))
    e = np.asarray(energy_ir, np.float64)
    return e[:k].sum(), e[k:].sum()


def clarity(energy_ir: np.ndarray, sample_rate: int, ms: float = 80.0) -> float:
    """C_t [dB]: early-to-late energy ratio (C80 default, C50 with ms=50)."""
    early, late = _split_energy(energy_ir, sample_rate, ms)
    if late <= 0:
        return float("inf")
    return float(10.0 * np.log10(max(early, 1e-30) / late))


def definition(energy_ir: np.ndarray, sample_rate: int, ms: float = 50.0) -> float:
    """D_t (0..1): early energy fraction (D50 default)."""
    early, late = _split_energy(energy_ir, sample_rate, ms)
    total = early + late
    return float(early / total) if total > 0 else 0.0


def direct_to_reverberant(energy_ir: np.ndarray, sample_rate: int,
                          window_ms: float = 2.5) -> float:
    """DRR [dB]: energy within +-window of the strongest arrival vs the rest."""
    e = np.asarray(energy_ir, np.float64)
    peak = int(np.argmax(e))
    w = int(round(window_ms * 1e-3 * sample_rate))
    lo, hi = max(0, peak - w), min(len(e), peak + w + 1)
    direct = e[lo:hi].sum()
    rest = e.sum() - direct
    if rest <= 0:
        return float("inf")
    return float(10.0 * np.log10(max(direct, 1e-30) / rest))


def summarize(ir: np.ndarray, sample_rate: int) -> dict:
    """All metrics for a stereo (or mono/banded) energy IR.

    ir: [bins], [2, bins], or [2, n_bands, bins]; channels are averaged
    into one energy decay (ISO averages positions; here ears).
    """
    e = np.asarray(ir, np.float64)
    while e.ndim > 1:
        e = e.mean(axis=0)
    return {
        "rt60_t30_s": rt60(e, sample_rate, "t30"),
        "rt60_t20_s": rt60(e, sample_rate, "t20"),
        "edt_s": edt(e, sample_rate),
        "c50_db": clarity(e, sample_rate, 50.0),
        "c80_db": clarity(e, sample_rate, 80.0),
        "d50": definition(e, sample_rate, 50.0),
        "drr_db": direct_to_reverberant(e, sample_rate),
    }
