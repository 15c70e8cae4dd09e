"""Carry the JAX package's state across to the port, as numpy arrays.

The tests feed both packages the same scene through these: the JAX
package's ``SceneArrays`` (as a dict of numpy arrays, e.g.
``{k: np.asarray(v) for k, v in sc._asdict().items()}``), its
``TraceParams`` and its ``TracerOptions``. Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.params import TraceParams
from .core.tracer import SceneArrays, TracerOptions


def scene_arrays_from_jax(np_arrays: dict,
                          device: torch.device | str = "cpu") -> SceneArrays:
    """The port's SceneArrays from the JAX package's, given as numpy arrays
    keyed by field name; ``cluster_boxes`` may be absent or None."""
    return SceneArrays(**{
        f: None if np_arrays.get(f) is None else torch.tensor(
            np.asarray(np_arrays[f]), dtype=torch.float32, device=device)
        for f in SceneArrays._fields})


def scene_arrays_to_numpy(sc: SceneArrays) -> dict:
    """The port's SceneArrays as a dict of numpy arrays (the inverse)."""
    return {f: None if getattr(sc, f) is None else getattr(sc, f).cpu().numpy()
            for f in SceneArrays._fields}


def trace_params_from_jax(params) -> TraceParams:
    """The port's TraceParams from the JAX package's (any object with the
    same fields)."""
    return TraceParams(**{f.name: getattr(params, f.name)
                          for f in dataclasses.fields(TraceParams)})


def tracer_options_from_jax(opts) -> TracerOptions:
    """The port's TracerOptions from the JAX package's. Only the options
    that change results or the round schedule carry over; the ones that
    tuned the TPU kernels (``pallas_precision``, ``pallas_layout``,
    ``rays_per_tile``, ``pallas_unroll``, ...) are dropped. The Pallas
    round budgets carry over whatever the JAX backend, as the port has one
    path; ``pallas_native_rng`` becomes ``native_rng``."""
    return TracerOptions(soft_binning=bool(opts.soft_binning),
                         compact=bool(opts.pallas_compact),
                         round_budgets=opts.pallas_round_budgets,
                         native_rng=bool(opts.pallas_native_rng))
