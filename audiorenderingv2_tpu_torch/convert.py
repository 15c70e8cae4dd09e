"""Carry the JAX package's state across to the port, as numpy arrays.

The tests feed both packages the same scene through these: the JAX
package's ``SceneArrays`` (as a dict of numpy arrays, e.g.
``{k: np.asarray(v) for k, v in sc._asdict().items()}``), its
``TraceParams`` and its ``TracerOptions``; and a fit's parameters and Adam
moments (``fit_state_from_jax``), so that a fit begun in one package goes on
in the other. The tensors land on the card unless ``device`` names
another. Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.params import TraceParams
from .core.tracer import SceneArrays, TracerOptions


def scene_arrays_from_jax(np_arrays: dict,
                          device: torch.device | str = "cuda") -> SceneArrays:
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
    """The port's TracerOptions from the JAX package's. The options that
    change results, the round schedule or the kernel carry over; the ones
    that only tuned the TPU kernels (``rays_per_tile``, ``pallas_unroll``,
    ``pallas_tri_block``, ...) are dropped. ``pallas_layout`` becomes
    ``layout`` (``"auto"`` is ``"rows"``), ``pallas_version`` ``version``,
    ``pallas_precision`` ``precision`` (``"split3"`` is its alias of
    ``"high"``); ``"default"``, a single bf16 pass that corrupts the
    geometry, raises ``ValueError``. The Pallas
    round budgets carry over whatever the JAX backend;
    ``pallas_native_rng`` becomes ``native_rng``, ``pallas_schedule``
    ``schedule``, and the backend ``"xla"`` / ``"pallas"`` becomes
    ``"autograd"`` / ``"kernels"``, with the options that shape the
    differentiable trace (``block_size``, ``tri_chunk``, ``early_exit``,
    ``remat``). The JAX package's default backend is the differentiable
    one, the port's the kernels: default options map to
    ``TracerOptions(backend="autograd")``."""
    return TracerOptions(
        soft_binning=bool(opts.soft_binning),
        compact=bool(opts.pallas_compact),
        round_budgets=opts.pallas_round_budgets,
        native_rng=bool(opts.pallas_native_rng),
        schedule=bool(opts.pallas_schedule),
        backend={"xla": "autograd", "pallas": "kernels"}[opts.backend],
        block_size=int(opts.block_size), tri_chunk=int(opts.tri_chunk),
        early_exit=bool(opts.early_exit), remat=bool(opts.remat),
        layout={"auto": "rows"}.get(opts.pallas_layout, opts.pallas_layout),
        version=int(opts.pallas_version),
        precision={"split3": "high"}.get(opts.pallas_precision,
                                         opts.pallas_precision))


def fit_state_from_jax(leaves_or_npz, theta_like: dict,
                       device: torch.device | str = "cuda"):
    """A JAX fit's state as the port's: ``(theta, opt_state)``.

    ``leaves_or_npz``: the flat leaves of the JAX package's ``(theta,
    opt_state)`` for ``optax.adam`` as numpy arrays, in ``jax.tree.flatten``
    order (parameters by sorted key, Adam's count, first moments, second
    moments), or the path of a checkpoint its ``save_fit_state`` wrote.
    ``theta_like``: a dict with the parameters' names. Returns ``theta``, a
    dict of leaf tensors on ``device`` that require gradients, and the
    ``diff.checkpoint.AdamState`` to hand to ``load_adam_state`` with a
    ``torch.optim.Adam`` over those tensors. One Adam step from there, on
    the same gradient, gives the ``theta`` that optax's gives."""
    from .diff import checkpoint

    if isinstance(leaves_or_npz, (str, bytes)) or hasattr(leaves_or_npz,
                                                          "__fspath__"):
        restored = checkpoint.load_fit_state(leaves_or_npz, theta_like)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint at {leaves_or_npz}")
        _, theta_np, state, _ = restored
    else:
        theta_np, state = checkpoint.fit_from_leaves(list(leaves_or_npz),
                                                     theta_like)
    theta = {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                             device=device).requires_grad_(True)
             for k, v in theta_np.items()}
    return theta, state
