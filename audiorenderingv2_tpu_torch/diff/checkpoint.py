"""Checkpoint and resume of the inverse fit.

The counterpart of ``audiorenderingv2_tpu/diff/checkpoint.py``, and the same
file: a plain ``.npz`` with ``step``, ``losses``, ``n_leaves`` and
``leaf_0 .. leaf_{n-1}``. The leaves come in the order in which the JAX
package flattens ``(theta, opt_state)`` for ``optax.adam``: the parameters
by sorted key, then Adam's step count, then the first moments by sorted key,
then the second moments. So a checkpoint written by either package resumes
in the other.

The optimizer state travels as :class:`AdamState`, which
:func:`adam_state_of` reads from a ``torch.optim.Adam`` and
:func:`load_adam_state` writes into one.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    """Adam's state over a dict of parameters: the number of steps taken,
    and the first (``mu``, torch's ``exp_avg``) and second (``nu``,
    ``exp_avg_sq``) moments by parameter name."""

    count: int
    mu: dict
    nu: dict


def adam_state_of(optimizer: torch.optim.Adam, theta: dict) -> AdamState:
    """The optimizer's state for the parameters ``theta``; zeros for a
    parameter that has taken no step yet."""
    count, mu, nu = 0, {}, {}
    for name, p in theta.items():
        st = optimizer.state.get(p, {})
        count = max(count, int(st.get("step", 0)))
        mu[name] = st.get("exp_avg", torch.zeros_like(p)).detach()
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p)).detach()
    return AdamState(count, mu, nu)


def load_adam_state(optimizer: torch.optim.Adam, theta: dict,
                    state: AdamState) -> None:
    """Put ``state`` into the optimizer, for the parameters ``theta``."""
    for name, p in theta.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(state.count)),
            "exp_avg": torch.tensor(np.asarray(state.mu[name]),
                                    dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(state.nu[name]),
                                       dtype=p.dtype, device=p.device)}


def fit_leaves(theta: dict, state: AdamState) -> list[np.ndarray]:
    """``(theta, state)`` as the flat list of numpy leaves, in the file's
    order (see the module docstring)."""
    names = sorted(theta)
    host = lambda x: torch.as_tensor(x).detach().cpu().numpy()  # noqa: E731
    return ([host(theta[k]) for k in names]
            + [np.asarray(state.count, np.int32)]
            + [host(state.mu[k]) for k in names]
            + [host(state.nu[k]) for k in names])


def fit_from_leaves(leaves: list, theta_like: dict):
    """The inverse of :func:`fit_leaves`: (theta as numpy arrays by name,
    AdamState of numpy arrays); ``theta_like`` gives the names."""
    names = sorted(theta_like)
    m = len(names)
    if len(leaves) != 3 * m + 1:
        raise ValueError(f"{len(leaves)} leaves do not fit {m} parameter(s) "
                         f"with Adam's count and two moments each")
    arr = [np.asarray(x) for x in leaves]
    return (dict(zip(names, arr[:m])),
            AdamState(int(arr[m]), dict(zip(names, arr[m + 1:2 * m + 1])),
                      dict(zip(names, arr[2 * m + 1:]))))


def save_fit_state(path: str | Path, step: int, theta: dict,
                   opt_state: AdamState, losses: list[float]) -> None:
    """Write the fit's state to ``path``.npz."""
    flat = fit_leaves(theta, opt_state)
    np.savez(
        Path(path).with_suffix(".npz"),
        step=np.asarray(step),
        losses=np.asarray(losses, np.float64),
        n_leaves=np.asarray(len(flat)),
        **{f"leaf_{i}": x for i, x in enumerate(flat)},
    )


def load_fit_state(path: str | Path, theta_like: dict):
    """Read (step, theta, opt_state, losses) back, theta and the moments as
    numpy arrays by the names of ``theta_like``; None when there is no
    checkpoint."""
    path = Path(path).with_suffix(".npz")
    if not path.exists():
        return None
    data = np.load(path)
    leaves = [data[f"leaf_{i}"] for i in range(int(data["n_leaves"]))]
    theta, opt_state = fit_from_leaves(leaves, theta_like)
    return int(data["step"]), theta, opt_state, list(data["losses"])
