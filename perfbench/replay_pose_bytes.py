"""The least bytes of the pose replay pair, the replay that also carries
the emitter's gradient, counted from the program's counters of a
recording and the scene's size, and nothing of the kernels' design.

A replay of recorded paths in which the emitter requires a gradient moves
all that ``replay_bytes`` counts for the absorption pair, and more:

* forward: for each depositing ray the 6 values of its event's tangents
  against the emitter (the arrival's and the chord's, 3 each), written;
  the emitter's 3 values, read;
* backward: for each depositing ray the loss's gradient of its arrival
  (1 value) and its 6 tangents, read; the emitter's gradient (3 values),
  written.

Each value is 4 bytes. ``yardstick.HBM_BYTES_PER_S`` turns the bytes into
the pair's least time.
"""
from __future__ import annotations

from . import replay_bytes, yardstick

WORD = replay_bytes.WORD
TANGENTS = 6


def forward_bytes(n_bands: int, n_triangles: int, deposits: int,
                  steps: int) -> float:
    """Least bytes of the pose replay's forward."""
    return (replay_bytes.forward_bytes(n_bands, n_triangles, deposits, steps)
            + WORD * (deposits * TANGENTS + 3))


def backward_bytes(n_bands: int, n_triangles: int, deposits: int,
                   steps: int) -> float:
    """Least bytes of the pose replay's backward."""
    return (replay_bytes.backward_bytes(n_bands, n_triangles, deposits,
                                        steps)
            + WORD * (deposits * (1 + TANGENTS) + 3))


def pair_bound_s(n_bands: int, n_triangles: int, deposits: int,
                 steps: int) -> float:
    """Least time of one forward and one backward over the paths of a
    recording (``deposits`` and ``steps`` summed over its receivers' path
    sets: one launch could walk them all, so each triangle's row is still
    counted once)."""
    args = (n_bands, n_triangles, deposits, steps)
    return (forward_bytes(*args) + backward_bytes(*args)) \
        / yardstick.HBM_BYTES_PER_S
