"""The least bytes of the replay kernel pair, counted from the program's
counters of a recording and the scene's size, and nothing of the kernels'
design.

A replay of recorded paths with the poses and the geometry fixed
(``diff/replay.py``) has to move, in float32 and int32:

* forward: for each depositing ray its direction (3 values) and its
  ``recv_step`` (1), and it writes the ray's event: its arrival bin, its
  ear (2) and its ``n_bands`` weights; for each recorded step it walks
  (``replay_steps``: the steps before each depositing ray's
  ``recv_step``) the step's triangle id; and each triangle's row once:
  its unit normal and offset (4 values: the plane, whose normal the
  reflection also takes) and its ``n_bands`` absorptions;
* backward: for each depositing ray its ``recv_step``, the loss's
  gradient of its ``n_bands`` weights and one value the forward kept of
  it (its chord); for each step the triangle id; the table's
  ``n_triangles`` rows of ``n_bands`` absorptions read once and their
  gradient written once. It needs no geometry: a weight is its chord
  times the products of (1 - absorption) along the path.

Each value is 4 bytes. A triangle's row is counted once however many rays
visit it: the rows of a scene (19,852 x 12 values at 8 bands on the
office, about 1 MB) fit the card's L2 cache, so no replay has to fetch a
row from memory at each visit. The rays that deposit nothing are counted
nowhere. ``yardstick.HBM_BYTES_PER_S`` turns the bytes into the pair's
least time.
"""
from __future__ import annotations

from . import yardstick

WORD = 4


def forward_bytes(n_bands: int, n_triangles: int, deposits: int,
                  steps: int) -> float:
    """Least bytes of the replay's forward."""
    return WORD * (deposits * (3 + 1 + 2 + n_bands) + steps
                   + n_triangles * (4 + n_bands))


def backward_bytes(n_bands: int, n_triangles: int, deposits: int,
                   steps: int) -> float:
    """Least bytes of the replay's backward."""
    return WORD * (deposits * (1 + n_bands + 1) + steps
                   + 2 * n_triangles * n_bands)


def pair_bound_s(n_bands: int, n_triangles: int, deposits: int,
                 steps: int) -> float:
    """Least time of one forward and one backward over the paths of a
    recording."""
    args = (n_bands, n_triangles, deposits, steps)
    return (forward_bytes(*args) + backward_bytes(*args)) \
        / yardstick.HBM_BYTES_PER_S
