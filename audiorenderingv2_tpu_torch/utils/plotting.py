"""[Copy of audiorenderingv2_tpu/utils/plotting.py: numpy only (matplotlib imported when a plot is drawn), kept equal to it by tests/test_torch_utils.py.]

IR / output plotting (matplotlib, optional dependency).

Covers the reference's offline Python plotting utils (utils/main.py,
utils/printIR.py): plot dumped IRs and convolved outputs, single or batch.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("matplotlib is required for plotting") from e


def plot_ir(ir: np.ndarray, sample_rate: int, path: str | Path,
            title: str = "Impulse response") -> None:
    """Plot a stereo (or mono) IR against time and save to ``path``."""
    plt = _plt()
    ir = np.atleast_2d(np.asarray(ir))
    t = np.arange(ir.shape[1]) / sample_rate
    fig, axes = plt.subplots(ir.shape[0], 1, sharex=True, figsize=(10, 5))
    axes = np.atleast_1d(axes)
    labels = ["left", "right"]
    for i, ax in enumerate(axes):
        ax.plot(t, ir[i], linewidth=0.5)
        ax.set_ylabel(labels[i] if i < 2 else f"ch{i}")
    axes[-1].set_xlabel("time [s]")
    axes[0].set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_signal(x: np.ndarray, sample_rate: int, path: str | Path,
                title: str = "Signal") -> None:
    plt = _plt()
    x = np.atleast_2d(np.asarray(x))
    t = np.arange(x.shape[1]) / sample_rate
    fig, ax = plt.subplots(figsize=(10, 3))
    for i in range(x.shape[0]):
        ax.plot(t, x[i], linewidth=0.5, label=f"ch{i}")
    ax.set_xlabel("time [s]")
    ax.set_title(title)
    if x.shape[0] > 1:
        ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_scene(scene, path: str | Path, emitter=None, receiver=None,
               title: str = "Scene") -> None:
    """3-D wireframe of the scene with emitter/receiver markers — the
    offline stand-in for the reference's OpenGL debug view (Mesh.cpp,
    assets/shaders)."""
    plt = _plt()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    t = scene.n_triangles
    tris = np.stack([scene.v0[:t], scene.v1[:t], scene.v2[:t]], axis=1)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    coll = Poly3DCollection(tris, alpha=0.15, facecolor="tab:blue",
                            edgecolor="gray", linewidths=0.3)
    ax.add_collection3d(coll)
    if emitter is not None:
        e = np.asarray(emitter)
        ax.scatter(*e, color="tab:red", s=60, label="emitter")
    if receiver is not None:
        r = np.asarray(receiver)
        ax.scatter(*r, color="tab:green", s=60, label="receiver")
    lo = np.minimum(scene.bounds_min, -1)
    hi = np.maximum(scene.bounds_max, 1)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_title(title)
    if emitter is not None or receiver is not None:
        ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_ir_files(prefix_dir: str | Path, prefix: str, out_path: str | Path,
                  sample_rate: int = 16000) -> int:
    """Batch-plot text IR dumps matching ``prefix*`` (utils/main.py's regex
    batch mode). Returns the number of files plotted."""
    plt = _plt()
    files = sorted(Path(prefix_dir).glob(prefix + "*"))
    if not files:
        return 0
    fig, ax = plt.subplots(figsize=(10, 4))
    for f in files:
        data = np.loadtxt(f)
        ax.plot(np.arange(len(data)) / sample_rate, data, linewidth=0.4,
                alpha=0.7, label=f.name)
    ax.set_xlabel("time [s]")
    ax.legend(fontsize=6)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return len(files)
