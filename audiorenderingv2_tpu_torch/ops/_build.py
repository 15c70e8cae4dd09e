"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file of this package is compiled to an object by its
own ``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface. The build happens at first
use, into ``audiorenderingv2_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources, the headers they share (``csrc/*.cuh``) and the flags, so a
checkout with nothing built builds itself and an unchanged tree reuses its
library.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``-fmad=false``. The last keeps
``nvcc`` from contracting a multiply and an add into one FMA: the plain
PyTorch versions round every multiply and add on its own, and at 100
bounces one changed ulp moves whole deposits between bins. No
``--use_fast_math``: divisions and square roots stay IEEE-rounded.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libar2kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
# C signatures of csrc/*.cu; every function returns a cudaError_t.
_SIGNATURES = {
    # state, n, ncols, tris, n_tris, scal, n_poses, rays_per_pose, n_bands,
    # layout_bands, budget, max_bounces, stream
    "ar2_trace_round": (_P, _LL, _I, _P, _I, _P, _I, _LL, _I, _I, _I, _I,
                        _P),
    # bins, weights, n_events, n_bins, n_bands, out, stream
    "ar2_histogram": (_P, _P, _LL, _I, _I, _P, _P),
    # bin_f, weights, ear, n_poses, per_pose, n_bands, ir_length, is_mono,
    # delay, scale, out, stream
    "ar2_histogram_binned": (_P, _P, _P, _I, _LL, _I, _I, _I, _I,
                             ctypes.c_float, _P, _P),
    # bins, g, n_events, n_bins, n_bands, g_w, stream
    "ar2_histogram_bwd": (_P, _P, _LL, _I, _I, _P, _P),
    # state, n, boxes, n_clusters, sched, width, stream
    "ar2_tile_schedule": (_P, _LL, _P, _I, _P, _I, _P),
    # state, n, ncols, rows, cluster_size, boxes, sched, width, scal,
    # n_poses, rays_per_pose, n_bands, layout_bands, max_bounces, visits,
    # stream
    "ar2_trace_sched": (_P, _LL, _I, _P, _I, _P, _P, _I, _P, _I, _LL, _I, _I,
                        _I, _P, _P),
    # state, n_pad, ncols, n_real, scal, n_bands, layout_bands, stream
    "ar2_init_state": (_P, _LL, _I, _LL, _P, _I, _I, _P),
    # state, n, ncols, rows, cluster_size, boxes, n_clusters, scal, n_poses,
    # rays_per_pose, n_bands, layout_bands, budget, max_bounces, visits,
    # stream
    "ar2_trace_traverse": (_P, _LL, _I, _P, _I, _P, _I, _P, _I, _LL, _I, _I,
                           _I, _I, _P, _P),
    # state, n, ncols, table (coeffs, or their B fragments with high),
    # attrs, n_groups, attr_cols, scal, n_poses, rays_per_pose, n_bands,
    # layout_bands, budget, max_bounces, high, stream
    "ar2_trace_group": (_P, _LL, _I, _P, _P, _I, _I, _P, _I, _LL, _I, _I, _I,
                        _I, _I, _P),
    # state, n, ncols, frags, n_groups, out, stream
    "ar2_group_probe": (_P, _LL, _I, _P, _I, _P, _P),
    # state, n, tris, n_tris, scal, budget, max_bounces, stream
    "ar2_trace_round_v1": (_P, _LL, _P, _I, _P, _I, _I, _P),
    # state, n, ncols, n_poses, cell_bits, partials, n_blocks, keys, stream
    "ar2_compaction_keys": (_P, _LL, _I, _I, _I, _P, _I, _P, _P),
    # tri_ids, n, k_steps, recv_step, dirs, scal, plane_n, plane_d, normal,
    # absorb, n_tris, n_bands, e0, bin_rate, eps, t_min, r2, ev_bin, ev_w,
    # ev_ear, chord, tan (null: no tangents), stream
    "ar2_replay": (_P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                   _F, _F, _F, _P, _P, _P, _P, _P, _P),
    # tri_ids, n, k_steps, recv_step, chord, g, absorb, n_tris, n_bands, e0,
    # grad (null with tan: no table gradient), g_bin, ev_w, tan (null: no
    # emitter gradient), grad_e, stream
    "ar2_replay_bwd": (_P, _LL, _I, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P,
                       _P, _P, _P),
    # spec, n_freqs, sample_rate, edges (host doubles), n_edges, transition,
    # out, stream
    "ar2_band_split": (_P, _LL, _D, ctypes.POINTER(_D), _I, _D, _P, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set PATH to include its bin/)")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Directory of the library for the current sources, headers and
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> tuple[str, bool]:
    """Run the commands side by side; return their log and whether all
    succeeded."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, ok = "", True
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log += f"$ {' '.join(cmd)}\n{out}# exit {proc.returncode}\n"
        ok = ok and proc.returncode == 0
    return log + f"# {time.perf_counter() - t0:.2f} s\n", ok


# One build at a time in a process: its object files are named by the pid,
# and the first launch may come from a render worker's thread
# (``streaming.AsyncRenderWorker``) while the main thread launches too.
_BUILD_LOCK = threading.Lock()


def build() -> Path:
    """Compile the library if it is not built yet; return its path. The
    compiler's output (registers, shared memory, spills per kernel) is kept
    beside it in ``build.log``. Threads of one process build in turn;
    processes each build under their own names and the last rename wins."""
    with _BUILD_LOCK:
        out_dir = build_dir()
        lib = out_dir / LIB_NAME
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
        log, ok = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                             str(src)] for src, obj in zip(sources(), objs)])
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        if ok:
            link_log, ok = _run_all([[_nvcc(), *ARCH, "-shared", "-o",
                                      str(tmp), *map(str, objs)]])
            log += link_log
        (out_dir / "build.log").write_text(log)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if not ok:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, lib)  # atomic: a loader never sees half a file
        return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ar2_error_string.argtypes = (_I,)
    lib.ar2_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = library().ar2_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, for a C
    entry point. It is read raw, as PyTorch's own generated kernels read
    it: building a ``torch.cuda.Stream`` to read it cost the host 3.4-6.0
    us a call beside an H100, the raw read 0.2 us
    (``benchmarks/torch_trace_ab.py``, ``bwd`` phase), at shapes where the
    kernel itself takes 20-60 us."""
    return torch._C._cuda_getCurrentRawStream(device.index)
