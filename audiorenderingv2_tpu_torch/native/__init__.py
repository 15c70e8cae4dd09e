"""ctypes binding to the native C++ audio runtime (``native/`` at the repo
root).

The counterpart of ``audiorenderingv2_tpu/native/__init__.py``, over the
same C++ sources (``native/audio_engine.cpp``, ``native/ring_buffer.h``):

  * NativeRingBuffer: the accumulate/drain ring buffer (CircularBuffer.h
    semantics), C++ implementation of ``streaming.RingBuffer``.
  * NativeAudioEngine: the RtAudio-equivalent streaming pump: a C++ thread
    drains interleaved blocks from the ring at the sample-rate cadence (or
    free-running offline) into a float64 sink file.

The shared library is built with ``g++`` at first use (never at import)
into ``audiorenderingv2_tpu_torch/_build/native/<hash>/``, keyed by a hash
of the sources and the flags; nothing is written beside the sources. A
failed build raises with the compiler's output; ``available()`` says
whether the library loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG.parent / "native"
BUILD_ROOT = _PKG / "_build" / "native"
SOURCES = ("audio_engine.cpp", "ring_buffer.h")
LIB_NAME = "libar2native.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_dir(source_dir: Path = SOURCE_DIR,
              build_root: Path = BUILD_ROOT) -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((Path(source_dir) / name).read_bytes())
    return Path(build_root) / h.hexdigest()[:16]


def build(source_dir: Path = SOURCE_DIR,
          build_root: Path = BUILD_ROOT) -> Path:
    """Compile the library if it is not built yet; return its path. Raises
    RuntimeError when ``g++`` is missing or fails."""
    out_dir = build_dir(source_dir, build_root)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, str(Path(source_dir) / SOURCES[0]), "-o",
           str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except FileNotFoundError as e:
        raise RuntimeError("native library: g++ not found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library: {' '.join(cmd)} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built on first call (one build at a time in a
    process)."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.ar2_ring_create.restype = ctypes.c_void_p
    lib.ar2_ring_create.argtypes = [ctypes.c_size_t]
    lib.ar2_ring_destroy.restype = None
    lib.ar2_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ar2_ring_add.restype = None
    lib.ar2_ring_add.argtypes = [ctypes.c_void_p, dptr, ctypes.c_size_t]
    lib.ar2_ring_get_and_reset.restype = None
    lib.ar2_ring_get_and_reset.argtypes = [ctypes.c_void_p, dptr,
                                           ctypes.c_size_t]
    lib.ar2_engine_create.restype = ctypes.c_void_p
    lib.ar2_engine_create.argtypes = [
        ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_int]
    for name in ("ar2_engine_destroy", "ar2_engine_start",
                 "ar2_engine_stop"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ar2_engine_add.restype = None
    lib.ar2_engine_add.argtypes = [ctypes.c_void_p, dptr, ctypes.c_size_t]
    lib.ar2_engine_drain_ticks.restype = None
    lib.ar2_engine_drain_ticks.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ar2_engine_frames_streamed.restype = ctypes.c_uint64
    lib.ar2_engine_frames_streamed.argtypes = [ctypes.c_void_p]
    lib.ar2_engine_underruns.restype = ctypes.c_uint64
    lib.ar2_engine_underruns.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True if the native library is built or builds here."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def _as_dptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRingBuffer:
    """C++ accumulate/drain ring buffer; drop-in for streaming.RingBuffer."""

    def __init__(self, capacity: int):
        self._lib = library()
        self._h = self._lib.ar2_ring_create(capacity)
        self.capacity = int(capacity)

    def add(self, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, np.float64)
        if values.shape[0] > self.capacity:
            raise ValueError("more values than capacity")
        self._lib.ar2_ring_add(self._h, _as_dptr(values), values.shape[0])

    def get_and_reset(self, n: int) -> np.ndarray:
        if n > self.capacity:
            raise ValueError("more values than capacity")
        out = np.empty(n, np.float64)
        self._lib.ar2_ring_get_and_reset(self._h, _as_dptr(out), n)
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ar2_ring_destroy(self._h)
            self._h = None


class NativeAudioEngine:
    """The RtAudio-equivalent streaming pump (see module docstring).

    ``realtime=True`` paces ticks at the wall-clock sample rate (the live
    auralization mode); ``realtime=False`` free-runs for offline drains.
    The sink is raw little-endian float64 interleaved frames.
    """

    def __init__(self, sink_path: str, *, ring_capacity: int,
                 sample_rate: int, channels: int = 2,
                 frames_per_buffer: int = 256, realtime: bool = False):
        self._lib = library()
        self._h = self._lib.ar2_engine_create(
            ring_capacity, sample_rate, channels, frames_per_buffer,
            str(sink_path).encode(), 1 if realtime else 0)
        if not self._h:
            raise RuntimeError(f"cannot open sink {sink_path}")
        self.channels = channels
        self.frames_per_buffer = frames_per_buffer
        self.ring_capacity = int(ring_capacity)

    def add(self, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, np.float64)
        if values.shape[0] > self.ring_capacity:
            # The C++ Add wraps silently past a full ring, stacking later
            # samples onto earlier slots; mirror NativeRingBuffer's guard.
            raise ValueError(f"{values.shape[0]} values exceed the ring "
                             f"capacity {self.ring_capacity}")
        self._lib.ar2_engine_add(self._h, _as_dptr(values), values.shape[0])

    def start(self) -> None:
        self._lib.ar2_engine_start(self._h)

    def stop(self) -> None:
        self._lib.ar2_engine_stop(self._h)

    def drain_ticks(self, ticks: int) -> None:
        """Synchronously stream ``ticks`` buffers (offline mode). No-op
        while start()ed: the pacing thread owns the sink then; stop()
        first."""
        self._lib.ar2_engine_drain_ticks(self._h, ticks)

    @property
    def frames_streamed(self) -> int:
        return int(self._lib.ar2_engine_frames_streamed(self._h))

    @property
    def underruns(self) -> int:
        return int(self._lib.ar2_engine_underruns(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ar2_engine_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
