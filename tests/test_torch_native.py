"""The port's ctypes binding to the native C++ runtime: the ring buffer
against ``streaming.RingBuffer``, the engine offline and paced, and where
the library is built."""
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from audiorenderingv2_tpu_torch import native
from audiorenderingv2_tpu_torch.streaming import RingBuffer

REPO = Path(__file__).resolve().parent.parent


def test_native_ring_matches_python():
    """50 seeded adds and drains that wrap: the C++ ring drains what the
    numpy one does, bit for bit (both add float64 in index order)."""
    rng = np.random.default_rng(0)
    py = RingBuffer(37)
    nat = native.NativeRingBuffer(37)
    for _ in range(50):
        vals = rng.normal(size=int(rng.integers(1, 37)))
        py.add(vals)
        nat.add(vals)
        m = int(rng.integers(1, 37))
        np.testing.assert_array_equal(nat.get_and_reset(m),
                                      py.get_and_reset(m))
    with pytest.raises(ValueError, match="capacity"):
        nat.add(np.zeros(38))


def test_engine_offline_stream(tmp_path):
    sink = tmp_path / "out.f64"
    eng = native.NativeAudioEngine(str(sink), ring_capacity=1024,
                                   sample_rate=16000, channels=2,
                                   frames_per_buffer=64, realtime=False)
    block = np.arange(256, dtype=np.float64)
    eng.add(block)
    eng.drain_ticks(2)  # 2 * 64 frames * 2 channels = 256 samples
    assert eng.frames_streamed == 128 and eng.underruns == 0
    with pytest.raises(ValueError, match="exceed the ring"):
        eng.add(np.zeros(1025))
    eng.close()
    np.testing.assert_array_equal(np.fromfile(sink, dtype="<f8"), block)


def test_engine_realtime_thread(tmp_path):
    """The paced thread for 0.25 s at 16 kHz (about 4000 frames); the JAX
    test's bounds, wide for a loaded host."""
    sink = tmp_path / "live.f64"
    eng = native.NativeAudioEngine(str(sink), ring_capacity=65536,
                                   sample_rate=16000, channels=2,
                                   frames_per_buffer=256, realtime=True)
    eng.add(np.ones(32768))
    eng.start()
    time.sleep(0.25)
    eng.stop()
    assert 1000 < eng.frames_streamed < 16000
    streamed = eng.frames_streamed
    eng.close()
    data = np.fromfile(sink, dtype="<f8")
    assert len(data) == streamed * 2
    assert (data[: min(len(data), 32768)] == 1.0).all()


def test_library_is_built_under_build_not_beside_the_sources(tmp_path):
    """The loaded library lives in ``_build/native/<hash>/``; a build from a
    copy of ``native/`` writes nothing into that copy, and a source that
    does not compile raises with the compiler's output."""
    lib = native.build()
    assert native.available()
    assert lib.parent.parent == REPO / "audiorenderingv2_tpu_torch" / \
        "_build" / "native"
    assert lib.name == native.LIB_NAME and lib.exists()

    src = tmp_path / "native"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.SOURCE_DIR / name, src / name)
    before = sorted(p.name for p in src.iterdir())
    built = native.build(src, tmp_path / "build")
    assert sorted(p.name for p in src.iterdir()) == before
    assert built.parent == native.build_dir(src, tmp_path / "build")
    assert built.parent.name == lib.parent.name  # same sources, same hash
    assert [p.name for p in built.parent.iterdir()] == [native.LIB_NAME]

    (src / "audio_engine.cpp").write_text("not c++\n")
    with pytest.raises(RuntimeError, match="failed"):
        native.build(src, tmp_path / "build")
    assert not any(p.suffix == ".tmp" for p in
                   native.build_dir(src, tmp_path / "build").iterdir())


def test_kernel_build_runs_once_across_threads(tmp_path, monkeypatch):
    """Eight threads ask for the kernel library at once (a render worker's
    first render beside the main thread's): the compile and link run once,
    and every thread gets the one library path. The compiler is a stand-in
    that writes its outputs slowly; the switch interval is shortened so the
    threads interleave."""
    import sys
    import threading

    from audiorenderingv2_tpu_torch.ops import _build

    calls = []

    def fake_run_all(cmds):
        calls.append(len(cmds))
        time.sleep(0.05)
        for cmd in cmds:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"x")
        return "", True

    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "lib")
    got, errors = [], []

    def worker():
        try:
            got.append(_build.build())
        except BaseException as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert calls == [len(_build.sources()), 1]  # one compile, one link
    assert got == [tmp_path / "lib" / _build.LIB_NAME] * 8
    assert sorted(p.name for p in (tmp_path / "lib").iterdir()) == \
        ["build.log", _build.LIB_NAME]
