"""The port's copies of the JAX package's numpy utilities (room-acoustics
metrics, plotting, the walkthrough page): each pinned to its original, and
the cases of tests/test_acoustics.py, tests/test_webview.py and
tests/test_aux.py's plotting test carried over, the traced one through the
port's tracer."""
import base64
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audiorenderingv2_tpu.utils import acoustics as j_acoustics
from audiorenderingv2_tpu_torch import streaming
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.io import wav as wav_io
from audiorenderingv2_tpu_torch.utils import acoustics
from audiorenderingv2_tpu_torch.utils.webview import write_walkthrough_html

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SR = 8000


@pytest.mark.parametrize("rel", ["utils/acoustics.py", "utils/plotting.py",
                                 "utils/webview.py"])
def test_copy_equals_original(rel):
    """Each copy differs from its original only by the one-line note that
    opens the module docstring (the webview's yaw conversion at the page's
    boundary included)."""
    port = (REPO / "audiorenderingv2_tpu_torch" / rel).read_text()
    orig = (REPO / "audiorenderingv2_tpu" / rel).read_text()
    note, rest = port.split("\n\n", 1)
    assert note.startswith('"""[Copy of audiorenderingv2_tpu/' + rel)
    assert '"""' + rest == orig


# ------------------------------------------------------------- acoustics

def exponential_ir(rt60_s: float, seconds: float = 2.0) -> np.ndarray:
    """Energy IR decaying 60 dB in rt60_s (exact exponential)."""
    t = np.arange(int(seconds * SR)) / SR
    return 10.0 ** (-6.0 * t / rt60_s)


@pytest.mark.parametrize("true_rt", [0.3, 0.8, 1.5])
def test_rt60_recovers_exponential(true_rt):
    ir = exponential_ir(true_rt)
    assert acoustics.rt60(ir, SR, "t30") == pytest.approx(true_rt, rel=0.02)
    assert acoustics.rt60(ir, SR, "t20") == pytest.approx(true_rt, rel=0.02)
    assert acoustics.edt(ir, SR) == pytest.approx(true_rt, rel=0.05)


def test_schroeder_starts_at_zero_and_decays():
    c = acoustics.schroeder_curve(exponential_ir(0.5))
    assert c[0] == pytest.approx(0.0, abs=1e-9)
    assert (np.diff(c) <= 1e-12).all()


def test_clarity_and_definition_analytic():
    ir = np.zeros(SR)  # all energy in the first 10 ms
    ir[: SR // 100] = 1.0
    assert acoustics.clarity(ir, SR, 50.0) == np.inf
    assert acoustics.definition(ir, SR) == pytest.approx(1.0)
    ir = np.zeros(SR)  # half before 50 ms, half after: C50 0 dB, D50 0.5
    ir[0] = 1.0
    ir[SR // 2] = 1.0
    assert acoustics.clarity(ir, SR, 50.0) == pytest.approx(0.0, abs=1e-9)
    assert acoustics.definition(ir, SR) == pytest.approx(0.5)


def test_drr_isolates_direct_peak():
    ir = np.zeros(SR)
    ir[100] = 10.0   # direct
    ir[2000:2100] = 0.01  # reverb tail, total 1.0
    drr = acoustics.direct_to_reverberant(ir, SR)
    assert drr == pytest.approx(10.0, abs=0.1)  # 10*log10(10/1)


def test_traced_rt60_tracks_absorption():
    """Physical sanity through the port's tracer: a more absorbent room has
    a shorter RT60, and the JAX package's metrics give the same numbers on
    the port's IR."""
    d = np.random.default_rng(0).normal(size=(4096, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                         .astype(np.float32))
    params = TraceParams(sample_rate=SR, ir_length=2 * SR, base_power=3.62,
                         max_bounces=60)
    rts = {}
    for a in (0.1, 0.5):
        v, t = tt.box_room((10.0, 8.0, 9.0))
        sc = tracer.scene_to_arrays(tt.scene_from_arrays(v, t, a), 128,
                                    device="cpu")
        ir = tracer.trace_ir(sc, d, np.zeros(3), [2.0, 0.0, 1.0], 0.0,
                             params).numpy()
        rts[a] = acoustics.rt60(ir.sum(axis=0), SR, "t20")
        assert rts[a] == j_acoustics.rt60(ir.sum(axis=0), SR, "t20")
    assert rts[0.5] < rts[0.1] * 0.6
    assert 0.005 < rts[0.5] < rts[0.1] < 5.0


def test_summary_shapes():
    ir = np.stack([exponential_ir(0.4), exponential_ir(0.4) * 0.8])
    s = acoustics.summarize(ir, SR)
    assert set(s) == {"rt60_t30_s", "rt60_t20_s", "edt_s", "c50_db",
                      "c80_db", "d50", "drr_db"}
    assert s["rt60_t30_s"] == pytest.approx(0.4, rel=0.03)
    assert s == j_acoustics.summarize(ir, SR)


# --------------------------------------------------------------- plotting

def test_plotting(tmp_path):
    """Every plot of the copy from the port's own scene and IR dump."""
    pytest.importorskip("matplotlib")
    from audiorenderingv2_tpu_torch.utils import plotting

    v, t = tt.box_room()
    plotting.plot_scene(tt.scene_from_arrays(v, t, 0.3),
                        tmp_path / "scene.png", emitter=[0, 0, 0],
                        receiver=[2, 0, 1])
    ir = np.zeros((2, 1000))
    ir[0, 100] = 1.0
    plotting.plot_ir(ir, SR, tmp_path / "ir.png")
    plotting.plot_signal(np.sin(np.linspace(0, 20, 800))[None], SR,
                         tmp_path / "sig.png")
    np.savetxt(tmp_path / "output_ir_left_1.txt", ir[0])
    n = plotting.plot_ir_files(tmp_path, "output_ir_left",
                               tmp_path / "batch.png")
    assert n == 1
    for f in ["scene.png", "ir.png", "sig.png", "batch.png"]:
        assert (tmp_path / f).stat().st_size > 1000


# ---------------------------------------------------------------- webview

def _box_scene():
    v, t = tt.box_room((6.0, 4.0, 5.0))
    return tt.scene_from_arrays(v, t, 0.3)


def _embedded_data(html: str) -> dict:
    m = re.search(r"const DATA = (\{.*?\});\n", html, re.S)
    assert m, "DATA literal not found"
    return json.loads(m.group(1))


def test_walkthrough_embeds_geometry(tmp_path):
    scene = _box_scene()
    out = write_walkthrough_html(scene, tmp_path / "walk.html",
                                 emitter=[0.0, 0.0, 0.0],
                                 receiver=[1.0, 1.6, 2.0],
                                 receiver_yaw_deg=30.0)
    html = out.read_text()
    data = _embedded_data(html)
    tris = np.frombuffer(base64.b64decode(data["tris"]), np.float32)
    t = scene.n_triangles
    assert tris.shape == (t * 9,)
    expect = np.stack([scene.v0[:t], scene.v1[:t], scene.v2[:t]],
                      axis=1).astype(np.float32)
    np.testing.assert_array_equal(tris.reshape(t, 3, 3), expect)
    assert data["emitter"] == [0.0, 0.0, 0.0]
    assert data["receiver"] == [1.0, 1.6, 2.0]
    assert data["yaw_deg"] == 30.0
    # self-contained: no external script or style references
    assert "http://" not in html and "https://" not in html
    assert "<canvas" in html and "requestAnimationFrame" in html


def test_walkthrough_trajectory_roundtrip():
    """The JSON the recorder downloads feeds the port's
    ListenerTrajectory.from_arrays: walk in the browser, auralize
    offline."""
    rec = {"times": [0.0, 0.5, 1.2],
           "positions": [[0, 1.6, 0], [0.5, 1.6, 0.2], [1.1, 1.6, 0.6]],
           "yaws_deg": [0.0, 12.0, 25.0]}
    blob = json.loads(json.dumps(rec))  # what the browser writes
    traj = streaming.ListenerTrajectory.from_arrays(
        blob["times"], blob["positions"], blob["yaws_deg"])
    pos, yaw = traj.at(0.85)
    assert 0.5 <= pos[0] <= 1.1 and 12.0 <= yaw <= 25.0
    assert traj.duration == 1.2


def test_walkthrough_embeds_audio(tmp_path):
    samples = np.zeros((2, 16000), np.float32)
    samples[:, 0] = 0.5
    wav_path = tmp_path / "a.wav"
    wav_io.write_wav(str(wav_path), samples, 16000)
    out = write_walkthrough_html(_box_scene(), tmp_path / "walk.html",
                                 audio_wav_path=wav_path)
    m = re.search(r'data:audio/wav;base64,([A-Za-z0-9+/=]+)', out.read_text())
    assert m
    assert base64.b64decode(m.group(1)) == wav_path.read_bytes()


def test_yaw_convention_conversion_present(tmp_path):
    """The browser camera yaw (faces sin/-cos) and the package receiver yaw
    (faces cos/sin) differ by 90 degrees; the page converts at both
    boundaries, the camera's seed and the recorder's export."""
    path = tmp_path / "w.html"
    write_walkthrough_html(_box_scene(), path, receiver_yaw_deg=30.0)
    html = path.read_text()
    assert "DATA.yaw_deg*Math.PI/180 + Math.PI/2" in html
    assert "yaw*180/Math.PI-90" in html
