"""The port's structured JSONL event logging (``utils/logging.py``, a copy of
the JAX package's) and the renderer's ``full_render_cycle`` record."""
import json
from pathlib import Path

import numpy as np
import torch

from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
from audiorenderingv2_tpu_torch.utils import logging as arlog

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_copy_equals_original():
    """The copy differs from its original only by the one-line note that
    opens the module docstring."""
    rel = "utils/logging.py"
    port = (REPO / "audiorenderingv2_tpu_torch" / rel).read_text()
    orig = (REPO / "audiorenderingv2_tpu" / rel).read_text()
    note, rest = port.split("\n\n", 1)
    assert note.startswith('"""[Copy of audiorenderingv2_tpu/' + rel)
    assert '"""' + rest == orig


def test_event_record_shape(tmp_path):
    path = tmp_path / "events.jsonl"
    log = arlog.EventLogger(str(path))
    rec = log.event("render", ms=12.5, n_rays=1000)
    log.close()
    assert rec["event"] == "render" and rec["ms"] == 12.5
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 1 and log.records == 1
    parsed = json.loads(lines[0])
    assert parsed["n_rays"] == 1000 and "ts" in parsed


def test_global_logger_silent_until_configured(tmp_path):
    log = arlog.get_logger()
    log.event("noop")  # no sink configured: must not raise
    path = tmp_path / "g.jsonl"
    try:
        log = arlog.configure(path=str(path))
        log.event("configured", k=1)
        assert json.loads(path.read_text())["k"] == 1
        assert arlog.get_logger() is log
    finally:
        arlog.configure()  # back to silent for other tests


def test_full_render_cycle_emits_record(tmp_path):
    """One record a cycle with the JAX renderer's fields: render and
    convolve milliseconds, the receiver and the yaw."""
    path = tmp_path / "cycle.jsonl"
    arlog.configure(path=str(path))
    try:
        v, t = tt.box_room((4.0, 3.0, 3.0))
        r = AudioRenderer(tt.scene_from_arrays(v, t, 0.3), ir_seconds=1,
                          sample_rate=8000, n_rays=256, max_bounces=4,
                          device="cpu")
        r.set_emitter_pos(np.zeros(3, np.float32))
        out = r.full_render_cycle(np.array([1.0, 0.5, 0.0]), 30.0,
                                  torch.ones(8064))
        assert out.shape == (2, 8064) and out.dtype == np.float32
        recs = [json.loads(x) for x in path.read_text().strip().splitlines()]
        cyc = [x for x in recs if x["event"] == "full_render_cycle"]
        assert len(cyc) == 1
        assert cyc[0]["render_ms"] > 0 and cyc[0]["convolve_ms"] >= 0
        assert cyc[0]["receiver"] == [1.0, 0.5, 0.0]
        assert cyc[0]["yaw_deg"] == 30.0
    finally:
        arlog.configure()
