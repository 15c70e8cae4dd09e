"""The port's warmup entry point on the CPU: its configurations and its
report."""
import json
import math

import torch

from audiorenderingv2_tpu import warmup as j_warmup
from audiorenderingv2_tpu_torch import warmup

torch.set_num_threads(1)


def test_shipped_configs_keep_the_jax_names():
    names = [name for name, _ in warmup.shipped_configs("cpu")]
    assert names == [name for name, _ in j_warmup.shipped_configs()]
    assert names == list(warmup.CONFIGS)


def test_main_writes_finite_times(monkeypatch, tmp_path):
    """``main`` on the CPU with the box's ray count cut (here only): a JSON
    with the device, the native build and finite first and warm times."""
    monkeypatch.setattr(warmup, "SMALL_RAYS", 2048)
    out = tmp_path / "warmup.json"
    assert warmup.main(["--configs", "small_bench", "--out", str(out),
                        "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == {"platform": "cpu"}
    assert set(report["configs"]) == {"small_bench"}
    row = report["configs"]["small_bench"]
    for key in ("setup_s", "first_s", "warm_s"):
        assert math.isfinite(row[key]) and row[key] >= 0, (key, row)
    assert row["warm_s"] > 0
    native = report["build"]["native"]
    assert native["build_s"] >= 0 and isinstance(native["already_built"],
                                                 bool)
    if native["already_built"]:
        assert native["build_s"] == 0.0


def test_unknown_config_raises(tmp_path):
    import pytest

    with pytest.raises(SystemExit, match="unknown configs"):
        warmup.main(["--configs", "nope", "--out", str(tmp_path / "w.json"),
                     "--device", "cpu"])
