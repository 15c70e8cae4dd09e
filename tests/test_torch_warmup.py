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


def test_bench_configs_build_through_the_bench_builders(monkeypatch):
    """``small_bench`` renders under ``tuned.bench_small_options()`` and
    ``large_bench`` under ``tuned.bench_large_options()`` in clusters of
    ``tuned.bench_large_cluster_size()``, so an AR2_BENCH_* override warms
    what a benchmark with it builds; with none set, ``auto_options``'
    routes."""
    from audiorenderingv2_tpu_torch import tuned

    seen = {}

    def fake_render(sc, gen, n_rays, emitter, receiver, yaw, params, opts,
                    **kw):
        seen["opts"], seen["boxes"] = opts, sc.cluster_boxes
        return None

    monkeypatch.setattr(warmup, "render_ir", fake_render)
    monkeypatch.setattr(warmup, "LARGE_TRIS", 700)
    builds = dict(warmup.shipped_configs("cpu"))
    for env, want_small, want_large, cs in (
            ({}, tuned.auto_options(12, 100)[0],
             tuned.auto_options(19852, 32)[0], tuned.CLUSTER_SIZE),
            ({"AR2_BENCH_BUDGETS": "3,7,90", "AR2_BENCH_SCHEDULE": "0",
              "AR2_BENCH_CLUSTER_SIZE": "64"},
             tuned.TracerOptions(round_budgets=(3, 7, 90)),
             tuned.TracerOptions(schedule=False), 64)):
        for k in ("AR2_BENCH_BUDGETS", "AR2_BENCH_SCHEDULE",
                  "AR2_BENCH_CLUSTER_SIZE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        builds["small_bench"]()()
        assert seen["opts"] == want_small == tuned.bench_small_options()
        assert seen["boxes"] is None
        builds["large_bench"]()()
        assert seen["opts"] == want_large == tuned.bench_large_options()
        t_pad = 768  # the office of 652 triangles, padded to 128s
        assert seen["boxes"].shape[0] == t_pad // cs
