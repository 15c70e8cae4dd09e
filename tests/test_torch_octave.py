"""Frequency-dependent absorption through the port's normal path, held to
the benchmark's banded float64 reference (``perfbench/reference_banded.py``).

A small furnished office (the benchmark's office mesh at about 1,000
triangles, so that ``tuned.auto_options`` takes the clustered route) with a
seeded random ``[T, B]`` absorption table, rendered and auralized by
``AudioRenderer`` on the CPU at 48 kHz, against the reference on the same
directions: each band of the IR and the stereo output. The planted faults
of the banded check (bands permuted, every band given band 0's
coefficients, one band scaled, the band-summed IR in place of the
filterbank) each fail it. The port's spans and counters of a banded cycle.
"""
import json

import numpy as np
import pytest
import torch

from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.ops import convolve, filterbank
from audiorenderingv2_tpu_torch.renderer import AudioRenderer
from audiorenderingv2_tpu_torch.utils import logging as arlog
from audiorenderingv2_tpu_torch.utils import profiling
from perfbench import harness, reference
from perfbench import reference_banded as banded
from perfbench.drivers import walk_banded

torch.set_num_threads(2)

CONFIG = harness.load_json("configs", "office_octave")
LIMITS = harness.load_json("limits", "office_octave.walk_banded")
EDGES = {4: list(filterbank.DEFAULT_BAND_EDGES), 8: CONFIG["band_edges"]}
N_RAYS = 4096
SEED = 2**31 + 1201
TRACE = {"sample_rate": 48000, "ir_seconds": 1, "base_power": 3.62,
         "energy_threshold": 0.0, "max_bounces": 16,
         "hrtf_absorption_rate": 0.9}
RECEIVER, YAW = [6.0, 1.0, -8.0], 30.0
# The float32 program against the float64 reference on the same directions:
# at 16 bounces no deposit of these 4,096 rays moves to another bin, and
# each band's relative L1 reads 1.5e-5 to 2e-5 (float32 rounding); one
# moved deposit would read about 1e-3. A planted fault reads 0.25 or more
# in some number.
TOL = 1e-3


def small_office():
    spec = dict(CONFIG["scene"], n_triangles_target=1000)
    return reference.scene_mesh(spec)


def random_table(n_tris: int, n_bands: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, n_bands])
    return rng.uniform(0.05, 0.6, (n_tris, n_bands)).astype(np.float32)


def signal() -> torch.Tensor:
    rng = np.random.default_rng([SEED, 2])
    return torch.as_tensor(rng.standard_normal(TRACE["sample_rate"])
                           .astype(np.float32))


def renderer(mesh, table, edges) -> AudioRenderer:
    r = AudioRenderer(tt.scene_from_arrays(*mesh, table),
                      TRACE["ir_seconds"], TRACE["sample_rate"], N_RAYS,
                      base_power=TRACE["base_power"],
                      max_bounces=TRACE["max_bounces"],
                      hrtf_absorption_rate=TRACE["hrtf_absorption_rate"],
                      device="cpu", seed=SEED, band_edges=tuple(edges))
    r.set_emitter_pos(np.zeros(3, np.float32))
    return r


def reference_cycle(mesh, table, edges, x):
    geo = banded.BandedGeometry(*mesh, table, "cpu")
    dirs = reference.directions(
        N_RAYS, reference.generator_from_seed(SEED, "cpu"), "cpu")
    ir, steps = banded.trace_ir(geo, dirs, [0.0, 0.0, 0.0], RECEIVER, YAW,
                                TRACE)
    assert steps > N_RAYS
    return ir, banded.overlap_add(x.double(), ir, TRACE["sample_rate"],
                                  edges)


@pytest.fixture(scope="module")
def office8():
    mesh = small_office()
    table = random_table(mesh[1].shape[0], 8)
    x = signal()
    ir_ref, out_ref = reference_cycle(mesh, table, EDGES[8], x)
    return mesh, table, x, ir_ref, out_ref


@pytest.mark.parametrize("n_bands", [4, 8])
def test_port_matches_the_banded_reference(n_bands):
    mesh = small_office()
    assert 512 <= mesh[1].shape[0] <= 1100
    table = random_table(mesh[1].shape[0], n_bands)
    x = signal()
    r = renderer(mesh, table, EDGES[n_bands])
    assert r.sc.cluster_boxes is not None and r.opts.schedule
    out = r.full_render_cycle(np.asarray(RECEIVER, np.float32), YAW, x)
    ir = r.ir
    assert ir.shape == (2, n_bands, TRACE["sample_rate"])
    ir_ref, out_ref = reference_cycle(mesh, table, EDGES[n_bands], x)
    ref = ir_ref.numpy()
    per_band = (np.abs(ir - ref).sum(axis=(0, 2))
                / np.abs(ref).sum(axis=(0, 2)))
    assert per_band.max() < TOL, per_band
    np.testing.assert_allclose(ir.sum(axis=2), ref.sum(axis=2), rtol=TOL)
    out_ref = out_ref.numpy()
    assert np.linalg.norm(out - out_ref) / np.linalg.norm(out_ref) < TOL
    got = walk_banded.Driver.judge(ir, out, ir_ref, torch.as_tensor(out_ref))
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got


def _faulty_cycle(kind, mesh, table, x, monkeypatch):
    """The program's IR and output with ``kind`` planted where it is
    produced."""
    from audiorenderingv2_tpu_torch import renderer as rmod

    if kind == "band0_everywhere":
        table = np.repeat(table[:, :1], table.shape[1], axis=1)
    elif kind in ("permuted", "scaled"):
        real = rmod.render_ir

        def faulty(*a, **k):
            ir = real(*a, **k)
            if kind == "permuted":
                return ir.flip(1).contiguous()
            ir[:, 5] *= 1.5
            return ir
        monkeypatch.setattr(rmod, "render_ir", faulty)
    elif kind == "summed_ir":
        monkeypatch.setattr(
            rmod.filterbank, "convolve_file_banded",
            lambda s, ir, sr, edges: convolve.convolve_file_stereo(
                s, ir.sum(1), sr))
    r = renderer(mesh, table, EDGES[8])
    out = r.full_render_cycle(np.asarray(RECEIVER, np.float32), YAW, x)
    return r.ir, out


@pytest.mark.parametrize("kind", ["none", "permuted", "band0_everywhere",
                                  "scaled", "summed_ir"])
def test_planted_faults_fail_the_banded_check(kind, office8, monkeypatch):
    mesh, table, x, ir_ref, out_ref = office8
    ir, out = _faulty_cycle(kind, mesh, table, x, monkeypatch)
    got = walk_banded.Driver.judge(ir, out, ir_ref, out_ref)
    over = {k: v for k, v in got.items() if v > LIMITS[k]}
    if kind == "none":
        assert not over, got
    else:
        assert over, got
    if kind == "summed_ir":  # the IR is sound; only the output is not
        assert set(over) == {"out_rel_l2"}, got


@pytest.mark.parametrize("length,rate,edges", [
    (240000, 48000, CONFIG["band_edges"]),
    (96000, 48000, CONFIG["band_edges"]),
    (80000, 16000, filterbank.DEFAULT_BAND_EDGES),
])
def test_reference_gains_sum_to_one_and_are_the_ports(length, rate, edges):
    g = banded.band_gains(length, rate, edges)
    assert g.shape == (len(edges) + 1, length // 2 + 1)
    assert g.dtype == torch.float64
    assert float((g.sum(0) - 1.0).abs().max()) < 1e-12
    assert float(g.min()) >= 0.0
    port = filterbank.band_gains(length // 2 + 1, rate, edges)
    np.testing.assert_allclose(g.numpy(), port, atol=1e-6)


def test_reference_split_sums_to_the_signal():
    x = signal().double()
    bands = banded.split_bands(x, 48000, CONFIG["band_edges"])
    assert bands.shape == (8, x.shape[0])
    np.testing.assert_allclose(bands.sum(0).numpy(), x.numpy(), atol=1e-10)


def test_material_table_follows_the_configuration():
    mesh = reference.scene_mesh(CONFIG["scene"])
    assert mesh[1].shape[0] == 19852
    table = banded.material_table(*mesh, CONFIG["materials"])
    mats = {k: np.asarray(v, np.float32)
            for k, v in CONFIG["materials"].items()}
    rows = [next(k for k, v in mats.items() if np.array_equal(row, v))
            for row in table[:12]]
    assert rows.count("walls") == 8
    v, t = mesh
    y = v[t[:12]][:, :, 1].mean(1)
    assert {rows[i] for i in np.flatnonzero(y == y.min())} == {"floor"}
    assert {rows[i] for i in np.flatnonzero(y == y.max())} == {"ceiling"}
    assert (table[12:] == mats["furniture"]).all()


# ------------------------------------------------------- spans, counters

def _span_tree(path) -> list:
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"
          and e["name"].startswith("ar2.")]
    ev.sort(key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in ev:
        while stack and (stack[-1]["ts"] + stack[-1]["dur"]
                         < e["ts"] + e["dur"]):
            stack.pop()
        out.append((e["name"], [s["name"] for s in reversed(stack)]))
        stack.append(e)
    return out


def _box_renderer(n_bands: int) -> AudioRenderer:
    v, t = tt.box_room((4.0, 3.0, 3.0))
    absorption = (0.3 if n_bands == 1
                  else np.linspace(0.1, 0.8, n_bands, dtype=np.float32)
                  [None].repeat(len(t), 0))
    r = AudioRenderer(tt.scene_from_arrays(v, t, absorption), ir_seconds=1,
                      sample_rate=8000, n_rays=1024, max_bounces=20,
                      device="cpu", seed=5,
                      band_edges=(60.0, 120.0, 240.0, 480.0, 960.0, 1920.0,
                                  3840.0)[:n_bands - 1])
    r.set_emitter_pos(np.zeros(3, np.float32))
    return r


@pytest.mark.parametrize("n_bands", [1, 8])
def test_banded_cycle_spans_and_counters(n_bands, tmp_path):
    r = _box_renderer(n_bands)
    r.render()
    path = tmp_path / "cycle.jsonl"
    arlog.configure(path=str(path))
    try:
        with profiling.trace(str(tmp_path / "prof"), device="cpu"):
            r.full_render_cycle(np.array([1.0, 0.5, 0.0]), 30.0,
                                torch.ones(8064))
    finally:
        arlog.configure()
    parents = dict(_span_tree(tmp_path / "prof" / "trace.json"))
    rec = json.loads(path.read_text().strip().splitlines()[-1])
    if n_bands == 1:
        assert "ar2.convolve.split" not in parents
        assert "ar2.convolve.bands" not in parents
        assert "n_bands" not in rec and "band_energy" not in rec
        assert "n_bands" not in r.counters
        return
    assert parents["ar2.convolve.split"] == ["ar2.convolve", "ar2.cycle"]
    assert parents["ar2.convolve.bands"] == ["ar2.convolve", "ar2.cycle"]
    assert rec["n_bands"] == 8 == r.counters["n_bands"]
    energy = rec["band_energy"]
    assert len(energy) == 8 and all(isinstance(e, float) for e in energy)
    np.testing.assert_allclose(energy, r.ir.sum(axis=(0, 2)), rtol=1e-5)
    assert energy == sorted(energy, reverse=True)  # absorption rises


def test_banded_live_block_spans(tmp_path):
    from audiorenderingv2_tpu_torch.streaming import RingBuffer

    r = _box_renderer(8)
    r.render()
    ring = RingBuffer(4 * 8000)
    with profiling.trace(str(tmp_path / "prof"), device="cpu"):
        with profiling.span("ar2.live"):
            r.convolve_live_input(np.ones(512, np.float32), ring)
    parents = dict(_span_tree(tmp_path / "prof" / "trace.json"))
    assert parents["ar2.convolve.split"] == ["ar2.live"]
    assert parents["ar2.convolve.bands"] == ["ar2.live"]


def test_banded_counters_off_compute_nothing(monkeypatch):
    """Untraced, a banded render reaches its band counters and calls
    none of their callables."""
    def refuse():
        raise AssertionError("a band counter computed untraced")

    reached = []

    def guarded(real):
        def counter(name, fn, **kw):
            reached.append(name)
            return real(name, refuse, **kw)
        return counter

    for name in ("count", "count_each"):
        monkeypatch.setattr(profiling, name,
                            guarded(getattr(profiling, name)))
    r = _box_renderer(8)
    with profiling.collect() as c:
        r.render()
    assert {"n_bands", "band_energy"} <= set(reached)
    assert c.read() == {} and r.counters == {}


def test_count_each_keeps_floats_and_ints():
    with torch.profiler.profile():
        with profiling.collect() as c:
            profiling.count_each("e", lambda: torch.tensor([0.5, 0.25]))
            profiling.count_each("e", lambda: torch.tensor([0.125]))
            profiling.count_each("i", lambda: torch.tensor([3, 4]))
            profiling.count("n", lambda: torch.tensor(2.75), once=True)
    got = c.read()
    assert got == {"e": [0.5, 0.25, 0.125], "i": [3, 4], "n": 2.75}
    assert all(isinstance(v, int) for v in got["i"])
