"""The PyTorch port's host layer against the JAX package: the copied numpy
modules, the scene tensors, the packed triangle rows and the converters."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu import config as j_config
from audiorenderingv2_tpu import scene as j_scene
from audiorenderingv2_tpu import testing as jt
from audiorenderingv2_tpu.io import obj as j_obj
from audiorenderingv2_tpu.io import wav as j_wav
from audiorenderingv2_tpu.ops import raytrace_pallas_v2 as rp2
from audiorenderingv2_tpu_torch import config as t_config
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch import scene as t_scene
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.io import obj as t_obj
from audiorenderingv2_tpu_torch.io import wav as t_wav
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COPIES = ["constants.py", "config.py", "scene.py", "io/obj.py", "io/wav.py",
          "accel.py"]


def _np(sc):
    """JAX SceneArrays -> dict of numpy arrays (what convert.py takes)."""
    return {k: None if v is None else np.asarray(v)
            for k, v in sc._asdict().items()}


def _degenerate_scene():
    """Box room with a degenerate sliver injected mid-array (the trim case
    of test_pallas.py::test_interior_degenerate_triangle_keeps_tail_geometry)."""
    v, t = jt.box_room((4.0, 3.0, 5.0))
    v = np.concatenate([v, np.zeros((3, 3), np.float32)])
    n = v.shape[0]
    t = np.concatenate([t[:6], [[n - 3, n - 2, n - 1]], t[6:]]).astype(
        np.int32)
    return v, t


SCENES = {
    "box": lambda: jt.box_room((12.0, 8.0, 10.0)),
    "ico": lambda: jt.icosphere(radius=6.0, subdivisions=2),
    "degenerate": _degenerate_scene,
}


def test_port_imports_without_jax():
    """Every module of the port, ``diff/`` included, imports with JAX and
    optax made unimportable, and nothing pulls in the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = sys.modules["optax"] = None
        import audiorenderingv2_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        for sub in ("diff.replay", "diff.inverse", "diff.checkpoint",
                    "ops.traverse_cuda", "ops.group_cuda", "ops.v1_cuda",
                    "experiment", "utils.profiling", "cli", "streaming",
                    "native", "utils.logging", "utils.acoustics",
                    "utils.plotting", "utils.webview", "parallel.sharding",
                    "parallel.ir_sharding", "dryrun", "warmup",
                    "core.tracer_ref", "examples", "examples.demo_1_sphere",
                    "examples.demo_2_banded", "examples.demo_3_realtime",
                    "examples.demo_4_inverse", "examples.demo_5_sharded",
                    "examples.demo_6_multipose",
                    "examples.demo_live_duplex"):
            assert pkg.__name__ + "." + sub in names, sub
        bad = [m for m, mod in sys.modules.items() if mod is not None and (
               m == "audiorenderingv2_tpu"
               or m.startswith("audiorenderingv2_tpu.")
               or m.startswith("jax") or m.startswith("optax"))]
        assert not bad, bad
        # importing builds nothing: no kernel library, no native library
        from audiorenderingv2_tpu_torch import native
        assert native._lib is None
        assert "matplotlib" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_public_names_equal_the_jax_packages():
    """The port's top-level ``__all__`` and ``parallel.__all__`` are the
    JAX package's, each name from the port's own modules."""
    import audiorenderingv2_tpu.parallel as j_parallel
    import audiorenderingv2_tpu_torch as port
    import audiorenderingv2_tpu_torch.parallel as t_parallel

    assert port.__all__ == ar.__all__
    assert t_parallel.__all__ == j_parallel.__all__
    for mod in (port, t_parallel):
        for name in mod.__all__:
            obj = getattr(mod, name)
            if isinstance(obj, str):  # the axis names, checked below
                continue
            owner = getattr(obj, "__module__", None) or obj.__name__
            assert owner.startswith("audiorenderingv2_tpu_torch."), name
    assert t_parallel.RAYS_AXIS == j_parallel.RAYS_AXIS
    assert t_parallel.SEG_AXIS == j_parallel.SEG_AXIS


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_source_equals_original(rel):
    """The copies differ from their originals only by the one-line note
    that opens the module docstring."""
    port = (REPO / "audiorenderingv2_tpu_torch" / rel).read_text()
    orig = (REPO / "audiorenderingv2_tpu" / rel).read_text()
    note, rest = port.split("\n\n", 1)
    assert note.startswith('"""[Copy of audiorenderingv2_tpu/' + rel)
    assert '"""' + rest == orig


@pytest.mark.parametrize("edges,transition", [
    ((250.0, 1000.0, 4000.0), 0.25), ((300.0, 3000.0), 0.4)])
def test_copied_band_gains_equal_original(edges, transition):
    """``ops/filterbank.py`` imports JAX, so the port copies its numpy
    ``band_gains``; the copy gives the original's gains bit for bit."""
    from audiorenderingv2_tpu.ops import filterbank as j_fb
    from audiorenderingv2_tpu_torch.ops import filterbank as t_fb

    assert t_fb.DEFAULT_BAND_EDGES == j_fb.DEFAULT_BAND_EDGES
    for n_freqs, sr in ((4001, 8000), (16001, 16000), (513, 44100)):
        a = j_fb.band_gains(n_freqs, sr, edges, transition)
        b = t_fb.band_gains(n_freqs, sr, edges, transition)
        assert b.dtype == np.float32 and b.shape == (len(edges) + 1, n_freqs)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b.sum(axis=0), 1.0, atol=1e-6)
    np.testing.assert_array_equal(j_fb.band_gains(100, 8000),
                                  t_fb.band_gains(100, 8000))


def test_config_parse_matches():
    data = {
        "renderer_parameters": {"ir_length_in_seconds": 2,
                                "initial_volume": 0.5},
        "scene_parameters": {"mono": True, "audio_file_path": "a.wav",
                             "scene_file_path": "room.obj",
                             "initial_receiver_pos": {"x": 1, "y": 2,
                                                      "z": 3}},
        "pathtracer_parameters": {
            "rays": {"x": 10, "y": 20, "z": 30}, "ray_max_bounces": 40,
            "base_power": 3.62, "hrtf_absorption_rate": 0.8,
            "materials": [{"name": "walls", "mat_absorption": 0.3},
                          {"name": "rug", "mat_absorption":
                           [0.1, 0.2, 0.3, 0.4]}]},
    }
    a = j_config.parse_config(json.loads(json.dumps(data)))
    b = t_config.parse_config(json.loads(json.dumps(data)))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.pathtracer.n_rays, a.pathtracer.n_bands) == \
        (b.pathtracer.n_rays, b.pathtracer.n_bands)
    bad = {"pathtracer_parameters": {"rays": "many"}}
    for mod in (j_config, t_config):
        with pytest.raises(ValueError):
            mod.parse_config(bad)


def _assert_scene_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_scene_matches(name):
    v, t = SCENES[name]()
    mesh_j = jt.mesh_from_arrays(v, t)
    mesh_t = t_obj.MeshData(vertices=mesh_j.vertices,
                            triangles=mesh_j.triangles,
                            tri_material=mesh_j.tri_material,
                            material_names=[])
    absorb = np.linspace(0.1, 0.6, t.shape[0]).astype(np.float32)
    _assert_scene_equal(j_scene.build_scene(mesh_j, absorb),
                        t_scene.build_scene(mesh_t, absorb))


def test_obj_mtl_and_wav_match(tmp_path):
    obj = tt.write_box_obj(tmp_path / "room.obj", material="walls")
    with open(obj, "a") as f:  # a second material and a quad face
        f.write("usemtl rug\nv 0 -4.4 0\nv 1 -4.4 0\nv 1 -4.4 1\n"
                "v 0 -4.4 1\nf 9 10 11 12\n")
    mats_j = [j_config.MaterialSpec("walls", 0.3),
              j_config.MaterialSpec("rug", 0.7)]
    mats_t = [t_config.MaterialSpec("walls", 0.3),
              t_config.MaterialSpec("rug", 0.7)]
    mj, mt = j_obj.load_obj(obj), t_obj.load_obj(obj)
    np.testing.assert_array_equal(mj.vertices, mt.vertices)
    np.testing.assert_array_equal(mj.triangles, mt.triangles)
    np.testing.assert_array_equal(mj.tri_material, mt.tri_material)
    assert mj.material_names == mt.material_names == ["walls", "rug"]
    _assert_scene_equal(j_scene.load_scene(obj, mats_j),
                        t_scene.load_scene(obj, mats_t))

    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, size=(2, 1000)).astype(np.float32)
    j_wav.write_wav(tmp_path / "j.wav", x, 16000)
    t_wav.write_wav(tmp_path / "t.wav", x, 16000)
    assert (tmp_path / "j.wav").read_bytes() == \
        (tmp_path / "t.wav").read_bytes()
    a = j_wav.read_wav(tmp_path / "t.wav")
    b = t_wav.read_wav(tmp_path / "j.wav")
    assert a.sample_rate == b.sample_rate == 16000
    np.testing.assert_array_equal(a.samples, b.samples)
    np.testing.assert_array_equal(j_wav.normalize_minus_one_to_one(x[0]),
                                  t_wav.normalize_minus_one_to_one(x[0]))


@pytest.mark.parametrize("tri_chunk", [128, 2048])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_to_arrays_matches(name, tri_chunk):
    """Equal to the JAX arrays; u_off/v_off within 1 ulp: the port sums the
    three products in index order, the JAX package through an einsum whose
    order XLA picks."""
    v, t = SCENES[name]()
    scene = jt.scene_from_arrays(v, t, 0.3)
    a = _np(ar.scene_to_arrays(scene, tri_chunk))
    b = t_tracer.scene_to_arrays(scene, tri_chunk, device="cpu")
    assert a["cluster_boxes"] is None and b.cluster_boxes is None
    for f in t_tracer.SceneArrays._fields[:-1]:
        x, y = a[f], getattr(b, f).numpy()
        assert x.shape == y.shape and y.dtype == np.float32, f
        if f in ("u_off", "v_off"):
            np.testing.assert_array_max_ulp(x, y, maxulp=1)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("n_bands", [1, 3])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_tris_rows_matches(name, n_bands):
    """pack_tris_rows == pack_tris_v2(layout="rows"), trim included."""
    v, t = SCENES[name]()
    absorb = np.linspace(0.1, 0.6, t.shape[0] * n_bands).astype(
        np.float32).reshape(t.shape[0], n_bands)
    scene = jt.scene_from_arrays(v, t, absorb if n_bands > 1 else 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    rows_j, _, _ = rp2.pack_tris_v2(sc, n_bands, layout="rows")
    rows_t = rc.pack_tris_rows(
        convert.scene_arrays_from_jax(_np(sc), device="cpu"), n_bands)
    np.testing.assert_array_equal(np.asarray(rows_j), rows_t.numpy())
    if name == "degenerate":
        valid = np.asarray(sc.valid)
        assert valid[6] == 0.0 and valid[12] == 1.0
        assert rows_t.shape[0] >= 13  # every real triangle survives


def test_convert_round_trip():
    v, t = jt.box_room((5.0, 4.0, 3.0))
    sc = ar.scene_to_arrays(jt.scene_from_arrays(v, t, 0.25), 128)
    arrays = _np(sc)
    back = convert.scene_arrays_to_numpy(
        convert.scene_arrays_from_jax(arrays, device="cpu"))
    assert set(back) == set(t_tracer.SceneArrays._fields)
    for k, x in back.items():
        np.testing.assert_array_equal(arrays[k], x)
    params = ar.TraceParams(sample_rate=8000, ir_length=16000,
                            base_power=2.0, energy_threshold=1e-9,
                            max_bounces=7, hrtf_absorption_rate=0.7,
                            is_mono=True, n_bands=3)
    p = convert.trace_params_from_jax(params)
    assert dataclasses.asdict(p) == dataclasses.asdict(params)
    assert (p.distance_threshold, p.cross_ear_delay) == \
        (params.distance_threshold, params.cross_ear_delay)
    assert back["cluster_boxes"] is None
    boxes = np.arange(16, dtype=np.float32).reshape(2, 8)
    clustered = convert.scene_arrays_from_jax(
        dict(arrays, cluster_boxes=boxes), device="cpu")
    np.testing.assert_array_equal(clustered.cluster_boxes.numpy(), boxes)
    np.testing.assert_array_equal(
        convert.scene_arrays_to_numpy(clustered)["cluster_boxes"], boxes)


def test_tracer_options_from_jax():
    """Result options, round budgets, the backend, the differentiable
    trace's options and the three that pick a kernel (layout, version,
    precision) carry over; the rest of the TPU tuning is dropped."""
    j = ar.TracerOptions(soft_binning=True, pallas_compact=False,
                         pallas_round_budgets=(2, 3, 5),
                         pallas_precision="high", pallas_layout="group",
                         rays_per_tile=512, pallas_unroll=4,
                         pallas_partition_mode="sort",
                         pallas_dynamic_grid=True)
    assert convert.tracer_options_from_jax(j) == t_tracer.TracerOptions(
        soft_binning=True, compact=False, round_budgets=(2, 3, 5),
        backend="autograd", layout="group", precision="high")
    v1 = ar.TracerOptions(backend="pallas", pallas_version=1,
                          pallas_layout="rows", pallas_precision="split3",
                          pallas_tri_block=32, pallas_sched_unroll=2)
    assert convert.tracer_options_from_jax(v1) == t_tracer.TracerOptions(
        version=1, precision="high")  # "split3" is the JAX alias of "high"
    # "auto" is the rows layout; a single bf16 pass has no counterpart
    assert convert.tracer_options_from_jax(
        ar.TracerOptions(pallas_layout="auto")).layout == "rows"
    with pytest.raises(ValueError, match="single bf16 pass"):
        convert.tracer_options_from_jax(
            ar.TracerOptions(pallas_precision="default"))
    # JAX's default backend is the differentiable one, the port's the
    # kernels; everything else of the defaults agrees.
    assert convert.tracer_options_from_jax(ar.TracerOptions()) == \
        t_tracer.TracerOptions(backend="autograd")
    assert convert.tracer_options_from_jax(
        ar.TracerOptions(backend="pallas")) == t_tracer.TracerOptions()
    g = ar.TracerOptions(backend="xla", block_size=256, tri_chunk=128,
                         early_exit=False, remat=True, pallas_schedule=True)
    assert convert.tracer_options_from_jax(g) == t_tracer.TracerOptions(
        backend="autograd", block_size=256, tri_chunk=128, early_exit=False,
        remat=True, schedule=True)


def test_renderer_packs_rows_once():
    """The renderer keeps the scene's rows, equal to a fresh pack, and a
    render with them equals trace_ir packing its own."""
    from audiorenderingv2_tpu_torch import renderer as t_renderer
    from audiorenderingv2_tpu_torch.core import sampling

    v, t = jt.box_room((6.0, 4.0, 5.0))
    r = t_renderer.AudioRenderer(tt.scene_from_arrays(v, t, 0.3), 1, 8000,
                                 2048, max_bounces=12, device="cpu")
    r.set_receiver((1.0, 0.5, 1.0), 20.0)
    assert torch.equal(r.rows, rc.pack_tris_rows(r.sc))
    g = torch.Generator().manual_seed(4)
    d = sampling.sample_directions(2048, g, "cpu")
    args = (d, r.emitter_pos, r.receiver_pos, r.receiver_yaw_deg, r.params,
            r.opts)
    torch.testing.assert_close(t_tracer.trace_ir(r.sc, *args, rows=r.rows),
                               t_tracer.trace_ir(r.sc, *args),
                               rtol=0.0, atol=0.0)


@pytest.mark.parametrize("exact", [True, False])
def test_assert_ir_close_matches_reference_bar(exact):
    """The port's copy of assert_ir_close accepts and rejects what the JAX
    package's accepts and rejects."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1e-3, size=(2, 500)).astype(np.float32)
    close = a * (1 + 1e-5)
    moved = a.copy()
    moved[0, :50] = np.roll(moved[0, :50], 7)
    for b in (close, moved, a * 1.01):
        verdicts = []
        for fn in (jt.assert_ir_close, tt.assert_ir_close):
            try:
                fn(a, b, exact=exact)
                verdicts.append(True)
            except AssertionError:
                verdicts.append(False)
        assert verdicts[0] == verdicts[1]


def test_box_room_matches_reference():
    for size in [(14.0, 9.0, 11.0), (3.0, 4.0, 5.0)]:
        for x, y in zip(jt.box_room(size), tt.box_room(size)):
            np.testing.assert_array_equal(x, y)
    v, t = jt.box_room()
    _assert_scene_equal(jt.scene_from_arrays(v, t, 0.3),
                        tt.scene_from_arrays(v, t, 0.3))


def test_mesh_from_arrays_and_quad_match_reference():
    """``quad`` and ``mesh_from_arrays`` (default and given materials) give
    the JAX package's arrays, array for array; ``scene_from_arrays`` builds
    through ``mesh_from_arrays`` as there."""
    for args in (([0.0, -500.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
                 ((10.0, 0.5, -2.0), (0.0, 50.0, 0.0), (0.0, 0.0, 50.0))):
        for x, y in zip(jt.quad(*args), tt.quad(*args)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    v, t = jt.icosphere(radius=3.0, subdivisions=1)
    for kw in ({}, {"tri_material": np.arange(len(t)) % 3,
                    "material_names": ["a", "b", "c"]}):
        a, b = jt.mesh_from_arrays(v, t, **kw), tt.mesh_from_arrays(v, t,
                                                                    **kw)
        for f in ("vertices", "triangles", "tri_material"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.material_names == b.material_names
    qv, qt = tt.quad([10.0, 0.0, 0.0], [0.0, 50.0, 0.0], [0.0, 0.0, 50.0])
    _assert_scene_equal(jt.scene_from_arrays(qv, qt, 0.3),
                        tt.scene_from_arrays(qv, qt, 0.3))


@pytest.mark.parametrize("subdivisions", [0, 2, 3])
def test_icosphere_matches_reference(subdivisions):
    kw = dict(radius=2.5, center=(1.0, -0.5, 3.0), subdivisions=subdivisions)
    for x, y in zip(jt.icosphere(**kw), tt.icosphere(**kw)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("target", [700, 2000])
def test_office_scene_matches_benchmark(target):
    """The port's office equals benchmarks/large_scene.office_scene bit for
    bit, the scene the JAX package's large-scene workload renders."""
    from benchmarks import large_scene

    _assert_scene_equal(large_scene.office_scene(target),
                        tt.office_scene(target))


def test_write_obj_round_trips(tmp_path):
    """An office written by write_obj loads back with the same faces and
    its one material, vertices to the 6 decimals written."""
    v, t = tt.office_mesh(700)
    path = tt.write_obj(tmp_path / "office.obj", v, t, material="walls")
    mesh = t_obj.load_obj(path)
    np.testing.assert_array_equal(mesh.triangles, t)
    np.testing.assert_allclose(mesh.vertices, v, atol=1e-6)
    assert mesh.material_names == ["walls"]
    assert np.all(mesh.tri_material == 0)
