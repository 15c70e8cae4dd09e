"""The port's completeness against the JAX package, read from the sources.

Nothing here imports either package: every case parses source files with
``ast`` (or reads them as text), so the whole file takes milliseconds.

- One case per module of ``audiorenderingv2_tpu/``: each top-level public
  ``def``, ``class`` and UPPER_CASE constant exists in the port's module of
  the same path, or stands in ``RENAMED`` (its counterparts elsewhere in the
  port, each of which must exist), or in ``NO_COUNTERPART`` with its reason.
  A private name is not required; where the port kept one, it is the same
  kind of thing (function, class or constant). A JAX module's ``__all__``
  is held the same way against the port's.
- One case per ``pl.pallas_call(`` site of the JAX package, found by
  reading its sources: ``KERNELS`` maps the site to the CUDA sources that
  replace it, the ``ar2_*`` entry each defines, the wrapper module that
  binds that entry, and the ``"replaces"`` strings ``chip_smoke.py`` gives
  for the site. A new site with no row fails.
- One case of device defaults: every function of the port with a
  ``device`` parameter defaults to ``"cuda"``, or to None where None means
  the rank's GPU (``NONE_IS_THE_RANKS_GPU``).

To run it alone: ``python -m pytest tests/test_torch_completeness.py -q``.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "audiorenderingv2_tpu"
PORT = REPO / "audiorenderingv2_tpu_torch"
SMOKE = REPO / "chip_smoke.py"

# JAX "module:name" -> the port's "module:name" counterparts (the first is
# the main one; a TPU kernel's branches may each have a wrapper of their
# own). Each counterpart must exist.
RENAMED = {
    "ops/raytrace_pallas_v2.py:trace_round_v2": (
        "ops/raytrace_cuda.py:trace_round",
        "ops/schedule_cuda.py:trace_round_sched",
        "ops/traverse_cuda.py:trace_traverse",
        "ops/group_cuda.py:trace_round_group"),
    "ops/raytrace_pallas_v2.py:init_state_tiles": (
        "ops/raytrace_cuda.py:init_state_native",),
    "ops/raytrace_pallas_v2.py:pack_tris_v2": (
        "ops/raytrace_cuda.py:pack_tris_rows",
        "ops/raytrace_cuda.py:pack_tris_clusters",
        "ops/raytrace_cuda.py:pack_tris_group"),
    "ops/raytrace_pallas_v2.py:tile_schedule": (
        "ops/schedule_cuda.py:tile_schedule",),
    "ops/raytrace_pallas_v2.py:state_ncols": (
        "ops/raytrace_cuda.py:state_ncols",),
    "ops/raytrace_pallas.py:pack_tris": ("ops/raytrace_cuda.py:pack_tris_v1",),
    "ops/raytrace_pallas.py:trace_round": ("ops/v1_cuda.py:trace_round_v1",),
    "ops/raytrace_pallas.py:trace_events_pallas": (
        "ops/raytrace_cuda.py:trace_events",),
    "ops/raytrace_pallas.py:init_state": ("ops/raytrace_cuda.py:init_state",),
    "ops/raytrace_pallas.py:trace_events_pose_batch": (
        "ops/raytrace_cuda.py:trace_events_pose_batch",),
    "ops/histogram_pallas.py:histogram_sum_banded_pallas": (
        "ops/histogram_cuda.py:histogram_sum_banded",),
    "diff/replay.py:record_paths_pallas": (
        "diff/replay.py:record_paths_kernels",),
    "diff/__init__.py:record_paths_pallas": (
        "diff/__init__.py:record_paths_kernels",),
}

SPEED_KNOB = "a TPU speed knob"
TPU_LAYOUT = "a TPU tile or VMEM layout"
FOLDED = "folded into the port's own code"

# JAX "module:name" -> (kind, what it was); kind is one of the three above.
NO_COUNTERPART = {
    "ops/raytrace_pallas_v2.py:tile_schedule_interval": (
        SPEED_KNOB, "a pallas_sched_prefilter mode: a superset of the exact "
        "schedule's candidates, the same IR"),
    "ops/raytrace_pallas_v2.py:tile_schedule_twostage": (
        SPEED_KNOB, "a pallas_sched_prefilter mode, as "
        "tile_schedule_interval"),
    "ops/raytrace_pallas_v2.py:tn_cols": (
        TPU_LAYOUT, "the lane-padded column count of the [rows, 128] tiles"),
    "ops/raytrace_pallas_v2.py:to_tiles": (
        TPU_LAYOUT, "the state into [tiles, 128] lane tiles; the port's "
        "state is [N, columns]"),
    "ops/raytrace_pallas_v2.py:from_tiles": (
        TPU_LAYOUT, "the inverse of to_tiles"),
    "ops/histogram_pallas.py:fits_vmem": (
        TPU_LAYOUT, "whether the accumulator fits VMEM"),
    "ops/histogram_pallas.py:max_bins": (
        TPU_LAYOUT, "the most bins whose accumulator fits VMEM"),
    "core/binning.py:USE_PALLAS_HISTOGRAM": (
        SPEED_KNOB, "the switch to the Pallas histogram; in the port the "
        "tensors' device picks K3 or index_add_"),
    "tuned.py:SCHED_TRI_BLOCK": (
        SPEED_KNOB, "pallas_tri_block of the clustered route"),
    "tuned.py:SCHED_UNROLL": (
        SPEED_KNOB, "pallas_sched_unroll of the clustered route"),
    "tuned.py:SMALL_UNROLL": (SPEED_KNOB, "pallas_unroll of the rows route"),
    "testing.py:on_tpu_suite": (
        FOLDED, "asks JAX for its backend; the port's assert_ir_close takes "
        "exact= explicitly"),
    "__init__.py:_enable_compile_cache": (
        FOLDED, "JAX's compile cache; the port caches its nvcc and g++ "
        "builds under _build/"),
    "core/tracer.py:_events_to_flat_bins": (
        FOLDED, "core/tracer.py:_histogram_from_events_posed"),
    "core/tracer.py:_slot_bins": (
        FOLDED, "core/tracer.py:_histogram_from_events_posed"),
    "renderer.py:_stereo_conv_sum": (
        FOLDED, "ops/convolve.py:convolve_file_stereo"),
    "renderer.py:_banded_conv_sum": (
        FOLDED, "ops/filterbank.py:convolve_file_banded"),
    "warmup.py:_timeit": (FOLDED, "warmup.py's own timing"),
    "utils/profiling.py:Timer": (
        FOLDED, "a host-clock timer nothing read; the port times its phases "
        "with utils/profiling.py:span, on the profiler's clock"),
    "utils/profiling.py:rays_per_second": (
        FOLDED, "a division nothing read; the benchmark computes its rates "
        "itself"),
}

# "file:line" of each pl.pallas_call( -> the CUDA sources that replace it,
# as (csrc file, C entry, wrapper module binding the entry), and the
# "replaces" strings chip_smoke.py's kernels line gives for it: the line of
# the kernel's function, of one of its branches or its posed form, or of
# the plain XLA tile_schedule whose lists the call's schedule branch reads.
KERNELS = {
    "ops/raytrace_pallas_v2.py:927": {
        "cuda": (("trace_round.cu", "ar2_trace_round", "ops/raytrace_cuda.py"),
                 ("trace_sched.cu", "ar2_trace_sched", "ops/schedule_cuda.py"),
                 ("tile_schedule.cu", "ar2_tile_schedule",
                  "ops/schedule_cuda.py"),
                 ("trace_traverse.cu", "ar2_trace_traverse",
                  "ops/traverse_cuda.py"),
                 ("trace_group.cu", "ar2_trace_group", "ops/group_cuda.py")),
        "replaces": ("ops/raytrace_pallas_v2.py:799",
                     "ops/raytrace_pallas_v2.py:501",
                     "ops/raytrace_pallas_v2.py:1103",
                     "ops/raytrace_pallas_v2.py:887",
                     "ops/raytrace_pallas_v2.py:547",
                     "ops/raytrace_pallas_v2.py:397"),
    },
    "ops/raytrace_pallas_v2.py:284": {
        "cuda": (("init_state.cu", "ar2_init_state", "ops/raytrace_cuda.py"),),
        "replaces": ("ops/raytrace_pallas_v2.py:284",),
    },
    "ops/histogram_pallas.py:87": {
        "cuda": (("histogram.cu", "ar2_histogram", "ops/histogram_cuda.py"),
                 ("histogram.cu", "ar2_histogram_binned",
                  "ops/histogram_cuda.py"),
                 ("histogram.cu", "ar2_histogram_bwd",
                  "ops/histogram_cuda.py")),
        "replaces": ("ops/histogram_pallas.py:59",
                     "ops/histogram_pallas.py:124"),
    },
    "ops/raytrace_pallas.py:452": {
        "cuda": (("trace_round.cu", "ar2_trace_round_v1", "ops/v1_cuda.py"),),
        "replaces": ("ops/raytrace_pallas.py:452",),
    },
}

# The functions whose device=None means the rank's GPU; every other default
# of a device parameter is "cuda". core/tracer_ref.py, the float64 oracle,
# runs on the host by nature and takes no device.
NONE_IS_THE_RANKS_GPU = {
    "parallel/sharding.py:make_mesh", "parallel/sharding.py:make_ray_mesh",
    "parallel/ir_sharding.py:make_segment_mesh",
    "utils/profiling.py:device_fence"}

_CONSTANT = re.compile(r"_?[A-Z][A-Z0-9_]*")


def _modules(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py")
                  if "_build" not in p.parts)


def _top_level(path: Path) -> dict:
    """name -> "def" / "class" / "constant" / "bound" for the module's
    top-level functions, classes, UPPER_CASE constants and every other
    name it binds (assignments, imports); "__all__" -> its list."""
    out = {}
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = "def"
        elif isinstance(node, ast.ClassDef):
            out[node.name] = "class"
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], "bound")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if not isinstance(e, ast.Name):
                        continue
                    if e.id == "__all__":
                        out["__all__"] = [ast.literal_eval(x)
                                          for x in node.value.elts]
                    else:
                        out[e.id] = ("constant" if _CONSTANT.fullmatch(e.id)
                                     else "bound")
    return out


def _port_has(ref: str) -> bool:
    module, name = ref.split(":")
    path = PORT / module
    return path.exists() and name in _top_level(path)


def _kind(kind: str) -> str:
    return "constant" if kind == "bound" else kind


@pytest.mark.parametrize("module", _modules(JAX))
def test_module_has_its_counterparts(module):
    jax_names = _top_level(JAX / module)
    port_path = PORT / module
    port_names = _top_level(port_path) if port_path.exists() else {}
    missing, wrong_kind = [], []
    for name, kind in jax_names.items():
        if name == "__all__" or kind == "bound":
            continue
        ref = f"{module}:{name}"
        if name.startswith("_"):
            # Private: only checked where the port kept the name.
            if name in port_names and _kind(port_names[name]) != kind:
                wrong_kind.append((name, kind, port_names[name]))
            continue
        if name in port_names or ref in NO_COUNTERPART:
            continue
        if ref in RENAMED:
            missing += [t for t in RENAMED[ref] if not _port_has(t)]
            continue
        missing.append(ref)
    package = port_path.parent
    for name in jax_names.get("__all__", []):
        # A package's __all__ may list its submodules.
        ref = f"{module}:{name}"
        if (name in port_names.get("__all__", []) or ref in NO_COUNTERPART
                or (package / f"{name}.py").exists()):
            continue
        if ref in RENAMED:
            missing += [t for t in RENAMED[ref] if not _port_has(t)]
            continue
        missing.append(f"{module}:__all__:{name}")
    assert not missing, f"no counterpart in the port: {missing}"
    assert not wrong_kind, f"kept private names of another kind: {wrong_kind}"


def test_tables_name_what_the_jax_package_has():
    """Every entry of RENAMED and NO_COUNTERPART names a top-level name of
    a JAX module; a NO_COUNTERPART name is absent from the port's module
    of the same path, and its kind is one of the three reasons."""
    for ref in (*RENAMED, *NO_COUNTERPART):
        module, name = ref.split(":")
        assert (JAX / module).exists(), ref
        assert name in _top_level(JAX / module), ref
    for ref, (kind, why) in NO_COUNTERPART.items():
        assert kind in (SPEED_KNOB, TPU_LAYOUT, FOLDED) and why, ref
        assert not _port_has(ref), f"{ref} exists in the port"


def _pallas_call_sites() -> list[str]:
    sites = []
    for module in _modules(JAX):
        lines = (JAX / module).read_text().splitlines()
        sites += [f"{module}:{i}" for i, line in enumerate(lines, 1)
                  if "pl.pallas_call(" in line]
    return sites


@pytest.mark.parametrize("site", _pallas_call_sites())
def test_pallas_call_site_has_its_kernel(site):
    assert site in KERNELS, f"{site}: a pallas_call with no CUDA kernel"
    row = KERNELS[site]
    signatures = (PORT / "ops/_build.py").read_text()
    for source, entry, wrapper in row["cuda"]:
        cu = PORT / "csrc" / source
        assert cu.exists(), cu
        assert re.search(rf'extern "C" int {entry}\(', cu.read_text()), (
            f"{source} defines no {entry}")
        assert f'"{entry}":' in signatures, f"_build.py declares no {entry}"
        assert f".{entry}(" in (PORT / wrapper).read_text(), (
            f"{wrapper} does not launch {entry}")
    smoke = SMOKE.read_text()
    for ref in row["replaces"]:
        assert f'"replaces": "audiorenderingv2_tpu/{ref}"' in smoke, ref


def test_kernel_rows_name_real_sites_and_cover_the_smoke_run():
    """No row outlives its pallas_call; every "replaces" of chip_smoke.py's
    kernels line stands in a row."""
    assert set(KERNELS) <= set(_pallas_call_sites())
    cited = set(re.findall(r'"replaces": "audiorenderingv2_tpu/([^"]+)"',
                           SMOKE.read_text()))
    listed = {r for row in KERNELS.values() for r in row["replaces"]}
    assert cited and cited <= listed, cited - listed


def _device_defaults() -> dict:
    """"module:qualname" -> the source of the default of its ``device``
    parameter, for every function and method of the port that has one."""
    out = {}

    def visit(module, body, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit(module, node.body, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                pos = a.posonlyargs + a.args
                defaults = [None] * (len(pos) - len(a.defaults)) + list(
                    a.defaults)
                for arg, default in [*zip(pos, defaults),
                                     *zip(a.kwonlyargs, a.kw_defaults)]:
                    if arg.arg == "device" and default is not None:
                        out[f"{module}:{prefix}{node.name}"] = ast.unparse(
                            default)

    for module in _modules(PORT):
        visit(module, ast.parse((PORT / module).read_text()).body, "")
    return out


def test_device_defaults_are_the_card():
    found = _device_defaults()
    for ref in ("core/tracer.py:scene_to_arrays",
                "convert.py:scene_arrays_from_jax",
                "convert.py:fit_state_from_jax",
                "renderer.py:AudioRenderer.__init__",
                "context.py:load_context", "multi.py:mix_sources"):
        assert ref in found, ref
    wrong = {ref: d for ref, d in found.items()
             if d not in ("'cuda'", '"cuda"')
             and not (d == "None" and ref in NONE_IS_THE_RANKS_GPU)}
    assert not wrong, f"device defaults that are not the card: {wrong}"
    none = {r for r, d in found.items() if d == "None"}
    assert none == NONE_IS_THE_RANKS_GPU
