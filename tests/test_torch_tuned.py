"""The port's tuned.py against the JAX package's: the scene option builders,
``auto_options`` and the benchmark builders with their AR2_BENCH_*
overrides, each JAX configuration mapped through
``convert.tracer_options_from_jax``."""
import dataclasses

import pytest

from audiorenderingv2_tpu import tuned as j_tuned
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch import tuned as t_tuned
from audiorenderingv2_tpu_torch.core.tracer import TracerOptions

DEFAULTS = TracerOptions()


def _mapped(jax_opts) -> TracerOptions:
    """JAX options through ``convert``, with the differentiable trace's
    block sizes at the port's defaults: the builders ignore JAX's
    ``block_size`` (``AR2_BENCH_BLOCK``) and its fixed ``tri_chunk``, which
    sized TPU blocks."""
    return dataclasses.replace(convert.tracer_options_from_jax(jax_opts),
                               block_size=DEFAULTS.block_size,
                               tri_chunk=DEFAULTS.tri_chunk)


@pytest.mark.parametrize("max_bounces", [4, 8, 32, 100])
def test_scene_option_builders_match_jax(max_bounces):
    assert t_tuned.small_scene_options(max_bounces) == _mapped(
        j_tuned.small_scene_options(max_bounces))
    assert t_tuned.clustered_scene_options() == _mapped(
        j_tuned.clustered_scene_options())


@pytest.mark.parametrize("n_tris,max_bounces", [(12, 100), (332, 8),
                                                (511, 32), (512, 32),
                                                (19852, 32)])
def test_auto_options_unchanged_and_built_by_the_builders(n_tris,
                                                          max_bounces):
    """``auto_options`` returns what the builders build, the options it
    returned before they existed, and JAX's route and cluster size."""
    opts, cs = t_tuned.auto_options(n_tris, max_bounces)
    j_opts, j_cs = j_tuned.auto_options(n_tris, max_bounces, backend="pallas")
    assert cs == j_cs
    assert opts == _mapped(j_opts)
    if cs is None:
        assert opts == t_tuned.small_scene_options(max_bounces) == \
            TracerOptions(round_budgets=t_tuned.round_budgets_for(max_bounces))
    else:
        assert opts == t_tuned.clustered_scene_options() == \
            TracerOptions(schedule=True)


def test_bench_builders_default_to_auto_options():
    assert t_tuned.bench_small_options({}) == t_tuned.auto_options(12, 100)[0]
    assert t_tuned.bench_large_options({}) == \
        t_tuned.auto_options(19852, 32)[0]
    assert t_tuned.bench_large_cluster_size({}) == t_tuned.CLUSTER_SIZE == \
        j_tuned.bench_large_cluster_size({})


# One environment per AR2_BENCH_* variable the JAX builders read (and a
# mix): the mapped fields carry over, the TPU-only knobs change nothing.
BENCH_ENVS = {
    "none": {},
    "budgets": {"AR2_BENCH_BUDGETS": "4,12,84"},
    "budgets_empty": {"AR2_BENCH_BUDGETS": ""},
    "backend_xla": {"AR2_BENCH_BACKEND": "xla"},
    "layout_group": {"AR2_BENCH_LAYOUT": "group"},
    "layout_auto": {"AR2_BENCH_LAYOUT": "auto"},
    "native_rng": {"AR2_BENCH_NATIVE_RNG": "1"},
    "native_rng_xla": {"AR2_BENCH_NATIVE_RNG": "1",
                       "AR2_BENCH_BACKEND": "xla"},
    "schedule_off": {"AR2_BENCH_SCHEDULE": "0"},
    "cluster_size": {"AR2_BENCH_CLUSTER_SIZE": "128"},
    "block": {"AR2_BENCH_BLOCK": "4096"},
    "tile": {"AR2_BENCH_TILE": "512"},
    "unroll": {"AR2_BENCH_UNROLL": "2"},
    "rng": {"AR2_BENCH_RNG": "threefry"},
    "keys": {"AR2_BENCH_KEYS": "cell"},
    "cell_bits": {"AR2_BENCH_CELL_BITS": "3"},
    "tri_block": {"AR2_BENCH_TRI_BLOCK": "16"},
    "sched_unroll": {"AR2_BENCH_SCHED_UNROLL": "2"},
    "dir_split": {"AR2_BENCH_DIR_SPLIT": "1"},
    "mix": {"AR2_BENCH_BUDGETS": "2,6", "AR2_BENCH_LAYOUT": "group",
            "AR2_BENCH_NATIVE_RNG": "1", "AR2_BENCH_SCHEDULE": "0",
            "AR2_BENCH_CLUSTER_SIZE": "64", "AR2_BENCH_UNROLL": "4"},
}
TPU_ONLY = ("block", "tile", "unroll", "rng", "keys", "cell_bits",
            "tri_block", "sched_unroll", "dir_split")


@pytest.mark.parametrize("name", sorted(BENCH_ENVS))
def test_bench_builders_match_jax(name):
    env = BENCH_ENVS[name]
    small = t_tuned.bench_small_options(env)
    large = t_tuned.bench_large_options(env)
    assert small == _mapped(j_tuned.bench_small_options(env))
    assert large == _mapped(j_tuned.bench_large_options(env))
    assert t_tuned.bench_large_cluster_size(env) == \
        j_tuned.bench_large_cluster_size(env)
    if name in TPU_ONLY:
        assert small == t_tuned.bench_small_options({})
        assert large == t_tuned.bench_large_options({})


def test_bench_builders_read_os_environ(monkeypatch):
    """By default the builders read the process's environment, as the
    JAX package's do."""
    monkeypatch.setenv("AR2_BENCH_BUDGETS", "3,5")
    monkeypatch.setenv("AR2_BENCH_SCHEDULE", "0")
    monkeypatch.setenv("AR2_BENCH_CLUSTER_SIZE", "64")
    assert t_tuned.bench_small_options().round_budgets == (3, 5)
    assert not t_tuned.bench_large_options().schedule
    assert t_tuned.bench_large_cluster_size() == 64


def test_bench_small_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        t_tuned.bench_small_options({"AR2_BENCH_BACKEND": "triton"})
