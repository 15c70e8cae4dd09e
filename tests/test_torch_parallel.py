"""The port's rays sharded over processes (``parallel/sharding.py``,
``multi.render_ir_matrix(mesh=)``, ``dryrun.py``) against the JAX package
and against single-process replays.

Each world of gloo ranks on the CPU is spawned once per module
(tests/torch_parallel_worker.py, which imports the port only) and writes
its results as .npz files that the tests read. The JAX side runs as
tests/test_sharding.py runs it, on conftest's 8-device CPU mesh; the same
numpy directions go to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import audiorenderingv2_tpu as ar
import torch_parallel_worker as tw
from audiorenderingv2_tpu.parallel import \
    trace_directions_sharded as j_trace_sharded
from audiorenderingv2_tpu_torch import dryrun, testing
from audiorenderingv2_tpu_torch.core import sampling
from audiorenderingv2_tpu_torch.core.tracer import (TracerOptions, render_ir,
                                                    trace_ir)
from audiorenderingv2_tpu_torch.parallel import sharding

torch.set_num_threads(1)

RAYS_WORLD = 4
PAIRS_WORLD = 2


@pytest.fixture(scope="module")
def rays_world(tmp_path_factory):
    return tw.run_world("rays", RAYS_WORLD, tmp_path_factory.mktemp("rays"))


@pytest.fixture(scope="module")
def pairs_world(tmp_path_factory):
    return tw.run_world("pairs", PAIRS_WORLD,
                        tmp_path_factory.mktemp("pairs"))


def _j_problem(max_bounces=6):
    v, t = testing.box_room(tw.BOX)
    sc = ar.scene_to_arrays(testing.scene_from_arrays(v, t, 0.3), 128)
    return sc, ar.TraceParams(sample_rate=16000, ir_length=16000,
                              base_power=3.62, max_bounces=max_bounces)


@pytest.mark.parametrize("j_backend", ["xla", "pallas_rows_interpret"])
def test_trace_directions_sharded_matches_jax(rays_world, j_backend):
    """2048 seeded directions through the port's 4-rank gloo world and
    through JAX's trace_directions_sharded on its 8-device mesh: the XLA
    tracer, and the rows Pallas kernel in interpret mode. The two packages'
    f32 differ in operation order, so the statistical bar."""
    sc, params = _j_problem()
    opts = (ar.TracerOptions(block_size=128, tri_chunk=128)
            if j_backend == "xla" else
            ar.TracerOptions(backend="pallas", pallas_version=2,
                             pallas_interpret=True))
    ref = np.asarray(j_trace_sharded(
        sc, jnp.asarray(tw.unit_dirs(2048, 5)), jnp.zeros(3),
        jnp.asarray(tw.RECEIVER), 20.0, params, opts))
    got = rays_world[0]["traced"]
    assert got.shape == ref.shape == (2, 16000) and got.sum() > 0
    testing.assert_ir_close(got, ref, exact=False)


def test_ranks_hold_the_same_results(rays_world, pairs_world):
    """Every rank returns the replicated IRs and gradient bit for bit."""
    for world in (rays_world, pairs_world):
        for other in world[1:]:
            assert other.keys() == world[0].keys()
            for k in world[0]:
                np.testing.assert_array_equal(other[k], world[0][k], err_msg=k)


def test_sharded_trace_equals_single_process_trace(rays_world):
    """The shards' IRs summed equal one trace_ir of all 2048 directions,
    up to the order of the f32 sums (the padding of each 512-ray shard adds
    no energy)."""
    _, sc, params = tw.box_problem()
    single = trace_ir(sc, torch.from_numpy(tw.unit_dirs(2048, 5)),
                      np.zeros(3), tw.RECEIVER, 20.0, params).numpy()
    np.testing.assert_allclose(rays_world[0]["traced"], single, rtol=1e-6,
                               atol=1e-12)


def test_render_ir_sharded_replays_the_rank_streams(rays_world):
    """Rank r drew its 512 directions from pose_generator(seed, r): a
    single process tracing those streams together at 2048 rays' energy
    gives the sharded IR; the streams differ from rank to rank (reusing
    rank 0's would keep the mean and not cut the noise)."""
    _, sc, params = tw.box_problem()
    streams = [sampling.sample_directions(
        2048 // RAYS_WORLD, sampling.pose_generator(5, r, "cpu"), "cpu")
        for r in range(RAYS_WORLD)]
    for a in range(RAYS_WORLD):
        for b in range(a + 1, RAYS_WORLD):
            assert not torch.equal(streams[a], streams[b])
    replay = trace_ir(sc, torch.cat(streams), np.zeros(3), tw.RECEIVER, 20.0,
                      params).numpy()
    got = rays_world[0]["rendered"]
    assert got.sum() > 0
    np.testing.assert_allclose(got, replay, rtol=1e-6, atol=1e-12)
    # one rank's render alone, at that rank's share of the energy
    alone = render_ir(sc, sampling.pose_generator(5, 1, "cpu"), 512,
                      np.zeros(3), tw.RECEIVER, 20.0, params,
                      n_total_rays=2048).numpy()
    assert 0 < alone.sum() < got.sum()


def test_indivisible_rays_raise():
    _, sc, params = tw.box_problem()
    mesh = sharding.Mesh(sharding.RAYS_AXIS, None, 0, 3,
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        sharding.render_ir_sharded(sc, 0, 1000, np.zeros(3), tw.RECEIVER,
                                   0.0, params, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.trace_directions_sharded(sc, tw.unit_dirs(1000, 0),
                                          np.zeros(3), tw.RECEIVER, 0.0,
                                          params, mesh=mesh)


def test_sharded_gradient_matches_single_process_and_jax(rays_world):
    """d mean(IR^2) / d(material logits) with soft binning, 4 bounces, 512
    directions (tests/test_multihost.py's step): the 4-rank gradient
    (identity-backward all-reduce of the IR, then the gradients'
    all-reduce) within 1e-3 of the port's single-process gradient, and
    within 1e-2 of the gradient's norm of jax.grad on one device: the bar
    of tests/test_torch_grad.py::test_pose_gradients_match_jax, whose
    docstring says why (JAX's CPU histogram VJP). An all-reduce whose
    backward all-reduced again would give 4x."""
    scene, sc, params = tw.box_problem()
    p4 = dataclasses.replace(params, max_bounces=4)
    dirs = tw.unit_dirs(512, 3)
    loss, logits = tw.material_loss(sc, scene, lambda s: trace_ir(
        s, torch.from_numpy(dirs), np.zeros(3), tw.RECEIVER, 0.0, p4,
        tw.grad_options()))
    loss.backward()
    single = logits.grad.numpy()
    got = rays_world[0]["grad"]
    assert np.abs(single).sum() > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, single, rtol=1e-3, atol=1e-12)
    assert float(rays_world[0]["loss"]) == pytest.approx(loss.item(),
                                                         rel=1e-5)

    from audiorenderingv2_tpu.diff import (material_ids_padded,
                                           with_material_absorption)

    jsc, jparams = _j_problem(max_bounces=4)
    mat_ids = material_ids_padded(scene, jsc.absorption.shape[0])
    jopts = ar.TracerOptions(block_size=128, tri_chunk=128, early_exit=False,
                             soft_binning=True)

    def j_loss(lg):
        sc_t = with_material_absorption(jsc, mat_ids, jax.nn.sigmoid(lg))
        ir = ar.trace_ir(sc_t, jnp.asarray(dirs), jnp.zeros(3),
                         jnp.asarray(tw.RECEIVER), 0.0, jparams, jopts)
        return jnp.mean(ir ** 2)

    g_jax = np.asarray(jax.grad(j_loss)(jnp.zeros((1,), jnp.float32)))
    np.testing.assert_allclose(got, g_jax, rtol=0,
                               atol=1e-2 * np.linalg.norm(g_jax))


def test_render_ir_matrix_mesh_replays_each_pair(pairs_world):
    """render_ir_matrix(mesh=) 2 x 2 on 2 ranks, fused and pair by pair,
    against a single-process replay of each pair: rank r's 256 directions
    from pose_generator(11, pair, rank=r), traced together at 512 rays'
    energy."""
    _, sc, params = tw.box_problem()
    opts = TracerOptions(round_budgets=(2, 4))
    fused, single = pairs_world[0]["fused"], pairs_world[0]["single"]
    assert fused.shape == (2, 2, 2, 16000)
    np.testing.assert_array_equal(fused, single)
    em_p = np.repeat(tw.MATRIX_EMITTERS, 2, axis=0)
    rc_p = np.tile(tw.MATRIX_RECEIVERS, (2, 1))
    yw_p = np.tile(tw.MATRIX_YAWS, 2)
    for i in range(4):
        dirs = torch.cat([sampling.sample_directions(
            512 // PAIRS_WORLD, sampling.pose_generator(11, i, "cpu", rank=r),
            "cpu") for r in range(PAIRS_WORLD)])
        replay = trace_ir(sc, dirs, em_p[i], rc_p[i], float(yw_p[i]), params,
                          opts).numpy()
        assert replay.sum() > 0
        np.testing.assert_allclose(fused[i // 2, i % 2], replay, rtol=1e-6,
                                   atol=1e-12)


def test_render_ir_matrix_mesh_pair_is_render_ir_sharded(pairs_world):
    """A pair of the sharded matrix is render_ir_sharded of its pair seed
    fold_seed(seed, pair) on the same mesh, on every rank, as the JAX
    package composes render_ir_sharded(fold_in(key, i))."""
    for r in pairs_world:
        np.testing.assert_array_equal(r["fused"][1, 1], r["pair3"])


def test_pose_generator_folds_pose_then_rank():
    """A rank's share of a pose draws from fold_seed(fold_seed(seed,
    pose), rank): the stream render_ir_sharded of the pose's seed draws
    on that rank, and another stream than the rank's of another pose."""
    def draw(gen):
        return sampling.sample_directions(64, gen, "cpu")

    a = draw(sampling.pose_generator(11, 3, "cpu", rank=1))
    b = draw(sampling.pose_generator(sampling.fold_seed(11, 3), 1, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, draw(sampling.pose_generator(
        sampling.fold_seed(11, 1), 3, "cpu")))
    assert not torch.equal(a, draw(sampling.pose_generator(11, 3, "cpu")))


def test_dryrun_multichip_two_ranks(pairs_world):
    """dryrun_multichip(2) on gloo ranks: a finite loss, its gradient that
    of the same step in one process, a clustered IR and a convolution."""
    r0 = pairs_world[0]
    assert np.isfinite(r0["dry_loss"]) and float(r0["dry_loss"]) > 0
    loss, grad = dryrun.unsharded_train_gradient(PAIRS_WORLD, "cpu")
    assert np.abs(grad).sum() > 0
    np.testing.assert_allclose(r0["dry_grad"], grad, rtol=1e-3, atol=1e-15)
    assert float(r0["dry_loss"]) == pytest.approx(loss, rel=1e-5)
    assert float(r0["dry_ir_sum"]) > 0 and float(r0["dry_conv_peak"]) > 0


def test_init_distributed_contract(monkeypatch):
    """A single process is a no-op; otherwise the backend defaults to gloo
    without CUDA, and the group is made at the coordinator's address."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    sharding.init_distributed("127.0.0.1:1234", None, 0)
    sharding.init_distributed("127.0.0.1:1234", 1, 0)
    assert not calls and not dist.is_initialized()
    sharding.init_distributed("127.0.0.1:1234", 2, 1)
    (args, kwargs), = calls
    assert args == ("nccl" if torch.cuda.is_available() else "gloo",)
    assert kwargs == {"init_method": "tcp://127.0.0.1:1234",
                      "world_size": 2, "rank": 1}


def test_mesh_without_a_process_group():
    """No process group: a world of one, no collective, the card by
    default; a group given without torch.distributed raises."""
    mesh = sharding.make_ray_mesh(device="cpu")
    assert (mesh.axis, mesh.group, mesh.rank, mesh.size) == (
        "rays", None, 0, 1)
    assert mesh.device == torch.device("cpu")
    assert sharding.make_ray_mesh().device.type == "cuda"
    x = torch.ones(3, requires_grad=True)
    assert sharding.sum_across_ranks(x, mesh) is x
    with pytest.raises(ValueError, match="initialised"):
        sharding.make_ray_mesh(group=object())
