"""The port's segment-sharded convolution (``parallel/ir_sharding.py``) on
a 4-rank gloo world against JAX's ``convolve_file_sharded`` on conftest's
8-device CPU mesh and against the port's single-process
``convolve_file_stereo``: tests/test_ir_sharding.py's cases, halos inside
one hop and halos chained over several ranks. The world is spawned once
(tests/torch_parallel_worker.py) and writes every case's result.

Bars: against the port's single process, JAX's own bar (rtol 2e-4, atol
2e-6: the same FFTs, another summation order). Against JAX the FFTs
differ (torch.fft against jnp.fft): the port's single-process
``convolve_file_stereo`` is itself up to 2.7e-5 from JAX's on the 16 s
case, whose peak is 31, so there the atol is tests/test_torch_convolve.py's,
1e-5 of the peak."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as tw
from audiorenderingv2_tpu.parallel.ir_sharding import \
    convolve_file_sharded as j_convolve_sharded
from audiorenderingv2_tpu_torch.ops import convolve
from audiorenderingv2_tpu_torch.parallel import ir_sharding

torch.set_num_threads(1)

WORLD = 4
SR = tw.CONV_SR


@pytest.fixture(scope="module")
def segments_world(tmp_path_factory):
    return tw.run_world("segments", WORLD, tmp_path_factory.mktemp("segs"))


@pytest.mark.parametrize("sig_seconds,k", [
    (16, 2),    # 16 segments, divisible by 4: the wrap edge must still
                # deliver the last real segment's spill
    (16, 4),    # a 3 s halo chained over the spans
    (9, 2),     # silent segments pad the count
    (8, 3),     # local spans of 3 s: the halo crosses two ranks
    (16.5, 2),  # a partial trailing second keeps the tail inside L
])
def test_sharded_matches_jax_and_single_process(segments_world, sig_seconds,
                                                k):
    sig, ir = tw.conv_signal(sig_seconds), tw.conv_ir(k)
    got = segments_world[0][f"{sig_seconds}_{k}"]
    for other in segments_world[1:]:
        np.testing.assert_array_equal(other[f"{sig_seconds}_{k}"], got)
    jax_sharded = np.asarray(j_convolve_sharded(sig, ir, SR))
    single = convolve.convolve_file_stereo(torch.from_numpy(sig),
                                           torch.from_numpy(ir), SR).numpy()
    assert got.shape == single.shape == jax_sharded.shape == (2, sig.size)
    np.testing.assert_allclose(got, single, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(got, jax_sharded, rtol=2e-4,
                               atol=1e-5 * np.abs(jax_sharded).max())
    assert np.abs(got).max() > 0


def test_short_signals(segments_world):
    """Under a second: zeros of the signal's length. A second and a half:
    one segment processed, the output cut to the input's length."""
    zeros = segments_world[0]["0.5_2"]
    assert zeros.shape == (2, SR // 2) and not zeros.any()
    sig, ir = tw.conv_signal(1.5), tw.conv_ir(2)
    want = convolve.convolve_file_stereo(torch.from_numpy(sig),
                                         torch.from_numpy(ir), SR).numpy()
    np.testing.assert_allclose(segments_world[0]["1.5_2"], want, rtol=2e-4,
                               atol=2e-6)
    ref = np.asarray(j_convolve_sharded(jnp.asarray(sig), jnp.asarray(ir),
                                        SR))
    np.testing.assert_allclose(segments_world[0]["1.5_2"], ref, rtol=2e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_bad_ir_length_raises():
    mesh = ir_sharding.make_segment_mesh(device="cpu")
    with pytest.raises(ValueError, match="multiple of sample_rate"):
        ir_sharding.convolve_file_sharded(
            tw.conv_signal(4), np.zeros((2, SR + 7), np.float32), SR,
            mesh=mesh)


def test_world_of_one_equals_single_process():
    """Without a process group the mesh is a world of one: its halo comes
    back to itself past the signal's end and is dropped."""
    sig, ir = tw.conv_signal(9), tw.conv_ir(3)
    got = ir_sharding.convolve_file_sharded(
        sig, ir, SR, mesh=ir_sharding.make_segment_mesh(device="cpu"))
    want = convolve.convolve_file_stereo(torch.from_numpy(sig),
                                         torch.from_numpy(ir), SR)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-6)
