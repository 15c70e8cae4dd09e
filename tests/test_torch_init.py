"""K4's plain version: the Philox4x32-10 stream against its published
known-answer vectors, the initial state's layout against the JAX package's
``init_state``, the directions' distribution, and a ``native_rng`` render
against a render of sampled directions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiorenderingv2_tpu as ar
from audiorenderingv2_tpu.ops import raytrace_pallas as rp
from audiorenderingv2_tpu.ops import raytrace_pallas_v2 as rp2
from audiorenderingv2_tpu_torch import convert
from audiorenderingv2_tpu_torch import testing as tt
from audiorenderingv2_tpu_torch.core import tracer as t_tracer
from audiorenderingv2_tpu_torch.core.params import TraceParams
from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
from audiorenderingv2_tpu_torch.renderer import AudioRenderer

torch.set_num_threads(1)

# Random123's kat_vectors, philox4x32 with 10 rounds: counter, key, output.
KAT = [
    ((0x00000000,) * 4, (0x00000000,) * 2,
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def _scal(emitter, e0, seed):
    s = torch.zeros(16)
    s[rc._S_EMX:rc._S_EMZ + 1] = torch.tensor(emitter)
    s[rc._S_E0] = e0
    s[rc._S_PAD14] = float(seed)
    return s


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = rc.philox4x32_10(counter, key)
    assert tuple(int(w) for w in got) == want
    # as tensors, several counters at once
    ctr = tuple(torch.tensor([c, c]) for c in counter)
    both = rc.philox4x32_10(ctr, key)
    assert all(w.tolist() == [x, x] for w, x in zip(both, want))


def test_native_words_are_a_function_of_seed_and_ray_index():
    """Counter (ray, 0, 0, 0), key (seed, 0): ray 0 under seed 0 is the
    all-zero known answer; a longer launch extends a shorter one; seeds
    differ."""
    w = rc.native_words(torch.tensor(0), 300)
    assert w.shape == (2, 300) and w.dtype == torch.int64
    assert w[:, 0].tolist() == [0x6627e8d5, 0xe169c58d]
    assert int(w.min()) >= 0 and int(w.max()) < 2**32
    assert torch.equal(rc.native_words(torch.tensor(0), 128), w[:, :128])
    w7 = rc.native_words(torch.tensor(7), 300)
    assert not (w7 == w).any()
    one = rc.philox4x32_10((299, 0, 0, 0), (7, 0))
    assert [int(one[0]), int(one[1])] == w7[:, 299].tolist()


@pytest.mark.parametrize("n_bands", [1, 3, 6])
def test_init_state_native_layout(n_bands):
    """Column by column: what the JAX package's init_state writes for the
    same directions (positions, directions, per-band energy, done flags),
    plus what K4 adds (RAYID, RECVD = -1) and the padding rays."""
    n, n_pad, e0 = 300, 384, 2.5e-6
    emitter = (1.0, -2.0, 0.5)
    st = rc.init_state_native(_scal(emitter, e0, 1234), n_pad, n, n_bands)
    assert st.shape == (rc.state_ncols(n_bands), n_pad)
    assert st.dtype == torch.float32
    d = st[rc._C_VX:rc._C_VZ + 1, :n].T.numpy().copy()
    ncols = rp2.state_ncols(n_bands)
    en_cols = tuple(rp2._band_cols(n_bands)[0])
    ref = np.asarray(rp.init_state(jnp.asarray(d), jnp.asarray(emitter), e0,
                                   n_pad, ncols=ncols, en_cols=en_cols)).T
    same = [c for c in range(ncols) if c not in (rc._C_RAYID, rc._C_RECVD)]
    np.testing.assert_array_equal(st[same][:, :n].numpy(), ref[same][:, :n])
    pad = st[:, n:]
    for c in same:
        if c not in (rc._C_VX, rc._C_VY, rc._C_VZ):  # padding has directions
            np.testing.assert_array_equal(pad[c].numpy(), ref[c, n:])
    assert torch.all(pad[rc._C_DONE] == 1) and torch.all(st[rc._C_DONE, :n]
                                                         == 0)
    for c in rc.band_cols(n_bands)[0]:
        assert torch.all(st[c, :n] == np.float32(e0)) and \
            torch.all(pad[c] == 0)
    assert torch.equal(st[rc._C_RAYID], torch.arange(n_pad).float())
    assert torch.all(st[rc._C_RECVD] == -1.0)
    touched = {*range(rc._C_PX, rc._C_VZ + 1), rc._C_DONE, rc._C_RAYID,
               rc._C_RECVD, *rc.band_cols(n_bands)[0]}
    for c in set(range(ncols)) - touched:
        assert not st[c].any(), c
    # the same mapping as core/sampling, from the same words
    u = (rc.native_words(torch.tensor(1234), n_pad) >> 8).float() / 2**24
    np.testing.assert_allclose(st[rc._C_VZ].numpy(), (2 * u[1] - 1).numpy(),
                               rtol=0, atol=0)
    theta = np.arctan2(st[rc._C_VY].numpy(), st[rc._C_VX].numpy()) % (
        2 * np.pi)
    np.testing.assert_allclose(theta, 2 * np.pi * u[0].numpy(), atol=2e-5)


def test_init_state_native_rejects_bad_inputs():
    s = _scal((0, 0, 0), 1.0, 1)
    with pytest.raises(ValueError, match=r"contiguous float32 \[16\]"):
        rc.init_state_native(s[:8], 128, 128)
    with pytest.raises(ValueError, match=r"contiguous float32 \[16\]"):
        rc.init_state_native(s.double(), 128, 128)
    with pytest.raises(ValueError, match="n_real <= n_pad"):
        rc.init_state_native(s, 128, 200)
    with pytest.raises(ValueError, match="1 to 8 bands"):
        rc.init_state_native(s, 128, 128, 9)
    with pytest.raises(ValueError, match="no init kernel for device"):
        rc.init_state_native(s.to("meta"), 128, 128)


def test_native_direction_moments():
    """65,536 directions: unit norm to 1e-6, a mean within 4 sigma of zero
    (sigma = sqrt(1/3 / N) per component), each octant within 5 sigma of
    N / 8, second moments 1/3."""
    n = 65536
    rc.init_launches = 0
    st = rc.init_state_native(_scal((0, 0, 0), 1.0, 424242), n, n)
    assert rc.init_launches == 0  # a CPU tensor: the plain version
    v = st[rc._C_VX:rc._C_VZ + 1].double().numpy()
    assert np.abs(np.linalg.norm(v, axis=0) - 1.0).max() < 1e-6
    sigma = np.sqrt(1.0 / 3.0 / n)
    assert np.abs(v.mean(axis=1)).max() < 4 * sigma, v.mean(axis=1)
    octant = (v[0] > 0) * 4 + (v[1] > 0) * 2 + (v[2] > 0)
    counts = np.bincount(octant, minlength=8)
    assert np.abs(counts - n / 8).max() < 5 * np.sqrt(n * 7 / 64), counts
    np.testing.assert_allclose((v * v).mean(axis=1), 1 / 3, atol=5e-3)
    assert len(np.unique(st[rc._C_VZ].numpy())) > 0.99 * n


def test_native_rng_render_within_seed_spread():
    """A native_rng render against renders of sampled directions at 16k
    rays: its per-ear energy within 6 standard deviations of the sampled
    renders' spread over 8 seeds (Monte-Carlo noise, as
    tests/test_torch_slice.py bounds the export), and on the statistical
    bar's energy term against their mean. K4's state goes through the same
    rounds: no [N, 3] directions are sampled."""
    v, t = tt.box_room((9.0, 6.0, 7.0))
    scene = tt.scene_from_arrays(v, t, 0.3)
    kw = dict(max_bounces=20, base_power=3.62, device="cpu")
    budgets = (2, 6, 12)
    energies = []
    for seed in range(8):
        r = AudioRenderer(scene, 1, 8000, 16384, seed=seed,
                          opts=t_tracer.TracerOptions(round_budgets=budgets),
                          **kw)
        r.set_receiver((2.0, 1.0, 1.5), 30.0)
        energies.append(r.render().sum(axis=1))
    energies = np.array(energies)
    mean, std = energies.mean(axis=0), energies.std(axis=0, ddof=1)
    assert np.all(std > 0) and np.all(std < 0.05 * mean), (mean, std)

    r = AudioRenderer(scene, 1, 8000, 16384, seed=0,
                      opts=t_tracer.TracerOptions(round_budgets=budgets,
                                                  native_rng=True), **kw)
    r.set_receiver((2.0, 1.0, 1.5), 30.0)
    calls = []
    real = rc.init_state_native
    rc.init_state_native = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        ir = r.render()
        again = r.render()
    finally:
        rc.init_state_native = real
    assert len(calls) == 2 and ir.shape == (2, 8000)
    e = ir.sum(axis=1)
    assert np.all(np.abs(e - mean) < 6 * std), (e, mean, std)
    assert np.all((ir > 0).sum(axis=1) > 300)
    assert not np.array_equal(ir, again)  # the generator gave a new seed
    np.testing.assert_allclose(again.sum(axis=1), mean, rtol=0.05)


def test_native_rng_trace_equals_its_own_directions():
    """trace_events with K4's state equals trace_events on the directions
    K4 generated, bit for bit: the native branch changes where directions
    come from and nothing else. The JAX option maps onto the port's."""
    sc = t_tracer.scene_to_arrays(
        tt.scene_from_arrays(*tt.box_room((9.0, 6.0, 7.0)), 0.3), 128,
        device="cpu")
    rows, _ = rc.pack_scene(sc)
    params = TraceParams(sample_rate=8000, ir_length=8000, base_power=3.62,
                         max_bounces=8)
    em, rcv = torch.zeros(3), torch.tensor([2.0, 1.0, 1.5])
    seed = torch.tensor(99)
    got = rc.trace_events(rows, None, em, rcv, 10.0, params,
                          round_budgets=(3, 5), n_rays=500,
                          native_rng_seed=seed)
    e0 = params.base_power / (500 * 4.18879020478)
    scal = rc.scalars(em, rcv, 10.0, e0, params)
    scal[rc._S_PAD14] = 99.0
    d = rc.init_state_native(scal, 512, 500)[rc._C_VX:rc._C_VZ + 1, :500].T
    want = rc.trace_events(rows, d.contiguous(), em, rcv, 10.0, params,
                           round_budgets=(3, 5))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[1] != 0).sum()) > 10
    j = ar.TracerOptions(pallas_native_rng=True)
    assert convert.tracer_options_from_jax(j).native_rng is True
