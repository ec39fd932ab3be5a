"""The fft channelizer of sdrtpu_torch against sdrtpu (both on the CPU).

Tolerances:
- plans and host tables (chunk plan, fold table G, rotator tables,
  group-delay and residual phases): exact;
- IF output: 1e-5 of the peak — pocketfft and torch's FFT take their
  sums in another order, and the fold contracts 40 alias rows;
- carried state: the wideband tail exactly, the float32 rotator phase
  to 2e-6 rad (both reduce mod 2*pi in float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.shard import channelizer as jch  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402
from sdrtpu_torch.kernels import chunks  # noqa: E402
from sdrtpu_torch.shard import channelizer as tch  # noqa: E402

RNG = np.random.default_rng(3)


def _blocks(n, k):
    return [(RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64) for _ in range(k)]


def _equal_tables(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fs,n,offs", [
    (2e6, 20000, np.linspace(-0.35, 0.35, 4) * 2e6),    # the test plan
    (10e6, 500000, np.linspace(-0.4, 0.4, 8) * 10e6),   # the 8-VFO flagship
    (50e6, 200000, np.array([-20e6, -3.7e6, 11e6])),    # an R=200 plan
])
def test_plan_and_tables_equal(fs, n, offs):
    jc = jch.Channelizer(offs, fs, 250e3, n, method="fft", skip_rotator=True)
    tc = tch.Channelizer(offs, fs, 250e3, n, skip_rotator=True, device="cpu")
    jf, tf = jc.fused, tc.fused
    assert tc.method == "fft"
    assert ((tf.valid, tf.nfft, tf.tpad, tf.nif, tf.n_chunks, tf.ratio)
            == (jf.valid, jf.nfft, jf.tpad, jf.nif, jf.n_chunks, jf.ratio))
    for attr in ("_g_folded", "_phase0", "residual_omega"):
        _equal_tables(getattr(tf, attr), getattr(jf, attr))
    for attr in ("_coarse_t", "_fine_t", "_delta"):
        _equal_tables(getattr(tf.rot, attr), getattr(jf.rot, attr))


def test_flagship_plan_values():
    """The plan K1 runs at on the 8-VFO flagship and in the CPU tests."""
    fl = tch.Channelizer(np.linspace(-4e6, 4e6, 8), 10e6, 250e3, 500000,
                         device="cpu").fused
    assert (fl.valid, fl.ratio, fl.nif, fl.nfft, fl.tpad, fl.n_chunks) == (
        4000, 40, 128, 5120, 1121, 125)
    small = tch.Channelizer(np.zeros(4), 2e6, 250e3, 20000, device="cpu").fused
    assert (small.valid, small.ratio, small.nif) == (160, 8, 40)


def test_mixer_call_and_rotate_blocks():
    offs = np.array([-433e3, 12.5e3, 610e3])
    n, K = 2000, 5
    jm = jch.MultiVfoMixer(offs, 2e6, n)
    tm = tch.MultiVfoMixer(offs, 2e6, n, device="cpu")
    sj, st = jm.init_state(), tm.init_state()
    x = _blocks(K * n, 1)[0]
    for b in range(2):
        xb = x[b * n:(b + 1) * n]
        sj, yj = jm(sj, jnp.asarray(xb))
        st, yt = tm(st, torch.as_tensor(xb))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-6)
        np.testing.assert_allclose(st["phase"].numpy(),
                                   np.asarray(sj["phase"]), atol=2e-6)
    y = np.stack([x] * 3)
    sj, yj = jm.rotate_blocks(sj, jnp.asarray(y), K)
    st, yt = tm.rotate_blocks(st, torch.as_tensor(y), K)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=5e-6)
    np.testing.assert_allclose(st["phase"].numpy(), np.asarray(sj["phase"]),
                               atol=2e-6)


def _check_state(st_t, st_j):
    _equal_tables(st_t["fused"]["tail"].numpy(), st_j["fused"]["tail"])
    _equal_tables(st_t["fused"]["hf"].numpy(), st_j["fused"]["hf"])
    np.testing.assert_allclose(st_t["fused"]["rot"]["phase"].numpy(),
                               np.asarray(st_j["fused"]["rot"]["phase"]),
                               atol=2e-6)


@pytest.mark.parametrize("skip_rotator", [False, True])
def test_fft_channelizer_streams_and_retunes(skip_rotator):
    """Three blocks, a retune before the third (channel 1 unmoved), and
    one two-block window (K=2 takes the closed-form rotator)."""
    fs, n = 10e6, 40000
    offs_a = np.array([-4e6, -1.2e6, 2e6])
    offs_b = np.array([-3.5e6, -1.2e6, 2.5e6])
    jc = jch.Channelizer(offs_a, fs, 250e3, n, method="fft",
                         skip_rotator=skip_rotator)
    tc = tch.Channelizer(offs_a, fs, 250e3, n, method="fft",
                         skip_rotator=skip_rotator, device="cpu")
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    blocks = _blocks(n, 5)
    for i, b in enumerate(blocks[:3]):
        if i == 2:
            sj = jc.retune_state(sj, offs_b)
            st = tc.retune_state(st, offs_b)
            _equal_tables(tc.fused.residual_omega, jc.fused.residual_omega)
        sj, yj = jc(sj, jnp.asarray(b))
        st, yt = tc(st, torch.as_tensor(b))
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=1e-5 * np.abs(yj).max())
        _check_state(st, tree_map(np.asarray, sj))
    window = np.concatenate(blocks[3:])
    sj, yj = jc(sj, jnp.asarray(window))
    st, yt = tc(st, torch.as_tensor(window))
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5 * np.abs(yj).max())
    _check_state(st, tree_map(np.asarray, sj))
    # the numpy round trip gives back the same nest
    back = state_to_numpy(st)
    assert back["fused"]["tail"].dtype == np.complex64
    assert back["poly"] == () and back["rest"] == ()


def test_retune_no_phase_step_on_unmoved_channel():
    fs, n = 10e6, 40000
    offs_a, offs_b = np.array([-4e6, 2e6]), np.array([-3.5e6, 2e6])
    blocks = _blocks(n, 3)
    base = tch.Channelizer(offs_a, fs, 250e3, n, device="cpu")
    cz = tch.Channelizer(offs_a, fs, 250e3, n, device="cpu")
    sb, st = base.init_state(), cz.init_state()
    sb, _ = base(sb, torch.as_tensor(blocks[0]))
    st, _ = cz(st, torch.as_tensor(blocks[0]))
    st = cz.retune_state(st, offs_b)
    for b in blocks[1:]:
        sb, ref = base(sb, torch.as_tensor(b))
        st, got = cz(st, torch.as_tensor(b))
        np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(),
                                   atol=1e-4 * ref[1].abs().max().item())


def test_channelizer_runs_the_chunk_wrapper():
    cz = tch.Channelizer(np.array([1e5]), 2e6, 250e3, 20000, device="cpu")
    calls = []
    real = tch.chunk_poly

    def spy(*a):
        calls.append(a[1:])
        return real(*a)

    tch.chunk_poly = spy
    try:
        cz(cz.init_state(), torch.zeros(40000, dtype=torch.complex64))
    finally:
        tch.chunk_poly = real
    assert calls == [(160, 8, 40, 250)] and real is chunks.chunk_poly


def test_skip_rotator_guard_is_stricter_than_the_reference():
    """The IF is left un-derotated under skip_rotator, so a channel
    lowpass or a fractional resampler tail would filter the wrong band.
    The reference accepts these (ADVICE.md); the port raises."""
    offs = np.array([0.0])
    jch.Channelizer(offs, 2e6, 250e3, 20000, method="fft", skip_rotator=True,
                    low_pass_bw=150e3)
    with pytest.raises(ValueError, match="skip_rotator"):
        tch.Channelizer(offs, 2e6, 250e3, 20000, skip_rotator=True,
                        low_pass_bw=150e3, device="cpu")
    with pytest.raises(ValueError, match="skip_rotator"):
        tch.Channelizer(offs, 20e6, 48e3, 400000, skip_rotator=True,
                        device="cpu")

