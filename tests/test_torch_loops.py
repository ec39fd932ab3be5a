"""sdrtpu_torch's feedback loops against sdrtpu's (both on the CPU, where
the port's `Agc` and `Pll` run their plain PyTorch loops).

Tolerances (the loops are contractive, so float32 rounding differences
between XLA and PyTorch do not grow):
- PLL / Costas: 2e-5 on the unit phasor / the mixed-down samples, 2e-5
  rad on the carried (phase, freq);
- AGC: 2e-5 relative on the output (its gain spans 1..1e7);
- NormalizedPilot: 1e-6; pilot_phase_fit: 5e-4 on the unit phasor — the
  fitted angle is a float32 ramp of ~0.5 rad/sample, so at the end of a
  5000-sample block one unit in its last place is 2.4e-4 rad.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import loops as jl  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.kernels import loops as tl  # noqa: E402

RNG = np.random.default_rng(23)


def _noise(n, s):
    return s * (RNG.standard_normal(n) + 1j * RNG.standard_normal(n))


def _pilot(n, fs=250000.0, f=19007.0, snr_amp=0.05):
    t = np.arange(n)
    return (0.1 * np.exp(1j * (2 * np.pi * f / fs * t + 0.7))
            + _noise(n, 0.1 * snr_amp)).astype(np.complex64)


def test_critically_damped_and_wrap():
    for bw in (0.01, 0.1, 25000.0 / 250000.0):
        assert tl.critically_damped(bw) == jl.critically_damped(bw)
    ph = np.array([-9.5, -np.pi, -0.1, 0.0, 3.0, np.pi, 3.5, 100.0],
                  np.float32)
    np.testing.assert_allclose(tl._wrap_pi(torch.as_tensor(ph)).numpy(),
                               np.asarray(jl._wrap_pi(jnp.asarray(ph))),
                               atol=1e-6)


def test_pll_streams_and_locks():
    fs = 250000.0
    w = 2 * np.pi * 19000.0 / fs
    kw = dict(init_phase=0.0, init_freq=w, min_freq=2 * np.pi * 18750 / fs,
              max_freq=2 * np.pi * 19250 / fs)
    jp, tp = jl.Pll(25000.0 / fs, **kw), tl.Pll(25000.0 / fs, device="cpu",
                                                 **kw)
    sj = jp.init_state()
    st = state_from_jax(sj, "cpu")
    x = _pilot(3000)
    for blk in (x[:1500], x[1500:]):
        sj, vj = jp(sj, jnp.asarray(blk))
        st, vt = tp(st, torch.as_tensor(blk))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=2e-5)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
        st = state_from_jax(state_to_numpy(st), "cpu")
    # locked: the VCO follows the pilot's phase
    lock = np.angle(vt.numpy()[-200:] * np.conj(x[-200:]))
    assert np.abs(lock).max() < 0.3


def test_pll_rows_are_independent():
    """(C, n) input: each row its own loop, equal to running it alone."""
    tp = tl.Pll(0.05, device="cpu")
    x = torch.as_tensor(np.stack([_pilot(400), _pilot(400, f=18900.0)]))
    st, v = tp(tp.init_state(), x)
    assert v.shape == (2, 400) and st[0].shape == (2,)
    for r in range(2):
        s1, v1 = tp(tp.init_state(), x[r])
        np.testing.assert_array_equal(v1.numpy(), v[r].numpy())
        assert float(s1[0]) == float(st[0][r])


@pytest.mark.parametrize("order", [2, 4, 8])
def test_costas_streams(order):
    n = 600
    sym = np.exp(2j * np.pi * RNG.integers(0, order, n) / order)
    x = (sym * np.exp(1j * (0.02 * np.arange(n) + 0.3))
         + _noise(n, 0.05)).astype(np.complex64)
    jc = jl.Costas(order, 0.05)
    tc = tl.Costas(order, 0.05, device="cpu")
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    for blk in (x[:300], x[300:]):
        sj, yj = jc(sj, jnp.asarray(blk))
        st, yt = tc(st, torch.as_tensor(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
        st = state_from_jax(state_to_numpy(st), "cpu")


@pytest.mark.parametrize("cplx", [False, True])
def test_agc_streams_from_zero_average(cplx):
    """The radio's audio AGC: init_gain = inf, so amp starts at 0 and
    set_point/amp must never be formed from it; silent samples (exact
    zeros) hold the average; a burst trips the clipping look-ahead."""
    fs = 15000.0
    kw = dict(set_point=1.0, attack=50.0 / fs, decay=5.0 / fs, max_gain=10e6,
              max_output_amp=10.0, init_gain=np.inf)
    ja, ta = jl.Agc(**kw), tl.Agc(device="cpu", **kw)
    sj = ja.init_state()
    st = state_from_jax(sj, "cpu")
    assert float(st) == 0.0
    n = 1500
    x = 1e-3 * RNG.standard_normal(n)
    if cplx:
        x = x + 1e-3j * RNG.standard_normal(n)
    x[:5] = 0.0          # silence first: amp stays 0, gain 1
    x[400:420] = 0.0
    x[700:705] *= 3e4    # burst -> ia * gain > max_output_amp
    x = x.astype(np.complex64 if cplx else np.float32)
    for blk in (x[:750], x[750:]):
        sj, yj = ja(sj, jnp.asarray(blk))
        st, yt = ta(st, torch.as_tensor(blk))
        yj = np.asarray(yj)
        assert np.isfinite(yt.numpy()).all()
        np.testing.assert_allclose(yt.numpy(), yj, rtol=2e-5, atol=1e-9)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-5)
        st = state_from_jax(state_to_numpy(st), "cpu")
    assert yt.dtype == (torch.complex64 if cplx else torch.float32)


def test_agc_rows_are_independent():
    ta = tl.Agc(1.0, 0.01, 0.001, device="cpu")
    x = torch.as_tensor(RNG.standard_normal((3, 200)).astype(np.float32))
    st, y = ta(ta.init_state(), x)
    assert st.shape == (3,)
    for r in range(3):
        s1, y1 = ta(ta.init_state(), x[r])
        np.testing.assert_array_equal(y1.numpy(), y[r].numpy())
        assert float(s1) == float(st[r])


def test_normalized_pilot():
    p = _pilot(500)
    p[10] = 0.0
    _, vj = jl.NormalizedPilot()((), jnp.asarray(p))
    _, vt = tl.NormalizedPilot(device="cpu")((), torch.as_tensor(p))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    assert vt.numpy()[10] == 1.0 + 0.0j


def test_pilot_phase_fit_batched():
    """Each row fits on its own: reductions over the time axis only."""
    p = np.stack([_pilot(5000, f=19003.0), _pilot(5000, f=18995.0),
                  _pilot(5000, f=19000.0)])
    vj = np.asarray(jl.pilot_phase_fit(jnp.asarray(p), 19000.0, 250000.0))
    vt = tl.pilot_phase_fit(torch.as_tensor(p), 19000.0, 250000.0).numpy()
    assert vt.shape == p.shape and vt.dtype == np.complex64
    np.testing.assert_allclose(vt, vj, atol=5e-4)
    for r in range(3):
        v1 = tl.pilot_phase_fit(torch.as_tensor(p[r]), 19000.0,
                                250000.0).numpy()
        np.testing.assert_allclose(v1, vt[r], atol=1e-6)
