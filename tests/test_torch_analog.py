"""sdrtpu_torch's NFM / AM / SSB / CW demodulators against sdrtpu's (both
on the CPU; the port's AGC runs its plain loop).

Tolerances:
- NFM: 2e-5 absolute (atan2 of the same products, then a FIR);
- AM, SSB, CW: 5e-5 of the block's peak — the AGC's gain is a quotient
  of float32 averages, carried through ~1000 contractive steps, times the
  DC blocker's log-depth recurrence in AM.
Each test streams two blocks with the state handed over through
``convert``, and checks that the recovered tone is the one sent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import analog as ja  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402
from sdrtpu_torch.kernels import analog as ta  # noqa: E402

RNG = np.random.default_rng(24)


def _noise(n, s):
    return s * (RNG.standard_normal(n) + 1j * RNG.standard_normal(n))


def _tone_hz(y, fs):
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    spec[:3] = 0.0
    return np.argmax(spec) * fs / len(y)


def _stream(jd, td, x, rel):
    sj = jd.init_state()
    st = state_from_jax(sj, "cpu")
    n = len(x) // 2
    outs = []
    for blk in (x[:n], x[n:]):
        sj, yj = jd(sj, jnp.asarray(blk))
        st, yt = td(st, torch.as_tensor(blk))
        yj = np.asarray(yj)
        assert yt.dtype == torch.float32 and yt.shape == (n,)
        assert np.isfinite(yt.numpy()).all()
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=rel * max(np.abs(yj).max(), 1.0))
        st = state_from_jax(state_to_numpy(st), "cpu")
        outs.append(yt.numpy())
    leaves_t, leaves_j = [], []
    tree_map(lambda a: leaves_t.append(a.numpy()), st)
    tree_map(lambda a: leaves_j.append(np.asarray(a)), sj)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a, b, rtol=5e-5, atol=1e-5)
    return np.concatenate(outs)


@pytest.mark.parametrize("low_pass", [True, False])
def test_nfm(low_pass):
    fs, n = 50000.0, 5000
    t = np.arange(n) / fs
    ph = np.cumsum(2 * np.pi * 3000.0 * np.sin(2 * np.pi * 1000.0 * t) / fs)
    x = (0.5 * np.exp(1j * ph) + _noise(n, 1e-3)).astype(np.complex64)
    y = _stream(ja.Fm(fs, 12500.0, low_pass=low_pass),
                ta.Fm(fs, 12500.0, low_pass=low_pass, device="cpu"), x, 2e-5)
    assert abs(_tone_hz(y[1000:], fs) - 1000.0) < 30.0


@pytest.mark.parametrize("agc_mode", ["audio", "carrier"])
def test_am(agc_mode):
    fs, n = 15000.0, 1500
    t = np.arange(n) / fs
    env = 1.0 + 0.5 * np.sin(2 * np.pi * 700.0 * t)
    x = (0.01 * env * np.exp(1j * (2 * np.pi * 50.0 * t + 0.4))
         + _noise(n, 1e-5)).astype(np.complex64)
    y = _stream(ja.Am(fs, 10000.0, agc_mode=agc_mode),
                ta.Am(fs, 10000.0, agc_mode=agc_mode, device="cpu"), x, 5e-5)
    assert abs(_tone_hz(y[400:], fs) - 700.0) < 30.0


@pytest.mark.parametrize("mode,f_rf,f_audio", [("usb", 1000.0, 2400.0),
                                               ("lsb", -1000.0, 2400.0),
                                               ("dsb", 1200.0, 1200.0)])
def test_ssb(mode, f_rf, f_audio):
    """The carrier sits at the filter's edge; `Ssb` shifts by +-bw/2."""
    fs, n = 24000.0, 2400
    t = np.arange(n) / fs
    x = (0.02 * np.exp(2j * np.pi * f_rf * t) + _noise(n, 1e-5)).astype(
        np.complex64)
    y = _stream(ja.Ssb(fs, 2800.0, mode=mode),
                ta.Ssb(fs, 2800.0, mode=mode, device="cpu"), x, 5e-5)
    assert abs(_tone_hz(y[600:], fs) - f_audio) < 30.0


def test_cw():
    fs, n = 3000.0, 600
    t = np.arange(n) / fs
    keyed = (np.sin(2 * np.pi * 6.0 * t) > 0).astype(np.float64)
    x = (0.05 * keyed * np.exp(2j * np.pi * 20.0 * t)
         + _noise(n, 1e-5)).astype(np.complex64)
    y = _stream(ja.Cw(fs), ta.Cw(fs, device="cpu"), x, 5e-5)
    assert abs(_tone_hz(y, fs) - 820.0) < 30.0
