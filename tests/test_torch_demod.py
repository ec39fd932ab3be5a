"""IF-rate back end of sdrtpu_torch against sdrtpu (both on the CPU):
the FM discriminator, the delay line, de-emphasis, the envelope-pilot
stereo decoder and the waterfall.

Tolerances:
- discriminator and delay: 2e-6 absolute (float32 atan2 of the same
  products; exact for the delay);
- de-emphasis: 2e-6 of the peak on both branches (the 60-tap matmul
  and the shift-and-add sum in another order);
- stereo audio: 1e-4 absolute — the pilot normalisation divides by a
  segment mean of r^2, which amplifies the float32 rounding of the
  317-tap pilot filter;
- waterfall: 0.02 dB on every bin within 80 dB of the frame peak (bins
  far below the peak are float32 rounding noise of the FFT).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.graph.block import Chain as JChain  # noqa: E402
from sdrtpu.kernels.demod import Quadrature as JQuad  # noqa: E402
from sdrtpu.kernels.fftspec import SpectrumAnalyzer as JSpec  # noqa: E402
from sdrtpu.kernels.iir import Deemphasis as JDeemph  # noqa: E402
from sdrtpu.kernels.util import Delay as JDelay  # noqa: E402
from sdrtpu.kernels.wfm import BroadcastFm as JWfm  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.graph.block import Chain as TChain  # noqa: E402
from sdrtpu_torch.kernels.demod import Quadrature as TQuad  # noqa: E402
from sdrtpu_torch.kernels.fftspec import SpectrumAnalyzer as TSpec  # noqa: E402
from sdrtpu_torch.kernels.iir import Deemphasis as TDeemph  # noqa: E402
from sdrtpu_torch.kernels.util import Delay as TDelay  # noqa: E402
from sdrtpu_torch.kernels.wfm import BroadcastFm as TWfm  # noqa: E402

RNG = np.random.default_rng(9)
FS = 250000.0


def _fm_if(C, n, seed_phase=0.0):
    """C stereo FM stations at baseband, 250 kHz IF, 0.3 amplitude."""
    t = np.arange(n) / FS
    out = []
    for c in range(C):
        left = np.sin(2 * np.pi * (400 + 100 * c) * t)
        right = np.sin(2 * np.pi * (900 + 100 * c) * t)
        mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
        ph = np.cumsum(2 * np.pi * 75000.0 * mpx / FS) + seed_phase + c
        out.append(0.3 * np.exp(1j * ph))
    return np.stack(out).astype(np.complex64)


@pytest.mark.parametrize("derotate", [False, True])
def test_quadrature_streams(derotate):
    jq = JQuad(75000.0, FS, channel_derotate=derotate)
    tq = TQuad(75000.0, FS, channel_derotate=derotate, device="cpu")
    sj = jq.init_state()
    if derotate:
        sj = {"prev": sj["prev"],
              "rot": np.array([0.3, -1.2, 2.9], np.float32)}
    st = state_from_jax(sj, "cpu")
    x = _fm_if(3, 2000)
    for blk in (x[:, :1000], x[:, 1000:]):
        sj, yj = jq(sj, jnp.asarray(blk))
        st, yt = tq(st, torch.as_tensor(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-6)
    prev_t = st["prev"] if derotate else st
    prev_j = sj["prev"] if derotate else sj
    np.testing.assert_array_equal(prev_t.numpy(), np.asarray(prev_j))


def test_delay_streams():
    jd, td = JDelay(159, jnp.float32), TDelay(159, torch.float32, device="cpu")
    sj, st = jd.init_state(), td.init_state()
    for _ in range(2):
        x = RNG.standard_normal((3, 500)).astype(np.float32)
        sj, yj = jd(sj, jnp.asarray(x))
        st, yt = td(st, torch.as_tensor(x))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape", [(2, 4, 4800),   # >= 2^15: matmul branch
                                   (2, 3, 800)])   # below: shift-and-add
def test_deemphasis_both_branches(shape):
    """Scalar carry broadcasts to (2, C, 1) on the first block; the a^(n+1)
    carry term joins the blocks."""
    jd, td = JDeemph(50e-6, 48000.0), TDeemph(50e-6, 48000.0, device="cpu")
    assert td._ntaps == jd._ntaps == 60
    sj, st = jd.init_state(), td.init_state()
    assert st.shape == ()
    for _ in range(2):
        x = RNG.standard_normal(shape).astype(np.float32)
        sj, yj = jd(sj, jnp.asarray(x))
        st, yt = td(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=2e-6 * np.abs(yj).max())
        assert st.shape == shape[:2] + (1,)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)


def test_chain_and_default_scan_call():
    """Chain(Quadrature, Delay) over 3 stacked blocks: the port's Python
    loop `scan_call` against the reference's lax.scan."""
    jc = JChain([JQuad(75000.0, FS), JDelay(7, jnp.float32)])
    tc = TChain([TQuad(75000.0, FS, device="cpu"),
                 TDelay(7, torch.float32, device="cpu")])
    xs = _fm_if(3, 900).reshape(3, 3, 300).transpose(1, 0, 2)  # (K, C, n)
    warm = _fm_if(3, 300, seed_phase=0.5)
    sj, _ = jc(jc.init_state(), jnp.asarray(warm))
    st, _ = tc(tc.init_state(), torch.as_tensor(warm))
    sj, yj = jc.scan_call(sj, jnp.asarray(xs))
    st, yt = tc.scan_call(st, torch.as_tensor(xs))
    assert yt.shape == (3, 3, 300)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-6)
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), atol=2e-6)


@pytest.mark.parametrize("derotate", [False, True])
def test_broadcast_fm_envelope_streams(derotate):
    kw = dict(deviation=75000.0, samplerate=FS, stereo=True, low_pass=False,
              pilot_mode="envelope", subcarrier_droop_comp=True,
              channel_derotate=derotate)
    jw, tw = JWfm(**kw), TWfm(device="cpu", **kw)
    assert np.float32(tw.subcarrier_comp) == np.float32(jw.subcarrier_comp)
    sj = jw.init_state()
    if derotate:
        sj["quad"] = {"prev": sj["quad"]["prev"],
                      "rot": np.zeros(3, np.float32)}
    st = state_from_jax(sj, "cpu")
    assert set(st) == set(sj)
    x = _fm_if(3, 10000)
    for blk in (x[:, :5000], x[:, 5000:]):
        sj, (aj, _) = jw(sj, jnp.asarray(blk))
        st, (at, rds) = tw(st, torch.as_tensor(blk))
        assert rds is None and at.shape == (2, 3, 5000)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-4)
    for key in ("pilot_fir", "lpr_delay"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                   atol=1e-5)


def test_broadcast_fm_mono_and_unported_modes():
    kw = dict(samplerate=FS, stereo=False, low_pass=True, mpx_eq=True)
    jw, tw = JWfm(**kw), TWfm(device="cpu", **kw)
    x = _fm_if(2, 3000)
    _, (aj, _) = jw(jw.init_state(), jnp.asarray(x))
    _, (at, _) = tw(tw.init_state(), torch.as_tensor(x))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5)
    # the other pilot modes and the RDS tap construct too; their parity
    # is held in tests/test_torch_wfm_modes.py
    for kw in ({"pilot_mode": "pll"}, {"pilot_mode": "envelope",
                                       "rds_out": True}):
        assert set(TWfm(device="cpu", **kw).init_state()) == set(
            JWfm(**kw).init_state())


@pytest.mark.parametrize("fft_size", [4096, 1023])
def test_spectrum_analyzer(fft_size):
    fs = 2e6
    js, ts = JSpec(fs, fft_size, 100.0), TSpec(fs, fft_size, 100.0,
                                               device="cpu")
    np.testing.assert_array_equal(ts.window, js.window)
    n = 3 * ts.interval
    t = np.arange(n) / fs
    x = (np.exp(2j * np.pi * 312e3 * t) + 0.01 * np.exp(-2j * np.pi * 7e5 * t)
         + 1e-3 * (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)))
    x = x.astype(np.complex64)
    _, dj = js((), jnp.asarray(x))
    _, dt = ts((), torch.as_tensor(x))
    dj, dt = np.asarray(dj), dt.numpy()
    assert dt.shape == dj.shape == (3, fft_size) and dt.dtype == np.float32
    live = dj > dj.max(axis=-1, keepdims=True) - 80.0
    np.testing.assert_allclose(dt[live], dj[live], atol=0.02)
    assert np.argmax(dt[0]) == np.argmax(dj[0])
