"""sdrtpu_torch's squelches and noise reduction against sdrtpu's (CPU).

Tolerances:
- PowerSquelch: exact (a gate);
- NoiseBlanker: 1e-5 of the peak (a log-depth float32 recurrence, then a
  quotient);
- FmIfNoiseReduction: 2e-6 where both packages pick the same bin; the
  argmax over 32 bin magnitudes may differ where two bins tie to
  rounding, so up to 0.5 % of the samples may differ in choice;
- CtcssSquelch: detector leaves exact for the booleans and the tone,
  1e-3 Hz on the mean, 1e-3 relative on the variance; gated audio exact
  (a gate on whole blocks).
Each streams at least two blocks with the state handed over through
``convert``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import ctcss as jc  # noqa: E402
from sdrtpu.kernels.fmnr import FmIfNoiseReduction as JNr  # noqa: E402
from sdrtpu.kernels.squelch import NoiseBlanker as JNb  # noqa: E402
from sdrtpu.kernels.squelch import PowerSquelch as JSq  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.kernels import ctcss as tc  # noqa: E402
from sdrtpu_torch.kernels.fmnr import FmIfNoiseReduction as TNr  # noqa: E402
from sdrtpu_torch.kernels.squelch import NoiseBlanker as TNb  # noqa: E402
from sdrtpu_torch.kernels.squelch import PowerSquelch as TSq  # noqa: E402

RNG = np.random.default_rng(25)


def _noise(shape, s=1.0):
    return (s * (RNG.standard_normal(shape)
                 + 1j * RNG.standard_normal(shape))).astype(np.complex64)


def test_power_squelch_opens_and_closes():
    js, ts = JSq(-20.0), TSq(-20.0, device="cpu")
    for amp, open_ in ((1.0, True), (1e-4, False), (0.02, True)):
        x = _noise((2, 300), amp)
        _, yj = js((), jnp.asarray(x))
        _, yt = ts((), torch.as_tensor(x))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert bool(np.any(yt.numpy() != 0)) == open_
    # rows gate independently
    x = np.stack([_noise(300, 1.0), _noise(300, 1e-4)])
    _, yt = ts((), torch.as_tensor(x))
    assert np.any(yt.numpy()[0] != 0) and not np.any(yt.numpy()[1] != 0)


def test_noise_blanker_with_zero_stretch():
    """A silent stretch (closed squelch upstream) holds the average; the
    impulses are attenuated to ``level`` times it."""
    jn, tn = JNb(), TNb(device="cpu")
    sj = jn.init_state()
    st = state_from_jax(sj, "cpu")
    x = _noise(3000, 0.1)
    x[700:1400] = 0.0
    x[[100, 1500, 2500]] = 30.0 + 0.0j
    for blk in (x[:1000], x[1000:2000], x[2000:]):
        sj, yj = jn(sj, jnp.asarray(blk))
        st, yt = tn(st, torch.as_tensor(blk))
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=1e-5 * np.abs(yj).max())
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
        st = state_from_jax(state_to_numpy(st), "cpu")
    assert abs(yt.numpy()[500]) < 3.0  # the 30.0 impulse at 2500
    # right after the silence the signal passes unattenuated
    y_mid = tn(tn.init_state(), torch.as_tensor(x[:2000]))[1].numpy()
    np.testing.assert_allclose(np.abs(y_mid[1400:1450]),
                               np.abs(x[1400:1450]), rtol=1e-6)


def test_fm_if_noise_reduction_streams():
    jn, tn = JNr(32), TNr(32, device="cpu")
    np.testing.assert_array_equal(tn.taps, jn.taps)
    sj = jn.init_state()
    st = state_from_jax(sj, "cpu")
    n = 1200
    t = np.arange(2 * n)
    x = (np.exp(1j * (0.6 * t + 2.0 * np.sin(0.01 * t)))
         + _noise(2 * n, 0.2)).astype(np.complex64)
    for blk in (x[:n], x[n:]):
        sj, yj = jn(sj, jnp.asarray(blk))
        st, yt = tn(st, torch.as_tensor(blk))
        err = np.abs(yt.numpy() - np.asarray(yj))
        assert np.mean(err > 2e-6) <= 0.005, np.mean(err > 2e-6)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        st = state_from_jax(state_to_numpy(st), "cpu")
    # leading axes are independent channels
    xb = np.stack([x[:n], x[n:]])
    _, yb = tn(tn.init_state(), torch.as_tensor(xb))
    _, y0 = tn(tn.init_state(), torch.as_tensor(xb[1]))
    np.testing.assert_array_equal(yb.numpy()[1], y0.numpy())


def _ctcss_audio(fs, n, tone_hz, t0):
    """Stereo (2, n) audio: speech-band noise plus a sub-audible tone."""
    t = (t0 + np.arange(n)) / fs
    voice = 0.1 * RNG.standard_normal(n)
    sub = 0.15 * np.sin(2 * np.pi * tone_hz * t) if tone_hz else 0.0
    a = (voice + sub).astype(np.float32)
    return np.stack([a, a])


def test_ctcss_tone_opens_and_closes():
    """100.0 Hz (index 12) required: the gate opens once the detector has
    settled on it and closes again after the tone stops."""
    fs, n = 50000.0, 5000  # 100 ms blocks, 50 detector steps each
    want = int(np.argmin(np.abs(tc.CTCSS_TONES - 100.0)))
    jq = jc.CtcssSquelch(fs, required_tone=want)
    tq = tc.CtcssSquelch(fs, required_tone=want, device="cpu")
    assert tq.block_multiple() == jq.block_multiple()
    sj = jq.init_state()
    st = state_from_jax(sj, "cpu")
    assert st["var_ok"].dtype == torch.bool and st["tone"].dtype == torch.int32
    history = []
    for b in range(14):
        audio = _ctcss_audio(fs, n, 100.0 if b < 8 else 0.0, b * n)
        sj, (aj, tj) = jq(sj, jnp.asarray(audio))
        st, (at, tt) = tq(st, torch.as_tensor(audio))
        assert int(tt) == int(tj)
        for k in ("var_ok", "mute", "tone"):
            assert st[k].numpy() == np.asarray(sj[k]), (b, k)
        np.testing.assert_allclose(st["mean"].numpy(), np.asarray(sj["mean"]),
                                   atol=1e-3)
        np.testing.assert_allclose(st["var"].numpy(), np.asarray(sj["var"]),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        history.append((int(tt), bool(st["mute"])))
        st = state_from_jax(state_to_numpy(st), "cpu")
    assert history[0] == (tc.TONE_NONE, True)          # starts muted
    assert (want, False) in history[:8]                # opened on the tone
    assert history[-1] == (tc.TONE_NONE, True)         # closed after it


def test_ctcss_decode_only_passes_audio():
    fs, n = 50000.0, 5000
    tq = tc.CtcssSquelch(fs, device="cpu")  # TONE_NONE: decode only
    st = tq.init_state()
    for b in range(6):
        audio = _ctcss_audio(fs, n, 123.0, b * n)
        st, (out, tone) = tq(st, torch.as_tensor(audio))
        np.testing.assert_array_equal(out.numpy(), audio)
    assert tc.CTCSS_TONES[int(tone)] == 123.0
