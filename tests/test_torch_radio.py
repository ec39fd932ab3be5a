"""sdrtpu_torch's RadioChain against sdrtpu's, every mode and option (both
on the CPU).

Tolerance: 2e-4 of the block's peak (at least of 1.0) for every mode —
the flagship's audio tolerance.  Chains with an AGC (am, usb, lsb, dsb,
cw) normalise to ~1, the FM chains to the deviation ratio; the polyphase
audio resampler sums its window in another order than the reference's
unrolled form for small banks.  Each case streams two blocks with the
state handed over through ``convert``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.apps.radio import MODE_INFO as JMODES  # noqa: E402
from sdrtpu.apps.radio import RadioChain as JRadio  # noqa: E402
from sdrtpu_torch.apps.radio import MODE_INFO, RadioChain  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402

RNG = np.random.default_rng(26)
REL = 2e-4


def _signal(mode, fs, n):
    """A tone-modulated signal of the mode at baseband, light noise."""
    t = np.arange(n) / fs
    noise = 1e-4 * (RNG.standard_normal(n) + 1j * RNG.standard_normal(n))
    if mode == "wfm":
        left = np.sin(2 * np.pi * 400 * t)
        right = np.sin(2 * np.pi * 900 * t)
        mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
        x = 0.3 * np.exp(1j * np.cumsum(2 * np.pi * 75000.0 * mpx / fs))
    elif mode == "nfm":
        sub = 0.15 * np.sin(2 * np.pi * 100.0 * t)  # CTCSS tone, index 12
        msg = np.sin(2 * np.pi * 1000.0 * t) + sub
        x = 0.3 * np.exp(1j * np.cumsum(2 * np.pi * 2500.0 * msg / fs))
    elif mode == "am":
        x = 0.05 * (1 + 0.5 * np.sin(2 * np.pi * 600.0 * t)) * np.exp(0.3j)
    elif mode in ("usb", "dsb"):
        x = 0.05 * np.exp(2j * np.pi * 700.0 * t)
    elif mode == "lsb":
        x = 0.05 * np.exp(-2j * np.pi * 700.0 * t)
    elif mode == "cw":
        x = 0.05 * np.exp(2j * np.pi * 15.0 * t)
    else:  # raw
        x = 0.2 * np.exp(2j * np.pi * 1500.0 * t)
    return (x + noise).astype(np.complex64)


def _stream(mode, n, blocks=2, hold_from=0, **kw):
    jr = JRadio(mode, **kw)
    tr = RadioChain(mode, device="cpu", **kw)
    assert tr.if_rate == jr.if_rate and tr.bandwidth == jr.bandwidth
    assert tr.block_multiple() == jr.block_multiple()
    assert n % tr.block_multiple() == 0
    sj = jr.init_state()
    st = state_from_jax(sj, "cpu")
    assert set(st) == set(sj)
    x = _signal(mode, tr.if_rate, blocks * n)
    for b in range(blocks):
        blk = x[b * n:(b + 1) * n]
        sj, aj = jr(sj, jnp.asarray(blk))
        st, at = tr(st, torch.as_tensor(blk))
        aj = np.asarray(aj)
        assert at.shape == aj.shape == (2, tr.out_len(n))
        assert at.dtype == torch.float32
        if b >= hold_from:
            np.testing.assert_allclose(
                at.numpy(), aj, atol=REL * max(np.abs(aj).max(), 1.0))
        st = state_from_jax(state_to_numpy(st), "cpu")
    return tr, st, at.numpy()


def test_mode_table_matches():
    assert MODE_INFO == JMODES
    with pytest.raises(ValueError, match="unknown mode"):
        RadioChain("fsk", device="cpu")


@pytest.mark.parametrize("mode,n", [("wfm", 5000), ("nfm", 5000),
                                    ("am", 1500), ("usb", 2400),
                                    ("lsb", 2400), ("dsb", 2400),
                                    ("cw", 300), ("raw", 2000)])
def test_every_mode_defaults(mode, n):
    _, _, audio = _stream(mode, n)
    assert np.abs(audio).max() > 1e-3
    if mode not in ("wfm", "raw"):
        np.testing.assert_array_equal(audio[0], audio[1])  # mono, twice


@pytest.mark.parametrize("mode,n,kw", [
    ("wfm", 5000, dict(stereo=False, rds=True)),
    ("wfm", 5000, dict(pilot_mode="envelope", deemphasis=75e-6)),
    # the regression fit of the first block unwraps the pilot filter's
    # start-up noise (ill-conditioned, see test_torch_wfm_modes.py) and
    # the audio filters carry that into the second: held from the third
    ("wfm", 5000, dict(pilot_mode="regression", bandwidth=180000.0,
                       blocks=4, hold_from=2)),
    ("wfm", 2500, dict(pilot_mode="pll", deemphasis=None)),
    ("nfm", 5000, dict(squelch_db=-30.0, noise_blanker=True, high_pass=True)),
    ("nfm", 2500, dict(fm_if_nr=True)),
    ("nfm", 5000, dict(deemphasis=5e-3, audio_rate=16000.0)),
    ("am", 1500, dict(squelch_db=-3.0)),  # closed: silence out
    ("usb", 2400, dict(noise_blanker=True, bandwidth=2400.0)),
    ("raw", 2205, dict(audio_rate=44100.0)),
])
def test_options(mode, n, kw):
    tr, _, audio = _stream(mode, n, **kw)
    if kw.get("squelch_db") == -3.0:
        assert not np.any(audio)
    if mode == "raw":
        assert tr.if_rate == 44100.0 and tr.resamp.resamp is None


def test_ctcss_gate_and_host_side_tone_read():
    """NFM with a 100.0 Hz sub-audible tone: the chain decodes it, and a
    chain that requires another tone stays shut."""
    want = 12
    tr, st, audio = _stream("nfm", 5000, ctcss_tone=want)
    jr = JRadio("nfm", ctcss_tone=want)
    assert tr.block_multiple() == jr.block_multiple() == 100
    x = _signal("nfm", 50000.0, 14 * 5000)
    st = tr.init_state()
    assert RadioChain.ctcss_tone_detected(st) == -1
    tones = []
    for b in range(14):
        st, audio = tr(st, torch.as_tensor(x[b * 5000:(b + 1) * 5000]))
        tones.append(RadioChain.ctcss_tone_detected(st))
    assert tones[-1] == want and np.abs(audio.numpy()).max() > 1e-3
    assert RadioChain.ctcss_tone_detected(
        RadioChain("am", device="cpu").init_state()) is None
    other = RadioChain("nfm", ctcss_tone=20, device="cpu")
    so = other.init_state()
    for b in range(14):
        so, shut = other(so, torch.as_tensor(x[b * 5000:(b + 1) * 5000]))
    assert not np.any(shut.numpy())
