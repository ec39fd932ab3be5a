"""sdrtpu_torch's WFM demodulator in every pilot mode, and its RDS tap,
against sdrtpu's (both on the CPU; the port's PLL runs its plain loop).

Tolerances:
- stereo audio: 2e-4 absolute.  In "regression" mode the first block is
  only required to be finite: while the pilot filter fills from its zero
  state its output starts as rounding noise, whose arbitrary phase the
  fit unwraps, so the two packages' fits of that one block differ at
  1e-3..1e-1, and the audio lowpass carries that into the start of the
  next; from the third block on the mode is held at 2e-4 like the others;
- RDS tap (5 kHz complex): 2e-5 — a rotation and a cascade of short FIRs;
- carried state: 1e-5.
Each test streams two blocks with the state handed over through
``convert``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels.wfm import BroadcastFm as JWfm  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402
from sdrtpu_torch.kernels.wfm import BroadcastFm as TWfm  # noqa: E402

FS = 250000.0


def _fm_if(n, rds=True):
    """One stereo FM station at baseband with a 57 kHz subcarrier."""
    t = np.arange(n) / FS
    left = np.sin(2 * np.pi * 400 * t)
    right = np.sin(2 * np.pi * 900 * t)
    mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
           + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
    if rds:
        mpx = mpx + 0.05 * np.sin(2 * np.pi * 57000 * t) * np.sign(
            np.sin(2 * np.pi * 1187.5 * t))
    ph = np.cumsum(2 * np.pi * 75000.0 * mpx / FS)
    return (0.3 * np.exp(1j * ph)).astype(np.complex64)


def _stream(jw, tw, x, nblk, atol, rds_atol=2e-5, hold_from=0):
    sj = jw.init_state()
    st = state_from_jax(sj, "cpu")
    assert set(st) == set(sj)
    n = len(x) // nblk
    outs = []
    for b in range(nblk):
        blk = x[b * n:(b + 1) * n]
        sj, (aj, rj) = jw(sj, jnp.asarray(blk))
        st, (at, rt) = tw(st, torch.as_tensor(blk))
        assert at.shape == (2, n)
        assert np.isfinite(at.numpy()).all()
        if b >= hold_from:
            np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=atol)
        if rj is None:
            assert rt is None
        else:
            assert rt.shape == (tw.rds_len(n),) == (jw.rds_len(n),)
            np.testing.assert_allclose(rt.numpy(), np.asarray(rj),
                                       atol=rds_atol)
        st = state_from_jax(state_to_numpy(st), "cpu")
        outs.append(at.numpy())
    flat_t = []
    tree_map(lambda a: flat_t.append(a.numpy()), st)
    flat_j = []
    tree_map(lambda a: flat_j.append(np.asarray(a)), sj)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, atol=1e-5)
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("mode", ["normalized", "regression"])
@pytest.mark.parametrize("low_pass", [False, True])
def test_block_parallel_pilot_modes(mode, low_pass):
    kw = dict(samplerate=FS, stereo=True, low_pass=low_pass, pilot_mode=mode,
              mpx_eq=True)
    tw = TWfm(device="cpu", **kw)
    assert tw.pilot_fir.method == JWfm(**kw).pilot_fir.method == "fft"
    audio = _stream(JWfm(**kw), tw, _fm_if(20000, rds=False), 4, 2e-4,
                    hold_from=2 if mode == "regression" else 0)
    if low_pass:  # the decoder separates the channels: L = 400 Hz only
        seg = audio[:, 6000:]
        t = np.arange(seg.shape[-1]) / FS
        amp = lambda a, f: abs(np.mean(a * np.exp(-2j * np.pi * f * t)))
        assert amp(seg[0], 400.0) > 10 * amp(seg[0], 900.0)
        assert amp(seg[1], 900.0) > 10 * amp(seg[1], 400.0)


def test_pll_pilot_mode_streams():
    kw = dict(samplerate=FS, stereo=True, low_pass=False, pilot_mode="pll")
    _stream(JWfm(**kw), TWfm(device="cpu", **kw), _fm_if(4000, rds=False), 2,
            atol=2e-4)


@pytest.mark.parametrize("stereo", [True, False])
def test_rds_tap(stereo):
    kw = dict(samplerate=FS, stereo=stereo, low_pass=True, rds_out=True,
              pilot_mode="normalized")
    jw, tw = JWfm(**kw), TWfm(device="cpu", **kw)
    assert tw.rds_len(5000) == 100
    _stream(jw, tw, _fm_if(10000), 2, atol=2e-4)


def test_rds_tap_with_envelope_pilot_and_pll_state_leaves():
    """The tap is independent of the pilot mode; the PLL's (phase, freq)
    and the translator's phase are state leaves that convert."""
    kw = dict(samplerate=FS, stereo=True, low_pass=False, rds_out=True,
              pilot_mode="envelope")
    _stream(JWfm(**kw), TWfm(device="cpu", **kw), _fm_if(10000), 2, atol=2e-4)
    tw = TWfm(samplerate=FS, pilot_mode="pll", rds_out=True, device="cpu")
    st = tw.init_state()
    assert len(st["pll"]) == 2 and st["rds_xl"].shape == ()
    assert np.isclose(float(st["pll"][1]), 2 * np.pi * 19000.0 / FS)
