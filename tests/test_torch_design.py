"""Host-side design math of sdrtpu_torch against sdrtpu.

The port keeps its own copies of the float64 numpy design code (taps,
windows, polyphase banks, the resampler planner), because importing any
``sdrtpu.kernels`` module imports JAX.  The tables must be identical:
the channelizer's filter and the audio resampler's bank come from them.
Tolerance: exact (byte-equal arrays, equal plans).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import resample as jresample  # noqa: E402
from sdrtpu.kernels import taps as jtaps  # noqa: E402
from sdrtpu.kernels import windows as jwindows  # noqa: E402
from sdrtpu_torch.kernels import resample as tresample  # noqa: E402
from sdrtpu_torch.kernels import taps as ttaps  # noqa: E402
from sdrtpu_torch.kernels import windows as twindows  # noqa: E402

RNG = np.random.default_rng(7)


def _byte_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(jwindows.COSINE_COEFS))
def test_windows_byte_equal(name):
    assert twindows.COSINE_COEFS[name] == jwindows.COSINE_COEFS[name]
    _byte_equal(twindows.periodic_window(name, 4097),
                jwindows.periodic_window(name, 4097))


@pytest.mark.parametrize("fn,args,kw", [
    ("low_pass", (15000.0, 4000.0, 250000.0), {}),
    ("low_pass", (100000.0, 50000.0, 10e6), {}),
    ("high_pass", (300.0, 200.0, 48000.0), {}),
    ("band_pass", (18750.0, 19250.0, 3000.0, 250000.0),
     {"odd_tap_count": True}),
    ("inverse_sinc", (11, 250000.0), {}),
    ("root_raised_cosine", (65, 0.35, 4.0), {}),
    ("half_band", (), {}),
])
def test_taps_byte_equal(fn, args, kw):
    _byte_equal(getattr(ttaps, fn)(*args, **kw), getattr(jtaps, fn)(*args, **kw))


def test_polyphase_bank_and_stages_equal():
    proto = jtaps.low_pass(15000.0, 4000.0, 6e6)
    _byte_equal(tresample.build_polyphase_bank(24, proto),
                jresample.build_polyphase_bank(24, proto))
    for (da, ta), (db, tb) in zip(
            tresample.design_decimation_stages(10e6, 40, 100000.0),
            jresample.design_decimation_stages(10e6, 40, 100000.0)):
        assert da == db
        _byte_equal(ta, tb)


def _plan(rs):
    pre = rs.predecim
    return (rs.interp, rs.decim,
            pre.ratio if pre else None,
            [(s.decimation, s.ntaps) for s in pre.stages] if pre else [],
            rs.resamp.taps_per_phase if rs.resamp else None,
            rs.block_multiple())


@pytest.mark.parametrize("fin,fout,kw,dtype", [
    (250000.0, 48000.0, {"bw": 15000.0, "trans_bw": 4000.0}, "float32"),
    (10e6, 250000.0, {}, "complex64"),
])
def test_rational_resampler_plan_and_output(fin, fout, kw, dtype):
    """Same plan and taps; output over two streamed blocks agrees to
    float32 rounding of the summation order (rtol 1e-5 of the peak)."""
    jr = jresample.RationalResampler(fin, fout, dtype=getattr(jnp, dtype), **kw)
    tr = tresample.RationalResampler(fin, fout, dtype=getattr(torch, dtype),
                                     device="cpu", **kw)
    assert _plan(tr) == _plan(jr)
    if jr.resamp is not None:
        assert jr.resamp.method == "matmul"
        _byte_equal(tr.resamp.bank, jr.resamp.bank)
        _byte_equal(tr.resamp._G.numpy(), jr.resamp._G)
    if jr.predecim is not None:
        for a, b in zip(tr.predecim.stages, jr.predecim.stages):
            _byte_equal(a.taps, b.taps)

    n = 4 * tr.block_multiple() if fin > 1e6 else 2 * tr.block_multiple()
    lead = (2, 3) if dtype == "float32" else ()
    shape = lead + (n,)
    xs = RNG.standard_normal((2,) + shape)
    if dtype == "complex64":
        xs = xs + 1j * RNG.standard_normal((2,) + shape)
    xs = xs.astype(dtype)
    sj, st = jr.init_state(), tr.init_state()
    for x in xs:
        sj, yj = jr(sj, jnp.asarray(x))
        st, yt = tr(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        assert yt.shape == yj.shape and str(yt.dtype).endswith(dtype)
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=1e-5 * np.abs(yj).max())
