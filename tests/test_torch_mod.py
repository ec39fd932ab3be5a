"""sdrtpu_torch's transmit-side modulators against sdrtpu's:
`QuadratureMod`, `RrcInterpolator`, `PskMod`, `GfskMod`.

Tolerances:
- `QuadratureMod`: the same chunked float32 phase accumulation (a cumsum
  within 64-sample chunks, the chunk offsets a float32 running sum
  wrapped into [0, 2 pi)), so the phase agrees within float32 rounding;
  the output within 2e-5 (a unit phasor) over 100 000 samples, the
  carried phase within 1e-5 rad;
- `RrcInterpolator` / `PskMod`: the port runs the matmul form of the
  polyphase resampler, the reference the shift-and-add form for these
  small banks: 2e-6 of the peak;
- `GfskMod`: both of the above, 3e-5;
- every streamed op over two blocks from one converted state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import mod as jmod  # noqa: E402
from sdrtpu.kernels.psk import Gfsk as JGfsk  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.kernels import mod as tmod  # noqa: E402
from sdrtpu_torch.kernels.psk import Gfsk as TGfsk  # noqa: E402

RNG = np.random.default_rng(99)


def _stream(jop, top, blocks, tol):
    sj = jop.init_state()
    st = state_from_jax(sj, "cpu")
    for x in blocks:
        sj, yj = jop(sj, jnp.asarray(x))
        st, yt = top(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        assert yt.shape == yj.shape
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=tol * max(np.abs(yj).max(), 1.0))
    return st, sj


@pytest.mark.parametrize("n", [100_000, 1000, 64, 37])
def test_quadrature_mod(n):
    jop, top = (jmod.QuadratureMod(5000.0, 48000.0),
                tmod.QuadratureMod(5000.0, 48000.0, device="cpu"))
    blocks = [RNG.standard_normal(n).astype(np.float32) for _ in range(2)]
    st, sj = _stream(jop, top, blocks, 2e-5)
    assert st.dtype == torch.float32 and st.shape == ()
    d = float(st) - float(np.asarray(sj))
    assert abs((d + np.pi) % (2 * np.pi) - np.pi) <= 1e-5


def test_quadrature_mod_rows():
    """Leading axes are independent rows, each with its own phase."""
    x = RNG.standard_normal((3, 640)).astype(np.float32)
    jop, top = (jmod.QuadratureMod(1000.0, 8000.0),
                tmod.QuadratureMod(1000.0, 8000.0, device="cpu"))
    _, yj = jop(jop.init_state(), jnp.asarray(x))
    st, yt = top(top.init_state(), torch.as_tensor(x))
    assert st.shape == (3,)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5)


@pytest.mark.parametrize("sps,ntaps,beta,norm", [(4, 33, 0.35, False),
                                                 (10, 41, 0.5, False),
                                                 (4, 511, 0.6, True)])
def test_rrc_interpolator(sps, ntaps, beta, norm):
    jop = jmod.RrcInterpolator(sps, ntaps, beta, jnp.complex64,
                               normalize_dc=norm)
    top = tmod.RrcInterpolator(sps, ntaps, beta, torch.complex64,
                               normalize_dc=norm, device="cpu")
    np.testing.assert_array_equal(top.poly.bank, jop.poly.bank)
    syms = [(RNG.choice([-1.0, 1.0], 300) + 1j * RNG.choice([-1.0, 1.0], 300)
             ).astype(np.complex64) for _ in range(2)]
    st, sj = _stream(jop, top, syms, 2e-6)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_psk_mod():
    jop, top = jmod.PskMod(4), tmod.PskMod(4, device="cpu")
    syms = [np.exp(2j * np.pi * RNG.integers(0, 4, 256) / 4).astype(
        np.complex64) for _ in range(2)]
    _stream(jop, top, syms, 2e-6)


def test_gfsk_mod_and_loopback():
    fs, baud, dev = 48000.0, 4800.0, 2400.0
    sps = int(fs / baud)
    kw = dict(rrc_tap_count=4 * sps + 1, rrc_beta=0.5)
    jop = jmod.GfskMod(sps, dev, fs, **kw)
    top = tmod.GfskMod(sps, dev, fs, device="cpu", **kw)
    bits = [RNG.choice([-1.0, 1.0], 300).astype(np.float32)
            for _ in range(2)]
    st, _ = _stream(jop, top, bits, 3e-5)
    back = state_to_numpy(st)
    assert set(back) == {"interp", "mod"}
    # the port's GFSK receiver recovers the bits of its own modulator
    _, iq = top(top.init_state(), torch.as_tensor(np.concatenate(bits)))
    dem = TGfsk(baud, fs, dev, omega_gain=1e-4, mu_gain=0.05, device="cpu",
                **kw)
    _, (syms, valid) = dem(dem.init_state(), iq)
    got = np.sign(syms[valid].numpy())
    want = np.concatenate(bits)
    best = max(np.mean(got[k:k + 400] == want[:400]) for k in range(8))
    assert best == 1.0
    # and so does the reference's, from the port's signal
    jd = JGfsk(baud, fs, dev, omega_gain=1e-4, mu_gain=0.05, **kw)
    _, (js, jv) = jd(jd.init_state(), jnp.asarray(iq.numpy()))
    np.testing.assert_allclose(syms[valid].numpy(),
                               np.asarray(js)[np.asarray(jv)], atol=1e-4)
