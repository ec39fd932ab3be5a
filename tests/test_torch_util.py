"""sdrtpu_torch's small utilities against sdrtpu's: `Volume`,
`lr_to_stereo`, `mono_to_stereo`, `stereo_to_mono`, `complex_to_real`,
`real_to_complex`, and `PolyphaseResampler(method=)`.

Tolerances: the utilities are one float32 operation each, so equal.  The
resampler: the port computes every method with its matmul form, so
against the reference's "matmul" the outputs agree within 2e-6 of the
peak, and against "unrolled" and "gather" (shift-and-add and einsum,
other sum orders) within 1e-5 of the peak; the carried tail is the
input's last samples, equal.  Two blocks each.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import demod as jdemod  # noqa: E402
from sdrtpu.kernels import taps as jtaps  # noqa: E402
from sdrtpu.kernels import util as jutil  # noqa: E402
from sdrtpu.kernels.resample import PolyphaseResampler as JPR  # noqa: E402
from sdrtpu_torch.kernels import demod as tdemod  # noqa: E402
from sdrtpu_torch.kernels import util as tutil  # noqa: E402
from sdrtpu_torch.kernels.resample import PolyphaseResampler as TPR  # noqa: E402

RNG = np.random.default_rng(31)


def _f32(n):
    return RNG.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("level,muted", [(1.0, False), (0.37, False),
                                         (2.5, True)])
def test_volume(level, muted):
    x = _f32(1000).reshape(2, 500)
    sj, yj = jutil.Volume(level, muted)((), jnp.asarray(x))
    st, yt = tutil.Volume(level, muted)((), torch.as_tensor(x))
    assert st == sj == ()
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_stereo_helpers():
    l, r = _f32(300), _f32(300)
    np.testing.assert_array_equal(
        tutil.lr_to_stereo(torch.as_tensor(l), torch.as_tensor(r)).numpy(),
        np.asarray(jutil.lr_to_stereo(jnp.asarray(l), jnp.asarray(r))))
    np.testing.assert_array_equal(
        tutil.mono_to_stereo(torch.as_tensor(l)).numpy(),
        np.asarray(jutil.mono_to_stereo(jnp.asarray(l))))
    st = np.stack([l, r])
    np.testing.assert_array_equal(
        tutil.stereo_to_mono(torch.as_tensor(st)).numpy(),
        np.asarray(jutil.stereo_to_mono(jnp.asarray(st))))


def test_complex_real_conversions():
    z = (_f32(64) + 1j * _f32(64)).astype(np.complex64)
    a = tdemod.complex_to_real(torch.as_tensor(z))
    np.testing.assert_array_equal(a.numpy(),
                                  np.asarray(jdemod.complex_to_real(z)))
    r = _f32(64)
    b = tdemod.real_to_complex(torch.as_tensor(r))
    assert b.dtype == torch.complex64
    np.testing.assert_array_equal(b.numpy(),
                                  np.asarray(jdemod.real_to_complex(r)))


@pytest.mark.parametrize("method,interp,decim,ntaps", [
    ("auto", 4, 1, 33),        # the reference resolves it to "unrolled"
    ("auto", 24, 125, 1201),   # ... and this to "matmul"
    ("matmul", 3, 2, 61),
    ("unrolled", 5, 3, 41),
    ("gather", 2, 3, 25),
])
def test_polyphase_methods(method, interp, decim, ntaps):
    taps = jtaps.windowed_sinc(
        ntaps, jtaps.hz_to_rads(0.45 / max(interp, decim), 1.0))
    jr = JPR(interp, decim, taps, method=method)
    tr = TPR(interp, decim, taps, method=method, device="cpu")
    tol = 2e-6 if jr.method == "matmul" else 1e-5
    sj, st = jr.init_state(), torch.as_tensor(jr.init_state())
    for _ in range(2):
        n = decim * 200
        x = (_f32(n) + 1j * _f32(n)).astype(np.complex64)
        sj, yj = jr(sj, jnp.asarray(x))
        st, yt = tr(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj, atol=tol * np.abs(yj).max())
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        TPR(2, 1, np.ones(9), method="fast", device="cpu")
