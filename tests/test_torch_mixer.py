"""sdrtpu_torch's frequency translators against sdrtpu's (both on the CPU).

Tolerance: 2e-6 absolute on unit-amplitude input — both sides add the
same float32 tables and wrap; only cos/sin of the same float32 angle
differ (last-place).  The carried phase must agree to 1e-6 rad.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels.mixer import FreqXlator as JXl  # noqa: E402
from sdrtpu.kernels.mixer import TunableXlator as JTun  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.kernels.mixer import FreqXlator as TXl  # noqa: E402
from sdrtpu_torch.kernels.mixer import TunableXlator as TTun  # noqa: E402

RNG = np.random.default_rng(21)
ATOL = 2e-6


def _iq(*shape):
    x = RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
    return (x / np.abs(x)).astype(np.complex64)


@pytest.mark.parametrize("offset,fs,n", [(-57000.0, 250000.0, 5000),
                                         (1.234567e6, 10e6, 3000),
                                         (-160.55, 50000.0, 700)])
def test_freq_xlator_streams(offset, fs, n):
    jx, tx = JXl(offset, fs), TXl(offset, fs, device="cpu")
    sj = jx.init_state()
    st = state_from_jax(sj, "cpu")
    assert st.shape == () and st.dtype == torch.float32
    for _ in range(3):
        x = _iq(n)
        sj, yj = jx(sj, jnp.asarray(x))
        st, yt = tx(st, torch.as_tensor(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
        # carry the state through the converter as a mid-stream hand-over
        st = state_from_jax(state_to_numpy(st), "cpu")


def test_freq_xlator_batched_rows_and_negative_wrap():
    """(C, n) rows share the ramp; a negative offset exercises the floored
    modulo (torch.remainder, not fmod)."""
    jx, tx = JXl(-333.3, 8000.0), TXl(-333.3, 8000.0, device="cpu")
    x = _iq(3, 2048)
    sj, yj = jx(jx.init_state(), jnp.asarray(x))
    st, yt = tx(tx.init_state(), torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
    assert 0.0 <= float(st) < 2 * np.pi
    np.testing.assert_allclose(float(st), float(sj), atol=1e-6)


def test_tunable_xlator_streams_and_retunes():
    fs, n = 2e6, 4000
    jt, tt = JTun(-3.1e5, fs, n), TTun(-3.1e5, fs, n, device="cpu")
    sj = jt.init_state()
    st = state_from_jax(sj, "cpu")
    assert set(st) == {"fine", "coarse", "delta", "phase"}
    for step in range(4):
        if step == 2:  # table swap; the phase runs on
            sj = jt.retune_state(sj, 4.4e5)
            before = st["phase"].clone()
            st = tt.retune_state(st, 4.4e5)
            assert torch.equal(st["phase"], before)
            for k in ("fine", "coarse", "delta"):
                np.testing.assert_array_equal(st[k].numpy(),
                                              np.asarray(sj[k]))
        x = _iq(n)
        sj, yj = jt(sj, jnp.asarray(x))
        st, yt = tt(st, torch.as_tensor(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
        np.testing.assert_allclose(st["phase"].numpy(),
                                   np.asarray(sj["phase"]), atol=1e-6)
    assert tt.offset_hz == 4.4e5
    with pytest.raises(AssertionError):
        tt(st, torch.as_tensor(_iq(n + 1)))
