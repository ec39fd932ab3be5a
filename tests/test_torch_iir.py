"""sdrtpu_torch's first-order recurrences against sdrtpu's (CPU).

Tolerances:
- `first_order_recurrence`: 5e-6 of the peak — both are log-depth
  float32 scans, with the partial products composed in another order;
- long-block drift: the 200 000-sample DC-blocker recurrence stays
  within 2e-5 of the peak of a float64 sample-by-sample loop;
- `Deemphasis` with a long pole and `DcBlocker`: 5e-6 of the peak.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels.iir import DcBlocker as JDc  # noqa: E402
from sdrtpu.kernels.iir import Deemphasis as JDeemph  # noqa: E402
from sdrtpu.kernels.iir import first_order_recurrence as jrec  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.kernels.iir import DcBlocker as TDc  # noqa: E402
from sdrtpu_torch.kernels.iir import Deemphasis as TDeemph  # noqa: E402
from sdrtpu_torch.kernels.iir import first_order_recurrence as trec  # noqa: E402
from sdrtpu_torch.kernels.fir import correlate_valid, matmul_correlate_valid  # noqa: E402

RNG = np.random.default_rng(22)


def _loop64(a, b, y0):
    a = np.broadcast_to(np.asarray(a, np.float64), b.shape)
    y = np.empty(b.shape, np.result_type(b.dtype, np.float64))
    acc = y0
    for i in range(b.shape[-1]):
        acc = a[..., i] * acc + b[..., i]
        y[..., i] = acc
    return y


@pytest.mark.parametrize("n", [1, 2, 37, 1000])
def test_recurrence_scalar_a(n):
    a = np.float32(0.97)
    b = RNG.standard_normal((3, n)).astype(np.float32)
    y0 = np.float32(0.4)
    want = np.asarray(jrec(a, jnp.asarray(b), y0))
    got = trec(float(a), torch.as_tensor(b), torch.tensor(y0)).numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=5e-6 * scale)
    np.testing.assert_allclose(got, _loop64(a, b, y0), atol=5e-6 * scale)


def test_recurrence_array_a_with_holds_and_complex_b():
    """Per-sample coefficients (the noise blanker holds the average with
    a = 1, b = 0 on silent samples); b complex with a real."""
    n = 777
    live = RNG.random(n) > 0.3
    a = np.where(live, np.float32(1 - 500 / 24000), np.float32(1.0))
    b = np.where(live, RNG.random(n), 0.0).astype(np.float32)
    want = np.asarray(jrec(jnp.asarray(a), jnp.asarray(b), np.float32(1.0)))
    got = trec(torch.as_tensor(a), torch.as_tensor(b),
               torch.tensor(1.0)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-6 * scale)
    np.testing.assert_allclose(got, _loop64(a, b, 1.0), atol=5e-6 * scale)
    bc = (b * np.exp(1j * RNG.random(n))).astype(np.complex64)
    gotc = trec(torch.as_tensor(a), torch.as_tensor(bc),
                torch.tensor(0.5 + 0.5j, dtype=torch.complex64)).numpy()
    np.testing.assert_allclose(gotc, _loop64(a, bc, 0.5 + 0.5j),
                               atol=5e-6 * scale)


def test_recurrence_long_block_does_not_drift():
    """The receiver's DC blocker runs on the full-rate block with a
    memory of ~1e6 samples: float32 must hold over a long block."""
    n = 200_000
    rate = np.float32(50.0 / 10e6)
    a = np.float32(1.0) - rate
    x = (0.3 + RNG.standard_normal(n)).astype(np.float32)
    got = trec(float(a), torch.as_tensor(rate * x), torch.tensor(0.1)).numpy()
    want = _loop64(a, (rate * x).astype(np.float32), 0.1)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    # the noise blanker's pole over a long block: a^-k would overflow
    a2 = np.float32(1 - 500 / 24000)
    got2 = trec(torch.full((n,), float(a2)), torch.as_tensor(np.abs(x)),
                torch.tensor(1.0)).numpy()
    assert np.isfinite(got2).all()
    np.testing.assert_allclose(got2, _loop64(a2, np.abs(x), 1.0), rtol=2e-5)


@pytest.mark.parametrize("lengths", [(900, 900, 900), (900, 1500, 900)],
                         ids=["one-length", "two-lengths-in-turn"])
def test_recurrence_scalar_powers_are_kept_and_bit_equal(lengths):
    """A scalar pole's powers ``a^(k+1)`` are built once per length and
    kept on the device; the result is the bits of the powers built on
    the host at every call (``A * y0`` plus the doubling scan)."""
    from sdrtpu_torch.kernels.iir import _powers

    a = float(np.float32(1.0) - np.float32(100.0 / 15000.0))
    for n in lengths:
        b = torch.as_tensor(RNG.standard_normal((2, n)).astype(np.float32))
        y0 = torch.as_tensor(RNG.standard_normal((2, 1)).astype(np.float32))
        A = torch.as_tensor((a ** (np.arange(n, dtype=np.float64) + 1.0)
                             ).astype(np.float32))
        want = A * y0 + trec(a, b, torch.zeros(()))
        assert torch.equal(trec(a, b, y0), want)
    for n in set(lengths):
        assert _powers(a, n, b.device) is _powers(a, n, b.device)


def _deemph_per_call_carry(d, state, x):
    """`Deemphasis.__call__`'s FIR branch with the carry term built on
    the host at every call, as before it was kept on the device."""
    T, n = d._ntaps, x.shape[-1]
    xpad = torch.cat([x.new_zeros(x.shape[:-1] + (T - 1,)), x], dim=-1)
    if x.numel() >= d.mm_min_elements:
        y = matmul_correlate_valid(xpad, d._fir, H=d._H)
    else:
        y = correlate_valid(xpad, d._fir)
    decay = np.zeros(n, np.float32)
    m = min(T, n)
    decay[:m] = (d._a ** (np.arange(m, dtype=np.float64) + 1.0)
                 ).astype(np.float32)
    y = y + torch.as_tensor(decay, device=x.device) * state
    return y[..., -1:], y


@pytest.mark.parametrize("lengths", [(17, 17, 17), (60, 60), (2400, 2400),
                                     (2400, 17, 2400, 60)],
                         ids=["below-taps", "at-taps", "above-taps",
                              "two-lengths-in-turn"])
def test_deemphasis_cached_carry_is_bit_equal(lengths):
    """50 us at 48 kHz: the 60-tap FIR form; (2, 8, n) rows as the
    flagship's, so 2400 takes the matmul and the shorter blocks the
    shift-and-add."""
    td = TDeemph(50e-6, 48000.0, device="cpu")
    assert td._ntaps == 60
    st_new = st_old = td.init_state()
    for n in lengths:
        x = torch.as_tensor(RNG.standard_normal((2, 8, n)).astype(np.float32))
        st_new, y_new = td(st_new, x)
        st_old, y_old = _deemph_per_call_carry(td, st_old, x)
        assert torch.equal(y_new, y_old) and torch.equal(st_new, st_old)
    assert sorted(n for n, _ in td._decays) == sorted(set(lengths))


def test_deemphasis_long_pole_streams():
    """tau = 5 ms at 48 kHz: 4950+ taps to 1e-9, past the FIR form."""
    jd = JDeemph(5e-3, 48000.0)
    td = TDeemph(5e-3, 48000.0, device="cpu")
    assert jd._fir is None and td._fir is None
    sj = jd.init_state()
    st = state_from_jax(sj, "cpu")
    for _ in range(3):
        x = RNG.standard_normal((2, 1500)).astype(np.float32)
        sj, yj = jd(sj, jnp.asarray(x))
        st, yt = td(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=5e-6 * np.abs(yj).max())
        assert st.shape == (2, 1)
        st = state_from_jax(state_to_numpy(st), "cpu")


@pytest.mark.parametrize("cplx", [True, False])
def test_dc_blocker_streams(cplx):
    rate = 100.0 / 15000.0
    jd = JDc(rate, dtype=jnp.complex64 if cplx else jnp.float32)
    td = TDc(rate, dtype=torch.complex64 if cplx else torch.float32,
             device="cpu")
    sj = jd.init_state()
    st = state_from_jax(sj, "cpu")
    assert st.shape == () and st.is_complex() == cplx
    for _ in range(3):
        x = (0.7 + RNG.standard_normal(900)).astype(np.float32)
        if cplx:
            x = (x + 1j * (RNG.standard_normal(900) - 0.2)).astype(
                np.complex64)
        sj, yj = jd(sj, jnp.asarray(x))
        st, yt = td(st, torch.as_tensor(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=5e-6 * 4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=5e-6)
        st = state_from_jax(state_to_numpy(st), "cpu")
    assert abs(np.mean(yt.numpy())) < abs(np.mean(x))  # DC is going down


def test_dc_blocker_batched_rows():
    jd, td = JDc(0.01, dtype=jnp.float32), TDc(0.01, torch.float32,
                                                device="cpu")
    x = (1.0 + RNG.standard_normal((3, 400))).astype(np.float32)
    sj, yj = jd(jd.init_state(), jnp.asarray(x))
    st, yt = td(td.init_state(), torch.as_tensor(x))
    assert st.shape == (3, 1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=5e-6)
