"""sdrtpu_torch's Costas loops against sdrtpu's (both on the CPU, where
the port's `costas_scan` wrapper runs its plain PyTorch loop).

`Costas` of order 2, 4 and 8 and `MeteorCostas` with the normal and the
broken-modulation error, each streamed over two blocks.  Both packages
start every block from the JAX package's state, carried into the port
by ``convert``.  Tolerance 1e-4 on the mixed-down samples and on the
carried (phase, freq): the loops are contractive, so float32 rounding
differences between XLA and PyTorch do not grow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import loops as jl  # noqa: E402
from sdrtpu.kernels import psk as jp  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.kernels import loops as tl  # noqa: E402
from sdrtpu_torch.kernels import psk as tp  # noqa: E402

RNG = np.random.default_rng(41)
TOL = 1e-4


def _psk(n, order, cfo=0.01, phase=0.3, noise=0.05, phases=None):
    if phases is None:
        sym = np.exp(2j * np.pi * RNG.integers(0, order, n) / order)
    else:
        sym = np.exp(1j * np.asarray(phases)[RNG.integers(0, len(phases), n)])
    x = sym * np.exp(1j * (cfo * np.arange(n) + phase))
    x = x + noise * (RNG.standard_normal(n) + 1j * RNG.standard_normal(n))
    return x.astype(np.complex64)


def _stream(jop, top, x, cut):
    sj = jop.init_state()
    ys_j, ys_t = [], []
    for blk in (x[:cut], x[cut:]):
        st = state_from_jax(sj, "cpu")  # both start from one state
        sj, yj = jop(sj, jnp.asarray(blk))
        st, yt = top(st, torch.as_tensor(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
        ys_j.append(np.asarray(yj))
        ys_t.append(yt.numpy())
    return np.concatenate(ys_j), np.concatenate(ys_t)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_costas_orders_stream(order):
    x = _psk(1200, order)
    jc = jl.Costas(order, 0.02)
    tc = tl.Costas(order, 0.02, device="cpu")
    _, y = _stream(jc, tc, x, 500)
    # locked: the mixed-down samples raised to the order share one phase
    u = (y[-300:] / np.abs(y[-300:])) ** order
    assert np.abs(u.mean()) > 0.8


@pytest.mark.parametrize("broken", [False, True])
def test_meteor_costas_streams(broken):
    phases = jp.MeteorCostas.BROKEN_PHASES if broken else None
    x = _psk(1500, 4, cfo=0.004, phases=phases)
    jc = jp.MeteorCostas(0.005, broken)
    tc = tp.MeteorCostas(0.005, broken, device="cpu")
    assert tc.BROKEN_PHASES == jc.BROKEN_PHASES
    assert (tc.alpha, tc.beta) == (jc.alpha, jc.beta)
    _stream(jc, tc, x, 700)


def test_costas_with_frequency_limits_streams():
    """The RDS demodulator's second loop: a start frequency and clamps."""
    bw = 2 * np.pi * 1187.5 / 5000.0
    kw = dict(init_freq=bw, min_freq=bw * 0.9, max_freq=bw * 1.1)
    x = _psk(800, 2, cfo=bw * 1.02, noise=0.1)
    _stream(jl.Costas(2, 0.01, **kw), tl.Costas(2, 0.01, device="cpu", **kw),
            x, 333)


def test_costas_rows_are_independent_and_cpu_launches_nothing():
    tc = tl.Costas(4, 0.02, device="cpu")
    x = torch.as_tensor(np.stack([_psk(300, 4), _psk(300, 4, cfo=-0.01)]))
    before = tl.costas_scan.launches
    st, y = tc(tc.init_state(), x)
    assert tl.costas_scan.launches == before  # CPU: the plain loop
    assert y.shape == (2, 300) and st[0].shape == (2,)
    for r in range(2):
        s1, y1 = tc(tc.init_state(), x[r])
        np.testing.assert_array_equal(y1.numpy(), y[r].numpy())
        assert float(s1[0]) == float(st[0][r])


def test_costas_error_modes_against_reference():
    """Each error function alone, on the same mixed-down samples (the
    reference's take one sample, as inside its scan: vmapped here)."""
    v = _psk(400, 8, cfo=0.0, phase=0.1, noise=0.3)
    re, im = torch.as_tensor(v.real), torch.as_tensor(v.imag)
    for order, mode in ((2, tl.COSTAS_ORDER2), (4, tl.COSTAS_ORDER4),
                        (8, tl.COSTAS_ORDER8)):
        want = np.asarray(jax.vmap(jl.Costas(order, 0.01)._error)(
            jnp.asarray(v)))
        got = tl.costas_error(re, im, mode).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    want = np.asarray(jax.vmap(jp.MeteorCostas(0.01, True)._error)(
        jnp.asarray(v)))
    got = tl.costas_error(re, im, tl.COSTAS_BROKEN).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
