"""sdrtpu_torch's PSK chains against sdrtpu's (both on the CPU, where
the port's Costas and M&M run their plain PyTorch loops).

- `FastAgc`: 2e-5 relative on the output and the carried gain.  The
  reference solves the recurrence with an associative scan, the port
  with doubling passes: the same sums in another order.
- `MeteorDemod` stage by stage, each stage fed the same input on both
  sides (the reference's previous stage's output): RRC 1e-6, AGC 2e-5
  relative, Costas 1e-4, the OQPSK delay exact.  Two blocks; both
  packages start each from the JAX package's state, carried into the
  port by ``convert``.  The M&M stage runs in segments of
  ``MM_SEGMENT`` samples, both packages starting each from the JAX
  package's state: equal valid counts, and every symbol within 1e-3 of
  the reference's or a bank-row flip (`_hold_mm_segment`), at most one
  flip per block beyond 0.1 % of its symbols.  A row flip: where the
  loop's phase lands within rounding of a boundary of the
  interpolator's bank rows (``floor(phase * 128)``), the two packages
  (the port sums the 8 tap products pairwise, XLA's CPU code with
  reassociation allowed) may pick neighbouring rows; the segments keep
  the carried difference from spreading past its segment.
- `Psk` and `Gfsk` whole, two blocks from one state each: valid counts
  within 2 and ``isclose(atol=2e-2)`` on more than 99.5 % of the symbols
  (the thresholds of the reference's own Meteor oracle test,
  tests/test_oracle_parity.py:386-393): a closed chain of loops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.signal as sig  # noqa: E402

from sdrtpu.kernels import psk as jp  # noqa: E402
from sdrtpu.kernels import taps as jtaps  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.kernels import psk as tp  # noqa: E402

SEED = 71  # each test seeds its own generator with it
MM_SEGMENT = 250  # samples (~120 symbols)


def _meteor_iq(rng, nsym, cfo_hz=100.0, noise=0.05):
    tx = np.exp(1j * (rng.integers(0, 4, nsym) * np.pi / 2 + np.pi / 4))
    h = jtaps.root_raised_cosine_rate(251, 0.6, 1.0, 25.0)
    x = sig.upfirdn(h * 25.0, tx, 25, 12)[: nsym * 25 // 12]
    n = np.arange(len(x))
    x = x * np.exp(1j * (0.7 + 2 * np.pi * cfo_hz * n / 150000.0))
    x = x + noise * (rng.standard_normal(len(x))
                     + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


def _masked(out):
    y, v = out
    return np.asarray(y)[np.asarray(v)]


def _close_symbols(got, want, atol, share):
    assert abs(len(got) - len(want)) <= 2, (len(got), len(want))
    m = min(len(got), len(want))
    assert np.isclose(got[:m], want[:m], atol=atol).mean() > share


def _hold_mm_segment(jrecov, trecov, state, seg):
    """One M&M segment from the JAX package's ``state`` on both sides.
    Valid counts must be equal, and each port symbol within 1e-3 of the
    reference's or a row flip: the reference's symbol is the bank's row
    r applied to some window of the input (1e-4), and the port's is row
    r - 1 or r + 1 applied to the same window (1e-4).  Returns the JAX
    state after the segment and the counts (symbols, flips)."""
    new, (dj, vj) = jrecov(state, jnp.asarray(seg))
    _, (dt, vt) = trecov(state_from_jax(state, "cpu"), torch.as_tensor(seg))
    want, got = _masked((dj, vj)), _masked((dt, vt))
    assert len(got) == len(want), (len(got), len(want))
    ext = np.concatenate([np.asarray(state["tail"]), seg]).astype(
        np.complex128)
    bank = np.asarray(jrecov.bank, np.float64)
    windows = np.lib.stride_tricks.sliding_window_view(ext, bank.shape[1])
    cand = windows @ bank.T  # (offset, row): every row at every offset
    flips = 0
    for w, g in zip(want, got):
        if abs(g - w) <= 1e-3:
            continue
        o, r = np.unravel_index(np.argmin(np.abs(cand - w)), cand.shape)
        assert abs(cand[o, r] - w) <= 1e-4, (w, cand[o, r])
        near = [cand[o, q] for q in (r - 1, r + 1) if 0 <= q < len(bank)]
        assert min(abs(g - c) for c in near) <= 1e-4, (g, w, r)
        flips += 1
    return new, len(want), flips


def test_fast_agc_streams():
    rng = np.random.default_rng(SEED)
    x = (np.exp(1j * rng.uniform(0, 6.28, 2000))
         * np.linspace(0.01, 3.0, 2000)).astype(np.complex64)
    ja, ta = jp.FastAgc(1.0, 1e6, 0.1), tp.FastAgc(1.0, 1e6, 0.1, device="cpu")
    sj = ja.init_state()
    for blk in (x[:1000], x[1000:]):
        st = state_from_jax(sj, "cpu")
        sj, yj = ja(sj, jnp.asarray(blk))
        st, yt = ta(st, torch.as_tensor(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-5)
    assert abs(np.abs(yt.numpy()[-300:]).mean() - 1.0) < 0.05


def test_fast_agc_max_gain_clamps():
    x = np.full(300, 1e-9, np.complex64)
    ja, ta = jp.FastAgc(1.0, 20.0, 0.1), tp.FastAgc(1.0, 20.0, 0.1,
                                                    device="cpu")
    sj, yj = ja(ja.init_state(), jnp.asarray(x))
    st, yt = ta(state_from_jax(ja.init_state(), "cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5)
    assert float(st) == float(sj) == 20.0


@pytest.mark.parametrize("oqpsk", [False, True])
def test_meteor_demod_stage_by_stage(oqpsk):
    x = _meteor_iq(np.random.default_rng(SEED), 1800)
    jd = jp.MeteorDemod(oqpsk=oqpsk)
    td = tp.MeteorDemod(oqpsk=oqpsk, device="cpu")
    np.testing.assert_array_equal(td.rrc.taps, jd.rrc.taps)
    assert td.max_out(3000) == jd.max_out(3000)
    sj = jd.init_state()
    for blk in (x[:2000], x[2000:]):
        st = state_from_jax(sj, "cpu")
        _, a = jd.rrc(sj["rrc"], jnp.asarray(blk))
        _, a_t = td.rrc(st["rrc"], torch.as_tensor(blk))
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a), atol=1e-6)
        _, b = jd.agc(sj["agc"], a)
        _, b_t = td.agc(st["agc"], torch.as_tensor(np.array(a)))
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-6)
        _, c = jd.costas(sj["costas"], b)
        _, c_t = td.costas(st["costas"], torch.as_tensor(np.array(b)))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c), atol=1e-4)
        if oqpsk:
            im_prev = jnp.concatenate([jnp.asarray(sj["last_i"])[None],
                                       c.imag[:-1]])
            c = c.real + 1j * im_prev
        mm, n_sym, n_flip = sj["mm"], 0, 0
        c = np.array(c)
        for s0 in range(0, len(c), MM_SEGMENT):
            mm, n, f = _hold_mm_segment(jd.recov, td.recov, mm,
                                        c[s0:s0 + MM_SEGMENT])
            n_sym, n_flip = n_sym + n, n_flip + f
        assert n_flip <= 1 + 0.001 * n_sym, (n_flip, n_sym)
        # the whole port chain from the same state gives the same stages
        st_t, out_t = td(st, torch.as_tensor(blk))
        sj, out_j = jd(sj, jnp.asarray(blk))
        _close_symbols(_masked(out_t), _masked(out_j), 2e-2, 0.995)
        np.testing.assert_allclose(st_t["last_i"].numpy(),
                                   np.asarray(sj["last_i"]), atol=1e-4)
        np.testing.assert_allclose(st_t["costas"][0].numpy(),
                                   np.asarray(sj["costas"][0]), atol=1e-4)


def test_psk_streams():
    rng = np.random.default_rng(SEED)
    sps = 4
    sym = np.exp(1j * (rng.integers(0, 4, 700) * np.pi / 2 + np.pi / 4))
    up = np.zeros(len(sym) * sps, np.complex128)
    up[::sps] = sym
    h = jtaps.root_raised_cosine_rate(45, 0.35, 1.0, float(sps))
    x = np.convolve(up, h, "same") * sps
    x = (x * np.exp(1j * (0.3 + 1e-4 * np.arange(len(x))))).astype(
        np.complex64)
    kw = dict(symbolrate=1.0, samplerate=4.0, rrc_tap_count=45,
              rrc_beta=0.35, agc_rate=0.01, costas_bandwidth=0.01,
              omega_gain=1e-4, mu_gain=0.05)
    jd, td = jp.Psk(4, **kw), tp.Psk(4, device="cpu", **kw)
    sj = jd.init_state()
    for blk in (x[:1300], x[1300:]):
        st = state_from_jax(sj, "cpu")
        sj, out_j = jd(sj, jnp.asarray(blk))
        st, out_t = td(st, torch.as_tensor(blk))
        _close_symbols(_masked(out_t), _masked(out_j), 2e-2, 0.995)
    tail = _masked(out_t)[100:]
    ang = np.mod(np.angle(tail), np.pi / 2) - np.pi / 4
    assert np.std(ang) < 0.25


def test_gfsk_streams():
    fs, baud, dev = 48000.0, 4800.0, 2400.0
    rng = np.random.default_rng(SEED)
    bits = rng.integers(0, 2, 400) * 2.0 - 1.0
    sps = int(fs / baud)
    freq = np.repeat(bits, sps) * dev
    x = np.exp(1j * np.cumsum(2 * np.pi * freq / fs)).astype(np.complex64)
    jd = jp.Gfsk(baud, fs, dev)
    td = tp.Gfsk(baud, fs, dev, device="cpu")
    sj = jd.init_state()
    for blk in (x[:1700], x[1700:]):
        st = state_from_jax(sj, "cpu")
        sj, out_j = jd(sj, jnp.asarray(blk))
        st, out_t = td(st, torch.as_tensor(blk))
        assert out_t[0].dtype == torch.float32
        _close_symbols(_masked(out_t), _masked(out_j), 2e-2, 0.995)
