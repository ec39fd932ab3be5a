"""sdrtpu_torch's symbol timing recovery against sdrtpu's (both on the
CPU, where `mm_scan` runs its plain PyTorch loop).

`MuellerMuller` in complex and float mode runs both packages on one
common input stream (QPSK at the Meteor rate's fractional 25/12 samples
per symbol; a BPSK-like real stream at 5000/1187.5), block by block,
each block started in both from the JAX package's state carried into
the port by ``convert``.  Tolerances, as the reference's own oracle
test (tests/test_oracle_parity.py:286-292): valid counts within 2 per
block and ``isclose(atol=1e-3)`` on more than 99.9 % of the symbols.
The port sums the 8 interpolator taps in a fixed pairwise order and XLA
in its own, so a floor() decision may flip; the loops are contractive.
Carried scalars within 1e-4.  `FeedforwardSymbolSync`: 1e-4 on the
symbols; `interp_bank` byte-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.signal as sig  # noqa: E402

from sdrtpu.kernels import clock as jc  # noqa: E402
from sdrtpu.kernels import taps as jtaps  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.kernels import clock as tc  # noqa: E402

RNG = np.random.default_rng(61)


def _qpsk_stream(nsym, noise=0.05):
    """72 ksym/s QPSK RRC-shaped to 150 ksps (25/12 samples a symbol)."""
    tx = np.exp(1j * (RNG.integers(0, 4, nsym) * np.pi / 2 + np.pi / 4))
    h = jtaps.root_raised_cosine_rate(251, 0.6, 1.0, 25.0)
    x = sig.upfirdn(h * 25.0, tx, 25, 12)[125 // 12:][: nsym * 25 // 12]
    x = x + noise * (RNG.standard_normal(len(x))
                     + 1j * RNG.standard_normal(len(x)))
    return x.astype(np.complex64)


def _bpsk_stream(nsym, sps=5000.0 / 1187.5):
    sym = RNG.choice([-1.0, 1.0], nsym)
    t = np.arange(int(nsym * sps))
    x = sym[np.minimum((t / sps).astype(int), nsym - 1)]
    x = np.convolve(x, np.ones(3) / 3, "same")
    return (x + 0.05 * RNG.standard_normal(len(x))).astype(np.float32)


def _run(jm, tm, x, cuts):
    sj = jm.init_state()
    got_j, got_t = [], []
    edges = [0, *cuts, len(x)]
    for a, b in zip(edges[:-1], edges[1:]):
        st = state_from_jax(sj, "cpu")  # both start from one state
        blk = x[a:b]
        sj, (yj, vj) = jm(sj, jnp.asarray(blk))
        st, (yt, vt) = tm(st, torch.as_tensor(blk))
        yj, vj, yt, vt = (np.asarray(yj), np.asarray(vj), yt.numpy(),
                          vt.numpy())
        assert yt.shape == yj.shape == (jm.max_out(b - a),)
        assert abs(int(vt.sum()) - int(vj.sum())) <= 2
        # the valid slots are a prefix, the rest 0
        m = int(vt.sum())
        assert vt[:m].all() and not vt[m:].any() and not yt[m:].any()
        for key in ("phase", "freq", "last_out"):
            np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                       atol=1e-4)
        assert abs(int(st["offset"]) - int(sj["offset"])) <= 2
        got_j.append(yj[vj])
        got_t.append(yt[vt])
    sym_j, sym_t = np.concatenate(got_j), np.concatenate(got_t)
    m = min(len(sym_j), len(sym_t))
    assert np.isclose(sym_t[:m], sym_j[:m], atol=1e-3).mean() > 0.999
    return sym_t


def test_interp_bank_byte_equal():
    np.testing.assert_array_equal(tc.interp_bank(), jc.interp_bank())
    np.testing.assert_array_equal(tc.interp_bank(32, 8), jc.interp_bank(32, 8))


def test_mm_complex_streams():
    x = _qpsk_stream(2400)
    kw = (25.0 / 12.0, 1e-6, 0.01, 0.01)
    jm = jc.MuellerMuller(*kw)
    tm = tc.MuellerMuller(*kw, device="cpu")
    assert tm.max_out(3000) == jm.max_out(3000)
    syms = _run(jm, tm, x, [1700, 3300])
    # locked: the symbols sit on the QPSK points
    tail = syms[len(syms) // 2:]
    ang = np.mod(np.angle(tail), np.pi / 2) - np.pi / 4
    assert np.std(ang) < 0.3


def test_mm_float_streams():
    x = _bpsk_stream(600)
    kw = (5000.0 / 1187.5, 1e-6, 0.01, 0.01)
    jm = jc.MuellerMuller(*kw, complex_mode=False)
    tm = tc.MuellerMuller(*kw, complex_mode=False, device="cpu")
    syms = _run(jm, tm, x, [500, 1000, 1500])
    assert np.mean(np.abs(syms[len(syms) // 2:]) > 0.5) > 0.8


def test_mm_rows_are_independent():
    tm = tc.MuellerMuller(25.0 / 12.0, 1e-6, 0.01, 0.01, device="cpu")
    x = torch.as_tensor(np.stack([_qpsk_stream(300), _qpsk_stream(300)]))
    st, (y, v) = tm(tm.init_state(), x)
    assert y.shape == (2, tm.max_out(x.shape[-1])) and st["phase"].shape == (2,)
    for r in range(2):
        s1, (y1, v1) = tm(tm.init_state(), x[r])
        np.testing.assert_array_equal(y1.numpy(), y[r].numpy())
        np.testing.assert_array_equal(v1.numpy(), v[r].numpy())
        assert int(s1["offset"]) == int(st["offset"][r])
    assert tc.mm_scan.launches == 0  # CPU tensors never launch


def test_oerder_meyr_and_feedforward_sync():
    sps = 4
    sym = np.exp(1j * (RNG.integers(0, 4, 800) * np.pi / 2 + np.pi / 4))
    up = np.zeros(len(sym) * sps, np.complex128)
    up[1::sps] = sym  # a timing offset of one sample
    h = jtaps.root_raised_cosine_rate(45, 0.35, 1.0, float(sps))
    x = (np.convolve(up, h, "same") * sps).astype(np.complex64)
    tau_j = float(jc.oerder_meyr_timing(jnp.asarray(x), sps))
    tau_t = float(tc.oerder_meyr_timing(torch.as_tensor(x), sps))
    assert abs(tau_t - tau_j) < 1e-4
    jf, tf = jc.FeedforwardSymbolSync(sps), tc.FeedforwardSymbolSync(
        sps, device="cpu")
    sj = jf.init_state()
    for blk in (x[:1600], x[1600:]):
        st = state_from_jax(sj, "cpu")
        sj, yj = jf(sj, jnp.asarray(blk))
        st, yt = tf(st, torch.as_tensor(blk))
        assert yt.shape == yj.shape == (tf.out_len(len(blk)),)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=0)
