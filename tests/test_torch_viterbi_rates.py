"""sdrtpu_torch's Viterbi decoder at rates 1/3 and 1/4 (DAB's mother
code, polys 0o133, 0o171, 0o145, 0o133) against sdrtpu's.

Tolerances: with +-1 and 0 soft symbols (DAB's hard FIC decisions and
the depunctured erasures) every branch metric is exact in any order of
summation, so bits and final metrics are equal.  On random float soft
symbols the reference's einsum may sum the R products in another order
than the port (r order, each add rounded): at a clean SNR the bits are
equal and the final metrics agree within 1e-3 (absolute; they are
normalised to a maximum of 0 and span ~1e2, so float32 rounding over
the block's steps stays far below).  The reference's final metrics come
from its own recursion (`_jax_metrics`, the reference's `acs` over its
tables), since its decoder returns bits only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders.dab import DAB_POLYS, fic_puncture_mask  # noqa: E402
from sdrtpu.fec import viterbi as jv  # noqa: E402
from sdrtpu_torch.fec import viterbi as tv  # noqa: E402

R3_POLYS = (0o133, 0o171, 0o145)
K5_R4_POLYS = (0o27, 0o31, 0o35, 0o33)


def _jax_metrics(dec, soft):
    """The reference decoder's final path metrics: its own add-compare-
    select recursion over its own tables (sdrtpu/fec/viterbi.py:114-128)."""
    n = soft.shape[-1] // dec.rate
    sym = jnp.asarray(soft[: n * dec.rate].reshape(n, dec.rate))
    exp_prev = jnp.asarray(dec.expected[dec.prev, dec.prev_bit])
    prev = jnp.asarray(dec.prev)

    def acs(metrics, r):
        bm = jnp.einsum("sjr,r->sj", exp_prev, r)
        cand = metrics[prev] + bm
        best = jnp.argmax(cand, axis=1)
        m = jnp.take_along_axis(cand, best[:, None], axis=1)[:, 0]
        return m - jnp.max(m), None

    init = jnp.full((dec.S,), -1e9, jnp.float32).at[0].set(0.0)
    return np.asarray(jax.lax.scan(acs, init, sym)[0])


def _port_metrics(dec, soft):
    n = soft.shape[-1] // dec.rate
    sym = torch.as_tensor(soft[: n * dec.rate].reshape(1, n, dec.rate))
    bits, metrics = tv.viterbi_decode(sym, dec.exp_prev, dec.prev,
                                      dec.prev_bit)
    return bits[0].numpy(), metrics[0].numpy()


def _both(K, polys, soft):
    jd, td = jv.ViterbiDecoder(K, polys), tv.ViterbiDecoder(K, polys,
                                                            device="cpu")
    want = np.asarray(jd.decode(jnp.asarray(soft)))
    got, metrics = _port_metrics(td, soft)
    assert np.array_equal(td.decode(soft).numpy(), got)
    return got, want, metrics, _jax_metrics(jd, soft)


@pytest.mark.parametrize("K,polys", [(7, DAB_POLYS), (7, R3_POLYS),
                                     (5, K5_R4_POLYS), (5, R3_POLYS[:3])])
def test_hard_symbols_with_erasures_bit_equal(K, polys):
    """+-1 symbols, 2 % of them flipped, DAB's FIC puncturing as 0.0
    erasures (tiled to the block): bits and metrics equal."""
    rng = np.random.default_rng(K * 10 + len(polys))
    n = 768
    bits = rng.integers(0, 2, n).astype(np.uint8)
    bits[-(K - 1):] = 0
    soft = tv.ConvEncoder(K, polys).encode_to_soft(bits)
    flip = rng.choice(soft.size, soft.size // 50, replace=False)
    soft[flip] *= -1.0
    if len(polys) == 4:
        keep = np.resize(fic_puncture_mask(), soft.size).astype(bool)
        soft[~keep] = 0.0
    got, want, m_got, m_want = _both(K, polys, soft.astype(np.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(m_got, m_want)
    np.testing.assert_array_equal(got, bits)


@pytest.mark.parametrize("K,polys", [(7, DAB_POLYS), (7, R3_POLYS),
                                     (5, K5_R4_POLYS)])
def test_random_floats_clean_snr(K, polys):
    rng = np.random.default_rng(3 + K)
    n = 600
    bits = rng.integers(0, 2, n).astype(np.uint8)
    soft = tv.ConvEncoder(K, polys).encode_to_soft(bits)
    soft = (soft + 0.3 * rng.standard_normal(soft.size)).astype(np.float32)
    got, want, m_got, m_want = _both(K, polys, soft)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bits)
    finite = m_want > -1e8
    np.testing.assert_allclose(m_got[finite], m_want[finite], atol=1e-3)


def test_rows_decode_as_one_launch_and_equal_single_rows():
    """`decode_rows` (DAB decodes a frame's four FIC codewords as the
    four rows of one launch) gives each row's `decode` bits."""
    rng = np.random.default_rng(8)
    enc = tv.ConvEncoder(7, DAB_POLYS)
    dec = tv.ViterbiDecoder(7, DAB_POLYS, device="cpu")
    soft = np.stack([enc.encode_to_soft(rng.integers(0, 2, 200))
                     + 0.8 * rng.standard_normal(800)
                     for _ in range(4)]).astype(np.float32)
    rows = dec.decode_rows(soft)
    assert rows.shape == (4, 200)
    for r in range(4):
        np.testing.assert_array_equal(rows[r].numpy(),
                                      dec.decode(soft[r]).numpy())
