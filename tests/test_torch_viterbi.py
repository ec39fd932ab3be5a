"""sdrtpu_torch's convolutional encoder and Viterbi decoder against
sdrtpu's (both on the CPU, where `viterbi_decode` runs its plain PyTorch
loop).

Tolerance: none.  With rate 1/2 and expected symbols of +-1 each branch
metric is one rounded sum of two exact products, each candidate one
rounded add and the normalisation one rounded subtract, so the decoded
bits and the final path metrics equal the JAX package's to the bit, for
the CCSDS K=7 code and a K=5 code, clean, noisy and with hard errors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdrtpu.fec import viterbi as jv  # noqa: E402
from sdrtpu_torch.fec import viterbi as tv  # noqa: E402

RNG = np.random.default_rng(57)
CODES = [(7, (0o171, 0o133)), (5, (0o27, 0o31))]


def _jax_final_metrics(dec, soft):
    """The reference's add-compare-select scan as `decode` runs it
    (sdrtpu/fec/viterbi.py:109-131), returning its final metrics, which
    `decode` keeps to itself."""
    soft = jnp.asarray(soft, jnp.float32)
    n = soft.shape[-1] // dec.rate
    sym = soft[: n * dec.rate].reshape(n, dec.rate)
    prev = jnp.asarray(dec.prev)
    exp_prev = jnp.asarray(dec.expected)[prev, jnp.asarray(dec.prev_bit)]

    def acs(metrics, r):
        bm = jnp.einsum("sjr,r->sj", exp_prev, r)
        cand = metrics[prev] + bm
        best = jnp.argmax(cand, axis=1)
        new = jnp.take_along_axis(cand, best[:, None], axis=1)[:, 0]
        return new - jnp.max(new), None

    init = jnp.full((dec.S,), -1e9, jnp.float32).at[0].set(0.0)
    metrics, _ = jax.lax.scan(acs, init, sym)
    return np.asarray(metrics)


def _both(K, polys, soft):
    jd = jv.ViterbiDecoder(K, polys)
    td = tv.ViterbiDecoder(K, polys, device="cpu")
    for name in ("expected", "prev", "prev_bit", "next_state"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    bits_j = np.asarray(jd.decode(jnp.asarray(soft)))
    n = len(soft) // 2
    bits_t, metrics_t = tv.viterbi_decode(
        torch.as_tensor(soft[: 2 * n].reshape(1, n, 2)), td.exp_prev,
        td.prev, td.prev_bit)
    np.testing.assert_array_equal(bits_t[0].numpy(), bits_j)
    np.testing.assert_array_equal(metrics_t[0].numpy(),
                                  _jax_final_metrics(jd, soft))
    np.testing.assert_array_equal(td.decode(soft).numpy(), bits_j)
    return bits_j


@pytest.mark.parametrize("K,polys", CODES)
def test_encoder_matches(K, polys):
    bits = RNG.integers(0, 2, 400).astype(np.uint8)
    je, te = jv.ConvEncoder(K, polys), tv.ConvEncoder(K, polys)
    np.testing.assert_array_equal(te.encode(bits), je.encode(bits))
    np.testing.assert_array_equal(te.encode_to_soft(bits, 0.7),
                                  je.encode_to_soft(bits, 0.7))


@pytest.mark.parametrize("K,polys", CODES)
def test_clean_roundtrip_bit_equal(K, polys):
    bits = RNG.integers(0, 2, 600).astype(np.uint8)
    soft = tv.ConvEncoder(K, polys).encode_to_soft(bits)
    np.testing.assert_array_equal(_both(K, polys, soft), bits)


@pytest.mark.parametrize("K,polys", CODES)
def test_noisy_bit_equal(K, polys):
    bits = RNG.integers(0, 2, 1500).astype(np.uint8)
    soft = tv.ConvEncoder(K, polys).encode_to_soft(bits)
    soft = soft + 0.6 * RNG.standard_normal(len(soft)).astype(np.float32)
    out = _both(K, polys, soft)
    assert np.mean(out != bits) < 0.02


@pytest.mark.parametrize("K,polys", CODES)
def test_hard_errors_bit_equal(K, polys):
    bits = RNG.integers(0, 2, 1000).astype(np.uint8)
    soft = tv.ConvEncoder(K, polys).encode_to_soft(bits)
    flip = RNG.choice(len(soft), size=len(soft) // 25, replace=False)
    soft[flip] = -soft[flip]  # 4 % symbol errors
    out = _both(K, polys, soft)
    assert np.mean(out != bits) < 0.02


def test_rows_decode_independently_and_odd_tail_is_dropped():
    td = tv.ViterbiDecoder(device="cpu")
    soft = np.stack([
        td_soft for td_soft in (
            tv.ConvEncoder().encode_to_soft(RNG.integers(0, 2, 300)),
            tv.ConvEncoder().encode_to_soft(RNG.integers(0, 2, 300)))])
    noisy = (soft + 0.5 * RNG.standard_normal(soft.shape)).astype(np.float32)
    bits, metrics = tv.viterbi_decode(
        torch.as_tensor(noisy.reshape(2, 300, 2)), td.exp_prev, td.prev,
        td.prev_bit)
    for r in range(2):
        np.testing.assert_array_equal(bits[r].numpy(),
                                      td.decode(noisy[r]).numpy())
    # an odd trailing soft symbol is ignored, as in the reference
    odd = np.concatenate([noisy[0], [0.3]]).astype(np.float32)
    np.testing.assert_array_equal(td.decode(odd).numpy(), bits[0].numpy())
    assert tv.viterbi_decode.launches == 0  # CPU tensors never launch
