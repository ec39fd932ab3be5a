"""sdrtpu_torch's POCSAG decoder against sdrtpu's.

The bit layer is a host copy: the BCH syndrome table, the encoder, the
corrections and the decoded pages equal the reference's exactly, fed a
numpy array or a tensor.  The RF chain (tests/test_pocsag.py:63-87:
`GfskMod` -> `Gfsk` (float M&M) -> `PocsagDecoder`, 1200 baud at 24 ksps,
4.5 kHz deviation, RRC 2*sps+1 taps, beta 0.9), both receivers fed the
port's transmitter, two streamed blocks from one converted state: the valid counts within 2, the hard decisions
equal, ``isclose(atol=2e-2)`` on more than 99.5 % of the soft symbols
(tests/test_torch_psk.py's thresholds for a closed loop); every page
decoded by both, equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders import pocsag as jp  # noqa: E402
from sdrtpu.kernels.psk import Gfsk as JGfsk  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.decoders import pocsag as tp  # noqa: E402
from sdrtpu_torch.kernels.mod import GfskMod as TGfskMod  # noqa: E402
from sdrtpu_torch.kernels.psk import Gfsk as TGfsk  # noqa: E402

FS, BAUD, DEV = 24000.0, 1200.0, 4500.0
SPS = int(FS / BAUD)
PAGES = [(0x1F4, "RF OK", tp.MESSAGE_ALPHA, 1),
         (0x2A5F8, "0123*U-", tp.MESSAGE_NUMERIC, 3),
         (0x54321, "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789",
          tp.MESSAGE_ALPHA, 6)]


def test_bch_table_and_encoder_equal():
    assert tp._syndrome_table() == jp._syndrome_table()
    rng = np.random.default_rng(4)
    for d in rng.integers(0, 1 << 21, 50):
        assert tp.encode_codeword(int(d)) == jp.encode_codeword(int(d))
    assert tp.encode_codeword(tp.IDLE_DATA) == 0x7A89C197


def test_corrections_equal():
    """No, one, two and three bit errors: the same corrected word (or
    the same refusal)."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        cw = tp.encode_codeword(int(rng.integers(0, 1 << 21)))
        k = int(rng.integers(0, 4))
        for p in rng.choice(32, k, replace=False):
            cw ^= 1 << int(p)
        assert tp.correct_codeword(cw) == jp.correct_codeword(cw)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_bit_layer_equal(as_tensor):
    rng = np.random.default_rng(6)
    bits = np.concatenate([tp.build_transmission(a, t, m, f)
                           for a, t, m, f in PAGES])
    np.testing.assert_array_equal(
        bits, np.concatenate([jp.build_transmission(a, t, m, f)
                              for a, t, m, f in PAGES]))
    bits = bits.copy()
    flip = rng.choice(len(bits) - 640, 6, replace=False) + 608
    bits[flip] ^= 1
    jd, td = jp.PocsagDecoder(), tp.PocsagDecoder()
    for chunk in np.array_split(bits, 5):
        jd.process(chunk)
        td.process(torch.as_tensor(chunk) if as_tensor else chunk)
    jd.flush()
    td.flush()
    assert td.messages == jd.messages
    assert all(m[2].startswith(p[1]) for m, p in zip(td.messages, PAGES))
    assert len(td.messages) == len(PAGES)


def test_rf_chain_like_the_reference():
    bits = np.concatenate([tp.build_transmission(a, t, m, f)
                           for a, t, m, f in PAGES[:2]]
                          + [np.zeros(32, np.uint8)])
    sym = (1.0 - 2.0 * bits.astype(np.float32))  # 0 -> +dev, 1 -> -dev
    kw = dict(rrc_tap_count=2 * SPS + 1, rrc_beta=0.9)
    # both receivers hear the port's transmitter (tests/test_torch_mod.py
    # holds the modulators against each other)
    tmod = TGfskMod(SPS, DEV, FS, device="cpu", **kw)
    iq = tmod(tmod.init_state(), torch.as_tensor(sym))[1].numpy()
    dkw = dict(omega_gain=1e-4, mu_gain=0.05, **kw)
    jd, td = JGfsk(BAUD, FS, DEV, **dkw), TGfsk(BAUD, FS, DEV, device="cpu",
                                                **dkw)
    sj = jd.init_state()
    st = state_from_jax(sj, "cpu")
    jdec, tdec = jp.PocsagDecoder(), tp.PocsagDecoder()
    half = len(iq) // 2
    for blk in (iq[:half], iq[half:]):
        sj, (ys, yv) = jd(sj, jnp.asarray(blk))
        st, (ts, tv) = td(st, torch.as_tensor(blk))
        want = np.asarray(ys)[np.asarray(yv)]
        got = ts[tv].numpy()
        assert abs(len(got) - len(want)) <= 2
        m = min(len(got), len(want))
        np.testing.assert_array_equal(got[:m] < 0, want[:m] < 0)
        assert np.isclose(got[:m], want[:m], atol=2e-2).mean() > 0.995
        jdec.process((want < 0).astype(np.uint8))
        tdec.process(ts[tv] < 0)  # the port's decoder takes the tensor
    jdec.flush()
    tdec.flush()
    assert tdec.messages == jdec.messages
    # a numeric page's last codeword is padded with "0" digits
    assert [a for a, _, _ in tdec.messages] == [(a & ~7) | f for a, _, _, f
                                               in PAGES[:2]]
    assert all(t.startswith(p[1]) for (_, _, t), p in
               zip(tdec.messages, PAGES))
