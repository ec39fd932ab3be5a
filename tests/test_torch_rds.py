"""sdrtpu_torch's RDS demodulator and group decoder against sdrtpu's
(CPU; the port's Costas and M&M run their plain PyTorch loops).

- Block layer and group decoder: host copies, exact (same syndromes,
  corrections, groups, PI/PS/RadioText/PTYN).
- The first 0.6 s of the RDS fixture (tests/fixtures/
  wfm_stereo_rds_250k.wav, 250 kHz; six blocks of 25 000) through the
  port's `BroadcastFm` tap, `RdsDemod` on each block's 500-sample tap
  and `RdsDecoder` decodes PI 0xF00D and PS
  "SDRTPU  ", as tests/test_oracle_parity.py:304-305.
- The seam.  The port's `RdsDemod` carries the last *valid* hard bit
  into the next block's differential decode, so its chunked bits equal
  one differential decode of its whole hard-bit stream.  The reference
  carries its last slot, an invalid padding slot that is always 0; its
  bits differ from the same one-call decode of its own hard bits
  exactly at the first valid bit of each block whose previous block
  ended on a valid hard 1.  Exact, no tolerance.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders import rds as jr  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.decoders import rds as tr  # noqa: E402
from sdrtpu_torch.io.wav import read_iq_wav  # noqa: E402
from sdrtpu_torch.kernels.wfm import BroadcastFm  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "wfm_stereo_rds_250k.wav")
RNG = np.random.default_rng(101)


def _rds_tap(blocks=6):
    """The 5 kHz RDS baseband of the fixture's first ``blocks`` blocks of
    25 000 samples, from the port's WFM tap (the tap does not depend on
    the pilot, so the mono demod gives the same)."""
    info, iq = read_iq_wav(FIXTURE)
    iq = iq[:blocks * 25000]
    fm = BroadcastFm(75000.0, float(info.samplerate), stereo=False,
                     rds_out=True, device="cpu")
    st, taps = fm.init_state(), []
    for i in range(0, len(iq), 25000):
        st, (_, rds) = fm(st, torch.as_tensor(iq[i:i + 25000]))
        taps.append(rds)
    return torch.cat(taps)


def test_block_layer_matches_reference():
    for word in RNG.integers(0, 1 << 26, 50):
        assert tr.calc_syndrome(int(word)) == jr.calc_syndrome(int(word))
        for btype in range(5):
            assert (tr.correct_errors(int(word), btype)
                    == jr.correct_errors(int(word), btype))
    for args in ((0xF00D, 0, 0, 2, 0x4142, 0x4344),
                 (0xBEEF, 2, 1, 7, 0, 0x2020), (0x1234, 10, 0, 1, 1, 2)):
        np.testing.assert_array_equal(tr.encode_group(*args),
                                      jr.encode_group(*args))


def test_group_decoder_matches_reference():
    name, text, ptyn = b"SDRTPU  ", b"HELLO FROM THE CARD!" + b" " * 44, b"POP MUSC"
    groups = []
    for seg in range(4):
        d = (name[seg * 2] << 8) | name[seg * 2 + 1]
        groups.append(tr.encode_group(0xF00D, 0, 0, seg, 0, d))
    for seg in range(16):
        c = (text[seg * 4] << 8) | text[seg * 4 + 1]
        d = (text[seg * 4 + 2] << 8) | text[seg * 4 + 3]
        groups.append(tr.encode_group(0xF00D, 2, 0, seg, c, d))
    for seg in range(2):
        c = (ptyn[seg * 4] << 8) | ptyn[seg * 4 + 1]
        d = (ptyn[seg * 4 + 2] << 8) | ptyn[seg * 4 + 3]
        groups.append(tr.encode_group(0xF00D, 10, 0, seg, c, d))
    bits = np.concatenate(groups * 2)
    bits[500:502] ^= 1  # a burst the syndrome LFSR corrects
    td, jd = tr.RdsDecoder(), jr.RdsDecoder()
    td.process(bits)
    jd.process(bits)
    assert td.pi_code == jd.pi_code == 0xF00D
    assert td.program_service_name == jd.program_service_name == "SDRTPU  "
    assert td.radiotext == jd.radiotext
    assert td.radiotext.startswith("HELLO FROM THE CARD!")
    assert td.program_type_name == jd.program_type_name == "POP MUSC"


def test_fixture_decodes_pi_and_ps():
    tap = _rds_tap()
    assert tap.shape == (3000,) and tap.dtype == torch.complex64
    demod, dec = tr.RdsDemod(device="cpu"), tr.RdsDecoder()
    st = demod.init_state()
    for i in range(0, len(tap), 500):
        st, (bits, valid) = demod(st, tap[i:i + 500])
        dec.process(bits[valid].numpy())
    assert dec.pi_code == 0xF00D
    assert dec.program_service_name == "SDRTPU  "


def _hard_bits(demod, states, x, to_np):
    """Each block's valid hard bits (before the differential decode),
    running the demodulator's own stages from each block's state."""
    out = []
    for st, blk in zip(states, x):
        _, y = demod.agc(st["agc"], blk)
        _, y = demod.costas(st["c1"], y)
        _, y = demod.fir(st["fir"], y)
        _, y = demod.costas2(st["c2"], y)
        _, (sym, valid) = demod.recov(st["mm"], y.real)
        sym, valid = to_np(sym), to_np(valid)
        out.append((sym[valid] > 0).astype(np.uint8))
    return out


def _one_call_diff(hard_blocks):
    h = np.concatenate(hard_blocks)
    return h ^ np.concatenate([[0], h[:-1]]).astype(np.uint8)


def test_seam_carries_the_last_valid_bit():
    tap = _rds_tap().numpy()
    blocks = [tap[i:i + 500] for i in range(0, len(tap), 500)]

    # the port: chunked bits == one decode of its whole hard-bit stream
    td = tr.RdsDemod(device="cpu")
    st, states, bits_t = td.init_state(), [], []
    for blk in blocks:
        states.append(st)
        st, (b, v) = td(st, torch.as_tensor(blk))
        bits_t.append(b[v].numpy())
    hard_t = _hard_bits(td, states, [torch.as_tensor(b) for b in blocks],
                        lambda t: t.numpy())
    np.testing.assert_array_equal(np.concatenate(bits_t),
                                  _one_call_diff(hard_t))
    assert int(st["diff"]) == int(hard_t[-1][-1])

    # the reference: differs exactly at the seams after a valid hard 1
    jd = jr.RdsDemod()
    sj, states, bits_j = jd.init_state(), [], []
    for blk in blocks:
        states.append(sj)
        sj, (b, v) = jd(sj, jnp.asarray(blk))
        bits_j.append(np.asarray(b)[np.asarray(v)])
        assert int(sj["diff"]) == 0  # the carried slot is padding
    hard_j = _hard_bits(jd, states, [jnp.asarray(b) for b in blocks],
                        np.asarray)
    want = set()
    start = 0
    for k in range(1, len(blocks)):
        start += len(hard_j[k - 1])
        if hard_j[k - 1][-1] == 1:
            want.add(start)
    diff_at = set(np.flatnonzero(np.concatenate(bits_j)
                                 != _one_call_diff(hard_j)).tolist())
    assert want, "no seam after a hard 1: the test shows nothing"
    assert diff_at == want

    # both start from one state: the JAX package's, carried over
    st = state_from_jax(jd.init_state(), "cpu")
    assert int(st["diff"]) == 0 and st["diff"].dtype == torch.uint8
