"""sdrtpu_torch's CCSDS deframer, Reed-Solomon codec and soft-symbol
files against sdrtpu's (CPU; the port's Viterbi, Costas and M&M run
their plain PyTorch loops).

Tolerance: none.  The host tables (randomizer, RS, encoder) and the
soft-symbol bytes are byte-equal; frames are payload-exact.

One intended divergence: the port's `ReedSolomon(fcr, prim)` puts its
roots at libcorrect's ``alpha^(prim (fcr + j))``, the CCSDS code, where
sdrtpu's puts them at ``alpha^(fcr + prim j)``.  The same code is
sdrtpu's with the first root ``prim fcr mod 255`` (`_jrs`), which
sdrtpu's side is given wherever it encodes or decodes, so every other
layer is still held byte for byte.  The
end-to-end test is the port's counterpart of
tests/test_ccsds.py::test_meteor_rf_end_to_end: the same seeded burst
through both packages' `MeteorDemod`, s8 quantisation and ambiguity
resolver gives the same payload-exact frames.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.signal as sig  # noqa: E402

from sdrtpu.decoders import ccsds as jcc  # noqa: E402
from sdrtpu.fec.reed_solomon import ReedSolomon as JRs  # noqa: E402
from sdrtpu.io import symbols as jsym  # noqa: E402
from sdrtpu.kernels import taps as jtaps  # noqa: E402
from sdrtpu.kernels.psk import MeteorDemod as JMeteor  # noqa: E402
from sdrtpu_torch.decoders import ccsds as tcc  # noqa: E402
from sdrtpu_torch.fec.reed_solomon import ReedSolomon as TRs  # noqa: E402
from sdrtpu_torch.io import symbols as tsym  # noqa: E402
from sdrtpu_torch.kernels.psk import MeteorDemod as TMeteor  # noqa: E402

RNG = np.random.default_rng(91)


def _jrs():
    """sdrtpu's RS set to the port's (and CCSDS's) code."""
    return JRs(nroots=32, prim_poly=0x187, fcr=(11 * 112) % 255, prim=11)


def _jres():
    """sdrtpu's ambiguity resolver, its deframers on `_jrs`."""
    res = jcc.QpskAmbiguityResolver()
    for c in res._cands:
        c.rs = _jrs()
    return res


def _jenc():
    enc = jcc.CcsdsEncoder()
    enc.rs = _jrs()
    return enc


def _cvcdus(k, rng=RNG):
    return [rng.integers(0, 256, tcc.CVCDU_BYTES).astype(np.uint8)
            for _ in range(k)]


def test_host_tables_byte_equal():
    np.testing.assert_array_equal(tcc.ccsds_randomizer(600),
                                  jcc.ccsds_randomizer(600))
    np.testing.assert_array_equal(
        tcc.ccsds_randomizer(8),
        np.frombuffer(bytes.fromhex("ff480ec09a0d70bc"), np.uint8))
    tr, jr = TRs(), _jrs()
    for name in ("exp", "log", "genpoly"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))
    # CCSDS 131.0-B's generator: roots alpha^(11 j), j = 112 .. 143, so
    # its coefficients read the same both ways; sdrtpu's default is not it
    g = [int(c) for c in tr.genpoly]
    assert g == g[::-1]
    for j in range(112, 144):
        assert tr._poly_eval(tr.genpoly, int(tr.exp[(11 * j) % 255])) == 0
    assert not np.array_equal(tr.genpoly, JRs().genpoly)
    cvs = _cvcdus(2)
    np.testing.assert_array_equal(tcc.CcsdsEncoder().encode(cvs),
                                  _jenc().encode(cvs))


def test_reed_solomon_decodes_like_reference():
    tr, jr = TRs(), _jrs()
    data = RNG.integers(0, 256, tr.k).astype(np.uint8)
    cw = tr.encode(data)
    np.testing.assert_array_equal(cw, jr.encode(data))
    for nerr in (0, 5, 16, 17):
        bad = cw.copy()
        pos = RNG.choice(255, nerr, replace=False)
        bad[pos] ^= RNG.integers(1, 256, nerr).astype(np.uint8)
        (dt, nt), (dj, nj) = tr.decode(bad), jr.decode(bad)
        assert nt == nj
        np.testing.assert_array_equal(dt, dj)
        if nerr <= 16:
            assert nt == nerr
            np.testing.assert_array_equal(dt, data)


@pytest.mark.parametrize("nroots, fcr, prim", [(32, 112, 11), (16, 120, 11),
                                               (32, 1, 1)])
def test_reed_solomon_syndromes_are_horners(nroots, fcr, prim):
    """The table-lookup syndromes equal one Horner evaluation of the word
    at each root, for the CCSDS, Falcon 9-like and RyFi codes."""
    rs = TRs(nroots=nroots, prim_poly=0x187, fcr=fcr, prim=prim)
    for word in (np.zeros(255, np.uint8), rs.encode(np.arange(rs.k) % 256),
                 RNG.integers(0, 256, 255).astype(np.uint8)):
        want = [rs._poly_eval(word, int(rs.exp[(prim * (fcr + j)) % 255]))
                for j in range(nroots)]
        np.testing.assert_array_equal(rs._syndromes(word), want)


def test_soft_symbol_files_byte_equal(tmp_path):
    s = (RNG.uniform(-1.8, 1.8, 300) + 1j * RNG.uniform(-1.8, 1.8, 300)
         ).astype(np.complex64)
    valid = RNG.random(300) > 0.2
    np.testing.assert_array_equal(tsym.quantize_soft(s), jsym.quantize_soft(s))
    pj, pt = str(tmp_path / "j.s"), str(tmp_path / "t.s")
    with jsym.SoftSymbolWriter(pj) as w:
        w.write(s[:100])
        w.write(s[100:], valid[100:])
    with tsym.SoftSymbolWriter(pt) as w:
        w.write(torch.as_tensor(s[:100]))
        w.write(torch.as_tensor(s[100:]), torch.as_tensor(valid[100:]))
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(tsym.read_soft_file(pt),
                                  jsym.read_soft_file(pj))
    assert os.path.getsize(pt) == 2 * (100 + int(valid[100:].sum()))


def test_streaming_frame_across_call_boundary():
    enc = tcc.CcsdsEncoder()
    dec = tcc.CcsdsDeframer(device="cpu")
    cvs = _cvcdus(2)
    soft = enc.encode(cvs)
    soft = soft + 0.4 * RNG.standard_normal(len(soft)).astype(np.float32)
    cut = len(soft) // 2 + 777  # mid-frame
    frames = dec.process(soft[:cut])
    assert dec._soft_tail.device.type == "cpu"
    frames += dec.process(torch.as_tensor(soft[cut:]))
    ref = jcc.CcsdsDeframer()
    ref.rs = _jrs()
    want = ref.process(soft[:cut]) + ref.process(soft[cut:])
    assert len(frames) == len(want) == 2
    for got, w, cv in zip(frames, want, cvs):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, cv)
    assert dec.rs_errors == ref.rs_errors


def test_hard_bit_path_across_call_boundary():
    """`process_bits` (frames of hard bits after a Viterbi elsewhere): a
    frame split over two calls, one sent inverted, two bit errors."""
    cvs = _cvcdus(3)
    rs = tcc._ccsds_rs()
    bits = [RNG.integers(0, 2, 100).astype(np.uint8)]
    for k, cv in enumerate(cvs):
        frame = np.zeros(tcc.FRAME_BYTES, np.uint8)
        frame[:tcc.RS_N * tcc.RS_INTERLEAVE] = tcc.rs_interleave_encode(cv, rs)
        fb = np.concatenate([tcc.ASM_BITS, np.unpackbits(frame ^ tcc._RAND)])
        bits.append(fb ^ 1 if k == 1 else fb)
    bits = np.concatenate(bits)
    bits[[150, 9000]] ^= 1
    cut = 100 + 8224 + 4000  # inside the second frame
    dec, ref = tcc.CcsdsDeframer(device="cpu"), jcc.CcsdsDeframer()
    ref.rs = _jrs()
    got = dec.process_bits(bits[:cut]) + dec.process_bits(bits[cut:])
    want = ref.process_bits(bits[:cut]) + ref.process_bits(bits[cut:])
    assert len(got) == len(want) == 3
    for g, w, cv in zip(got, want, cvs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, cv)
    assert dec.rs_errors == ref.rs_errors


def test_chunked_rotated_qpsk_streaming():
    """Symbols in chunks smaller than a frame, Costas locked 90 degrees
    off: each rotation candidate keeps its own soft tail until one
    syncs."""
    cvs = _cvcdus(2)
    soft = tcc.CcsdsEncoder().encode(cvs)
    syms = ((soft[0::2] + 1j * soft[1::2]) * np.exp(1j * np.pi / 2)).astype(
        np.complex64)
    frames, dec = [], None
    for i in range(0, len(syms), 3000):
        f, dec = tcc.deframe_qpsk_symbols(syms[i:i + 3000], dec, device="cpu")
        frames += f
    assert dec.locked == 1
    assert len(frames) == 2
    for got, want in zip(frames, cvs):
        np.testing.assert_array_equal(got, want)
    assert dec.rs_errors == [0, 0]


def _meteor_burst():
    """tests/test_ccsds.py::test_meteor_rf_end_to_end's burst."""
    rng = np.random.default_rng(99)
    cvs = _cvcdus(3, rng)
    soft_bits = _jenc().encode(cvs)
    syms = (soft_bits[0::2] + 1j * soft_bits[1::2]).astype(
        np.complex128) / np.sqrt(2)
    pre = np.exp(1j * (rng.integers(0, 4, 3000) * np.pi / 2 + np.pi / 4))
    tx = np.concatenate([pre, syms])
    up = np.zeros(len(tx) * 25, np.complex128)
    up[::25] = tx
    h = jtaps.root_raised_cosine_rate(251, 0.6, 1.0, 25.0).astype(np.float64)
    shaped = np.convolve(up, h, "same") * 25
    x = sig.resample_poly(shaped, 1, 12).astype(np.complex64)
    fs, n = 150000.0, len(x)
    x = x * np.exp(1j * (0.7 + 2 * np.pi * 100.0 * np.arange(n) / fs)).astype(
        np.complex64)
    x = x + (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
    return cvs, x


def test_meteor_rf_end_to_end_same_frames():
    cvs, x = _meteor_burst()
    jd = JMeteor()
    _, (out, valid) = jd(jd.init_state(), jnp.asarray(x))
    frames_j, _ = jcc.deframe_qpsk_symbols(jsym.dequantize_soft(
        jsym.quantize_soft(np.asarray(out)[np.asarray(valid)])), _jres())

    td = TMeteor(device="cpu")
    _, (out_t, valid_t) = td(td.init_state(), torch.as_tensor(x))
    soft_syms = tsym.dequantize_soft(tsym.quantize_soft(
        out_t[valid_t].numpy()))
    frames_t, dec = tcc.deframe_qpsk_symbols(soft_syms, device="cpu")

    matched = [any(np.array_equal(f, cv) for cv in cvs) for f in frames_t]
    assert len(frames_t) >= 2 and all(matched), (len(frames_t), matched)
    assert len(frames_t) == len(frames_j)
    for a, b in zip(frames_t, frames_j):
        np.testing.assert_array_equal(a, b)
    assert len(dec.rs_errors) == len(frames_t)
