"""sdrtpu_torch's M17 frame layer and voice path against sdrtpu's.

Tolerances: the frame layer (slicer, sync, derandomizer, interleaver,
K=5 Viterbi, Golay LICH, CRC, callsigns) gives equal results: LSF
fields, frame numbers and voice bits.  The RF chain (the port's
`GfskMod` -> `Gfsk` at 48 kHz and 4800 baud, the settings of
examples/m17_voice.py) decodes what was sent in both packages.  The
vocoder tests skip without the system libcodec2, as the reference's do;
codec2's synthesis adds random phase jitter, so audio is held within
2e-3 and a correlation above 0.999 (the reference's own test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders import m17 as jm  # noqa: E402
from sdrtpu.kernels.psk import Gfsk as JGfsk  # noqa: E402
from sdrtpu_torch.decoders import m17 as tm  # noqa: E402
from sdrtpu_torch.kernels.mod import GfskMod  # noqa: E402
from sdrtpu_torch.kernels.psk import Gfsk as TGfsk  # noqa: E402

RNG = np.random.default_rng(12)
FS, BAUD, DEV = 48000.0, 4800.0, 2400.0
SPS = int(FS / BAUD)
_DIBIT_SYM = {(0, 1): 1.0, (0, 0): 1 / 3, (1, 0): -1 / 3, (1, 1): -1.0}


def _symbols(bits):
    b = np.asarray(bits, np.uint8).reshape(-1, 2)
    return np.array([_DIBIT_SYM[(int(m), int(lsb))] for m, lsb in b],
                    np.float32)


def _results(results):
    out = []
    for typ, payload in results:
        if typ == "stream":
            out.append((typ, payload[0], payload[1].tolist()))
        elif typ == "lsf":
            out.append((typ, payload))
        else:
            out.append((typ, payload.tolist()))
    return out


def _both(bits):
    ts, js = tm.M17BitSync(device="cpu"), jm.M17BitSync()
    got, want = ts.process(bits), js.process(bits)
    assert _results(got) == _results(want)
    return got, ts, js


def test_encoders_and_tables_equal():
    np.testing.assert_array_equal(tm.encode_lsf_frame("N0CALL", "SP5WWP"),
                                  jm.encode_lsf_frame("N0CALL", "SP5WWP"))
    v = RNG.integers(0, 2, 128).astype(np.uint8)
    np.testing.assert_array_equal(tm.encode_stream_frame(3, v, chunk_idx=3),
                                  jm.encode_stream_frame(3, v, chunk_idx=3))
    np.testing.assert_array_equal(tm.INTERLEAVER, jm.INTERLEAVER)
    np.testing.assert_array_equal(tm.SCRAMBLER, jm.SCRAMBLER)
    syms = np.array([1.0, 1 / 3, -1 / 3, -1.0, 0.2, -0.9])
    np.testing.assert_array_equal(tm.slice_4fsk(syms), jm.slice_4fsk(syms))
    for call in ("N0CALL", "SP5WWP", "AB1CDE/M"):
        assert tm.decode_callsign(tm.encode_callsign(call)) == call


def test_lsf_with_bit_errors():
    frame = tm.encode_lsf_frame("N0CALL", "SP5WWP").copy()
    frame[RNG.choice(tm.FRAME_BITS, 6, replace=False) + 16] ^= 1
    got, _, _ = _both(np.concatenate(
        [RNG.integers(0, 2, 23).astype(np.uint8), frame]))
    assert got[0][0] == "lsf" and got[0][1]["crc_ok"]
    assert (got[0][1]["dst"], got[0][1]["src"]) == ("N0CALL", "SP5WWP")


def test_stream_frames_and_lich_reassembly():
    lsf_bits = tm.lsf_content_bits("N0CALL", "SP5WWP")
    voices = [RNG.integers(0, 2, 128).astype(np.uint8) for _ in range(6)]
    tx = [tm.encode_stream_frame(fn, voices[fn],
                                 lich_chunk=lsf_bits[fn * 40:(fn + 1) * 40],
                                 chunk_idx=fn) for fn in range(6)]
    got, ts, js = _both(np.concatenate(tx))
    assert [p[0] for _, p in got] == list(range(6))
    for (_, (_, v)), want in zip(got, voices):
        np.testing.assert_array_equal(v, want)
    lsf = ts.decoder.lsf_from_lich()
    assert lsf == js.decoder.lsf_from_lich()
    assert lsf["crc_ok"] and lsf["src"] == "SP5WWP"


def test_rf_chain_through_gfsk():
    """An LSF and four stream frames after a random-dibit preamble (an
    alternating +3/-3 preamble leaves the M&M at a degenerate sampling
    phase in both packages, and the first frames are lost), GFSK at
    48 kHz, demodulated in two blocks."""
    lsf_bits = tm.lsf_content_bits("N0CALL", "SP5WWP")
    voices = [RNG.integers(0, 2, 128).astype(np.uint8) for _ in range(4)]
    frames = [tm.encode_lsf_frame("N0CALL", "SP5WWP")] + [
        tm.encode_stream_frame(fn, voices[fn],
                               lich_chunk=lsf_bits[fn * 40:(fn + 1) * 40],
                               chunk_idx=fn) for fn in range(4)]
    bits = np.concatenate([RNG.integers(0, 2, 480).astype(np.uint8)]
                          + frames + [np.zeros(96, np.uint8)])
    kw = dict(rrc_tap_count=4 * SPS + 1, rrc_beta=0.5)
    mod = GfskMod(SPS, DEV, FS, device="cpu", **kw)
    _, iq = mod(mod.init_state(), torch.as_tensor(_symbols(bits)))
    iq = iq.numpy()
    dem = {"port": TGfsk(BAUD, FS, DEV, omega_gain=1e-4, mu_gain=0.08,
                         device="cpu", **kw),
           "ref": JGfsk(BAUD, FS, DEV, omega_gain=1e-4, mu_gain=0.08, **kw)}
    decoded = {}
    for name, d in dem.items():
        st, syms = d.init_state(), []
        half = len(iq) // 2
        for blk in (iq[:half], iq[half:]):
            x = (torch.as_tensor(blk) if name == "port"
                 else jnp.asarray(blk))
            st, (s, v) = d(st, x)
            syms.append(np.asarray(s)[np.asarray(v)])
        sync = (tm.M17BitSync(device="cpu") if name == "port"
                else jm.M17BitSync())
        decoded[name] = _results(sync.process(
            tm.slice_4fsk(np.concatenate(syms))))
    assert decoded["port"] == decoded["ref"]
    got = decoded["port"]
    assert got[0][0] == "lsf" and got[0][1]["crc_ok"]
    assert (got[0][1]["dst"], got[0][1]["src"]) == ("N0CALL", "SP5WWP")
    assert [(r[1], r[2]) for r in got[1:]] == [
        (fn, voices[fn].tolist()) for fn in range(4)]


def test_rf_chain_example_preamble():
    """examples/m17_voice.py's transmission: the alternating +3/-3
    preamble, an LSF and eight stream frames, GFSK at 48 kHz,
    demodulated in two blocks.  The M&M's timing error is zero on an
    alternating pattern at any phase, so it starts to acquire only at
    the LSF, and both packages lose the LSF and stream frame 0; what the
    example holds is decoded all the same: every later stream frame, and
    the LSF reassembled from their LICH chunks."""
    lsf_bits = tm.lsf_content_bits("N0CALL", "SP5WWP")
    voices = [RNG.integers(0, 2, 128).astype(np.uint8) for _ in range(8)]
    frames = [tm.encode_lsf_frame("N0CALL", "SP5WWP")] + [
        tm.encode_stream_frame(fn, voices[fn], lich_chunk=lsf_bits[
            (fn % 6) * 40:(fn % 6 + 1) * 40], chunk_idx=fn % 6)
        for fn in range(8)]
    preamble = np.tile(np.array([0, 1, 1, 1], np.uint8), 240)
    bits = np.concatenate([preamble] + frames + [np.zeros(96, np.uint8)])
    kw = dict(rrc_tap_count=4 * SPS + 1, rrc_beta=0.5)
    mod = GfskMod(SPS, DEV, FS, device="cpu", **kw)
    _, iq = mod(mod.init_state(), torch.as_tensor(_symbols(bits)))
    iq = iq.numpy()
    dem = {"port": TGfsk(BAUD, FS, DEV, omega_gain=1e-4, mu_gain=0.08,
                         device="cpu", **kw),
           "ref": JGfsk(BAUD, FS, DEV, omega_gain=1e-4, mu_gain=0.08, **kw)}
    decoded, lich = {}, {}
    for name, d in dem.items():
        st, syms = d.init_state(), []
        half = len(iq) // 2
        for blk in (iq[:half], iq[half:]):
            x = (torch.as_tensor(blk) if name == "port"
                 else jnp.asarray(blk))
            st, (s, v) = d(st, x)
            syms.append(np.asarray(s)[np.asarray(v)])
        sync = (tm.M17BitSync(device="cpu") if name == "port"
                else jm.M17BitSync())
        decoded[name] = _results(sync.process(
            tm.slice_4fsk(np.concatenate(syms))))
        lich[name] = sync.decoder.lsf_from_lich()
    assert decoded["port"] == decoded["ref"]
    assert lich["port"] == lich["ref"]
    assert [(r[0], r[1], r[2]) for r in decoded["port"]] == [
        ("stream", fn, voices[fn].tolist()) for fn in range(1, 8)]
    assert lich["port"]["crc_ok"]
    assert (lich["port"]["dst"], lich["port"]["src"]) == ("N0CALL", "SP5WWP")


def test_voice_loopback_to_audio():
    from sdrtpu_torch.decoders import codec2 as tc2

    if not tc2.Codec2.available():
        pytest.skip("system libcodec2 not installed")
    t = np.arange(8 * 320) / 8000.0
    pcm = (5000 * np.sin(2 * np.pi * 200 * t)
           * np.hanning(len(t))).astype(np.int16)
    c2frames = tc2.Codec2(tc2.MODE_3200).encode(pcm)
    tx = [tm.encode_stream_frame(
        fn, np.unpackbits(np.frombuffer(c2frames[fn * 16:(fn + 1) * 16],
                                        np.uint8)), chunk_idx=fn % 6)
        for fn in range(8)]
    got, _, _ = _both(np.concatenate(tx))
    frames = [p for typ, p in got if typ == "stream"]
    audio = tm.M17Vocoder().vocode(frames)
    ref = tc2.Codec2(tc2.MODE_3200).decode(c2frames).astype(
        np.float32) / 32768.0
    assert audio.shape == ref.shape == (8 * 320,)
    np.testing.assert_allclose(audio, ref, atol=2e-3)
    assert np.corrcoef(audio, ref)[0, 1] > 0.999
    st = tm.M17Vocoder().vocode_stereo(frames)
    assert st.shape == (2, 8 * 320)


def test_vocoder_squelch_matches_reference():
    if not tm.M17Vocoder.available():
        pytest.skip("system libcodec2 not installed")
    bits = np.zeros(128, np.uint8)
    frames = [(0, bits), (1, bits), (5, bits), (6, bits)]
    a = tm.M17Vocoder().vocode(frames)
    b = jm.M17Vocoder().vocode(frames)
    assert a.shape == b.shape == (3 * 320,)
