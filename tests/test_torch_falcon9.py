"""sdrtpu_torch's Falcon 9 telemetry decoder against sdrtpu's.

Tolerances: the host layers (dual-basis tables, RS frames, packet
reassembly, ASM deframer) are copies and must give equal bytes.  The
demodulator (`Quadrature` -> float `MuellerMuller`), two streamed
blocks from one converted state: valid counts equal, the hard bits
equal, and ``isclose(atol=2e-2)`` on more than 99.5 % of the soft
symbols, the thresholds of tests/test_torch_psk.py for a closed loop
(the discriminator's atan2 differs by an ulp between the packages, and
where the M&M's phase sits at a bank-phase boundary the interpolator
takes the neighbouring phase); the carried offset equal, phase and
frequency within 1e-3.  The whole chain: the same packets,
payload-exact.

One intended divergence: the port's RS puts libcorrect's (120, 11)
roots at ``alpha^(11 (120 + j))``, sdrtpu's at ``alpha^(120 + 11 j)``.
sdrtpu's side is given the same code as first root ``11 * 120 mod 255``
(`_jrs`) wherever it encodes or decodes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders import falcon9 as jf  # noqa: E402
from sdrtpu.fec.reed_solomon import ReedSolomon as JRs  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.decoders import falcon9 as tf  # noqa: E402

RNG = np.random.default_rng(11)


def _jrs():
    """sdrtpu's RS set to the port's (libcorrect's) code."""
    return JRs(nroots=tf.RS_ROOTS, prim_poly=0x187, fcr=(11 * 120) % 255,
               prim=11)


def _frame_data(counter, pointer, body):
    hdr = bytes([(counter >> 13) & 0x3F, (counter >> 5) & 0xFF,
                 ((counter & 0x1F) << 3) | ((pointer >> 8) & 0x7),
                 pointer & 0xFF])
    body = body[:tf.FRAME_DATA_LEN].ljust(tf.FRAME_DATA_LEN, b"\x00")
    return np.frombuffer(hdr + body, np.uint8)


def _packet(pkt_id, payload):
    length = 10 + len(payload)
    return bytes([((length - 2) >> 8) & 0x0F, (length - 2) & 0xFF]
                 ) + pkt_id.to_bytes(8, "big") + payload


def _capture(fs, frames, sps=4):
    """NRZ FSK of ASM + RS-coded frames, phase accumulated per sample."""
    parts = [RNG.integers(0, 2, 400).astype(np.uint8)]
    for data in frames:
        fbits = np.unpackbits(jf.rs_frame_encode(data, _jrs()))
        parts += [jf._ASM_PATTERN, fbits,
                  np.zeros(jf.FRAME_BITS - fbits.size, np.uint8)]
    parts.append(RNG.integers(0, 2, 120).astype(np.uint8))
    sym = np.repeat(2.0 * np.concatenate(parts).astype(np.float32) - 1.0,
                    sps)
    return np.exp(1j * np.cumsum(2 * np.pi * jf.DEVIATION / fs * sym)
                  ).astype(np.complex64)


def test_tables_and_constants_equal():
    np.testing.assert_array_equal(tf.TO_DUAL, jf.TO_DUAL)
    np.testing.assert_array_equal(tf.FROM_DUAL, jf.FROM_DUAL)
    np.testing.assert_array_equal(tf._rand255(3000), jf._rand255(3000))
    assert (tf.SAMPLERATE, tf.DEVIATION, tf.BAUDRATE) == (
        jf.SAMPLERATE, jf.DEVIATION, jf.BAUDRATE)


def test_rs_frames_equal_with_errors():
    data = RNG.integers(0, 256, tf.DATA_BYTES).astype(np.uint8)
    code = tf.rs_frame_encode(data)
    np.testing.assert_array_equal(code, jf.rs_frame_encode(data, _jrs()))
    # libcorrect's (120, 11): roots alpha^(11 j), j = 120 .. 135, a
    # generator that reads the same both ways; sdrtpu's default is not it
    g = [int(c) for c in tf._falcon_rs().genpoly]
    assert g == g[::-1]
    assert not np.array_equal(code, jf.rs_frame_encode(data))
    bad = code.copy()
    # 6 byte errors in each of the 5 interleaved codewords (8 correctable)
    idx = np.concatenate([RNG.choice(255, 6, replace=False) * 5 + lane
                          for lane in range(5)])
    bad[idx] ^= RNG.integers(1, 256, idx.size).astype(np.uint8)
    got, want = tf.rs_frame_decode(bad), jf.rs_frame_decode(bad, _jrs())
    assert got[1] == want[1] > 0
    np.testing.assert_array_equal(got[0], data)


def test_packet_sync_equal():
    big = _packet(0xABCDEF0011223344,
                  bytes(RNG.integers(0, 256, 1500, dtype=np.uint8)))
    frames = [_frame_data(5, 0, big[:tf.FRAME_DATA_LEN]),
              _frame_data(6, len(big) - tf.FRAME_DATA_LEN,
                          big[tf.FRAME_DATA_LEN:] + _packet(0x01, b"x")),
              _frame_data(9, 0, _packet(0x77, b"ok"))]
    ts, js = tf.FalconPacketSync(), jf.FalconPacketSync()
    for f in frames:
        got, want = ts.process(f), js.process(f)
        assert [(p.pkt_id, p.payload) for p in got] == [
            (p.pkt_id, p.payload) for p in want]


def test_demod_streams_like_the_reference():
    fs = 6e6
    x = _capture(fs, [_frame_data(1, 0, _packet(tf.PKT_TLM, b"T"))])
    jd, td = jf.FalconDemod(fs), tf.FalconDemod(fs, device="cpu")
    sj = jd.init_state()
    st = state_from_jax(sj, "cpu")
    for blk in (x[:20000], x[20000:]):
        sj, (ys, yv) = jd(sj, jnp.asarray(blk))
        st, (ts_, tv) = td(st, torch.as_tensor(blk))
        ys, yv = np.asarray(ys), np.asarray(yv)
        np.testing.assert_array_equal(tv.numpy(), yv)
        got, want = ts_.numpy()[yv], ys[yv]
        np.testing.assert_array_equal(got > 0, want > 0)
        assert np.isclose(got, want, atol=2e-2).mean() > 0.995
    assert int(st["mm"]["offset"]) == int(sj["mm"]["offset"])
    np.testing.assert_allclose(float(st["mm"]["phase"]),
                               float(sj["mm"]["phase"]), atol=1e-3)
    np.testing.assert_allclose(float(st["mm"]["freq"]),
                               float(sj["mm"]["freq"]), atol=1e-3)


def test_iq_to_packets_at_the_published_rate():
    """6 Msps, 3.5714 Mbaud (sps 1.68): the NRZ phase accumulated at
    t = k / fs; three frames in three blocks; both packages decode the
    same packets."""
    fs = tf.SAMPLERATE
    baud = tf.BAUDRATE
    frames = [_frame_data(100 + i, 0, _packet(tf.PKT_TLM, b"STAGE2 %d" % i)
                          + _packet(tf.PKT_GPS_TEXT[0], b"GPS %d" % i))
              for i in range(3)]
    bits = [RNG.integers(0, 2, 400).astype(np.uint8)]
    for data in frames:
        fbits = np.unpackbits(jf.rs_frame_encode(data, _jrs()))
        bits += [jf._ASM_PATTERN, fbits,
                 np.zeros(jf.FRAME_BITS - fbits.size, np.uint8)]
    bits.append(RNG.integers(0, 2, 200).astype(np.uint8))
    nrz = 2.0 * np.concatenate(bits) - 1.0
    k = np.arange(int(len(nrz) * fs / baud))
    sym = nrz[np.minimum((k * baud / fs).astype(np.int64), len(nrz) - 1)]
    iq = np.exp(1j * np.cumsum(2 * np.pi * jf.DEVIATION / fs * sym)
                ).astype(np.complex64)
    out = {}
    ref = jf.Falcon9Decoder(fs)
    ref.rs = _jrs()
    for name, dec in (("ref", ref),
                      ("port", tf.Falcon9Decoder(fs, device="cpu"))):
        pk = []
        for chunk in np.array_split(iq, 3):
            pk += dec.process(chunk.copy())
        out[name] = [(p.pkt_id, p.payload) for p in pk]
        assert dec.deframer.frames_seen == 3 and dec.rs_failures == 0
    assert out["port"] == out["ref"]
    assert out["port"] == [(tf.PKT_TLM, b"STAGE2 %d" % i) if j == 0 else
                           (tf.PKT_GPS_TEXT[0], b"GPS %d" % i)
                           for i in range(3) for j in range(2)]
