"""sdrtpu_torch's RyFi modem against sdrtpu's.

Tolerances: the wire layer is bit-exact against
``tests/fixtures/ryfi_{payload,coded}.bin`` (generated from the
reference's own libcorrect, see tests/test_ryfi.py) and against sdrtpu;
the codec, deframer and packet layers give equal frames and packets; the
transmitter's baseband (511-tap RRC through the polyphase matmul) within
2e-6 of the peak of sdrtpu's; the RF loopback (PSK4 receive chain,
Costas and M&M as plain loops here) recovers the same packets as the
reference from the same samples.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.decoders import ryfi as jr  # noqa: E402
from sdrtpu_torch.decoders import ryfi as tr  # noqa: E402

RNG = np.random.default_rng(66)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def test_wire_golden():
    payload = np.fromfile(os.path.join(FIX, "ryfi_payload.bin"), np.uint8)
    gold = np.unpackbits(np.fromfile(os.path.join(FIX, "ryfi_coded.bin"),
                                     np.uint8))[:tr.CODED_BITS]
    codec = tr.RyfiCodec(device="cpu")
    blocks = np.stack([np.asarray(codec.rs.encode(payload[i * 223:
                                                          (i + 1) * 223]))
                       for i in range(4)])
    bits = np.concatenate([np.unpackbits(tr._interleave(blocks)
                                         ^ tr.SCRAMBLER),
                           np.zeros(8, np.uint8)])
    np.testing.assert_array_equal(codec.conv_enc.encode(bits), gold)
    frame, nerr = codec.decode_soft(1.0 - 2.0 * gold.astype(np.float32))
    assert frame is not None and nerr == 0
    np.testing.assert_array_equal(frame.serialize(), payload)
    # the whole encoder: the port's symbols are the reference's
    f = tr.Frame.deserialize(payload)
    np.testing.assert_array_equal(codec.encode_frame(f),
                                  jr.RyfiCodec().encode_frame(f))


def test_codec_with_symbol_errors_matches_reference():
    """1 % of the symbols inverted, then hard and soft decoding; both
    packages return the same frame and the same RS error count."""
    f = tr.pack_packets([b"error tolerant", b"x" * 300], counter=1)
    syms = tr.RyfiCodec(device="cpu").encode_frame(f).copy()
    idx = RNG.choice(len(syms) - 32, size=len(syms) // 100,
                     replace=False) + 32
    syms[idx] = -syms[idx]
    noisy = syms + 0.3 * (RNG.standard_normal(syms.size)
                          + 1j * RNG.standard_normal(syms.size))
    tc, jc = tr.RyfiCodec(device="cpu"), jr.RyfiCodec()
    bits = tc.symbols_to_bits(syms)
    i = tr.find_sync(bits)
    assert i == jr.find_sync(bits) == 0
    got, want = tc.decode_bits(bits[i + 64:]), jc.decode_bits(bits[i + 64:])
    assert got[1] == want[1] >= 0
    np.testing.assert_array_equal(got[0].serialize(), want[0].serialize())
    assert tr.unpack_packets(got[0]) == [b"error tolerant", b"x" * 300]
    soft = tc.symbols_to_soft(noisy[tr.SYNC_SYMS:].astype(np.complex64))
    got, want = tc.decode_soft(soft), jc.decode_soft(soft)
    assert got[1] == want[1] >= 0
    np.testing.assert_array_equal(got[0].serialize(), want[0].serialize())


@pytest.mark.parametrize("rot", [1.0, 1.0j, -1.0, -1.0j])
def test_deframer_rotations(rot):
    syms = tr.RyfiCodec(device="cpu").encode_frame(
        tr.pack_packets([b"rotated"], counter=3))
    x = np.concatenate([RNG.standard_normal(50).astype(np.complex64),
                        syms * np.complex64(rot)])
    got, want = tr.RyfiDeframer().push(x[:3000]), jr.RyfiDeframer().push(
        x[:3000])
    assert got == want == []
    td, jd = tr.RyfiDeframer(), jr.RyfiDeframer()
    got, want = td.push(x), jd.push(x)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])


def test_packet_layer_equal():
    big = bytes(RNG.integers(0, 256, 1500).astype(np.uint8))
    frames = tr.pack_stream([big, b"tail packet"], counter=10)
    jframes = jr.pack_stream([big, b"tail packet"], counter=10)
    assert len(frames) == len(jframes) == 2
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a.serialize(), b.serialize())
    ta, ja = tr.PacketReassembler(), jr.PacketReassembler()
    later = tr.pack_stream([b"after gap"], counter=20)
    got = sum((ta.push(f) for f in frames + later), [])
    want = sum((ja.push(f) for f in frames + later), [])
    assert got == want == [big, b"tail packet", b"after gap"]


def test_rf_loopback_two_frames():
    """An idle frame (lock time) and one frame with two packets, at
    20 kbaud and 4 samples a symbol, Es/N0 8 dB, 100 Hz offset, 0.7 rad
    (examples/ryfi_link.py's channel); the port's transmitter, then both
    receivers on the same samples."""
    baud, fs = 20000.0, 80000.0
    tx, jtx = tr.RyfiTransmitter(baud, fs, device="cpu"), jr.RyfiTransmitter(
        baud, fs)
    idle = tx.idle()
    np.testing.assert_allclose(idle, jtx.idle(),
                               atol=2e-6 * np.abs(idle).max())
    bb = np.concatenate([idle, tx.send([b"hello ryfi", b"wire parity"])])
    rng = np.random.default_rng(3)
    es = np.mean(np.abs(bb) ** 2) * (fs / baud)
    sigma = np.sqrt(es / 10 ** (8.0 / 10.0) / 2)
    t = np.arange(bb.size + 1000) / fs
    bb = np.concatenate([bb, np.zeros(1000, np.complex64)])
    y = (bb * np.exp(1j * (0.7 + 2 * np.pi * 100.0 * t))
         + sigma * (rng.standard_normal(bb.size)
                    + 1j * rng.standard_normal(bb.size))).astype(np.complex64)
    B = y.size // 4
    out = {}
    for name, rx in (("port", tr.RyfiReceiver(baud, fs, device="cpu")),
                     ("ref", jr.RyfiReceiver(baud, fs))):
        pkts = []
        for i in range(4):
            pkts += rx.process(y[i * B:(i + 1) * B])
        out[name] = (pkts, rx.frames_decoded, rx.frames_failed)
    assert out["port"] == out["ref"]
    assert out["port"][0] == [b"hello ryfi", b"wire parity"]
