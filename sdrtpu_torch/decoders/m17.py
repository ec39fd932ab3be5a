"""M17 digital voice frame layer (PyTorch counterpart of
``sdrtpu/decoders/m17.py``; ``decoder_modules/m17_decoder`` capability).

Implements the M17 protocol's bit layer per the public M17 specification:

- 4FSK dibit slicing (sym +3,+1,-1,-3 -> bits, high cut at (1+1/3)/2 like
  the reference's ``M17Slice4FSK``),
- frame sync (LSF / stream / packet sync words, 16 bits),
- derandomizer (the spec's 46-byte sequence) and QPP interleaver
  pi(x) = (45x + 92x^2) mod 368 (generated from the formula; the
  reference ships the expanded table),
- LSF path: depuncture P1 -> rate-1/2 K=5 Viterbi (polys 0o31, 0o27) ->
  240-bit link setup frame -> base-40 callsigns + CRC16,
- stream path: LICH (4 x Golay(24,12)) reassembly + payload depuncture P2
  -> Viterbi -> frame number + 128 voice bits,
- voice synthesis: `M17Vocoder` feeds the 2x 8-byte codec2 3200 frames
  per stream frame through the system libcodec2 binding
  (`decoders/codec2.py`) — the same library the reference links
  (``m17_decoder/CMakeLists.txt:27``, decode at ``m17dsp.h:509-510``) —
  with the reference's consecutive-frame-number squelch.

The frame layer is the reference's host numpy, copied as it is; the
K=5 Viterbi runs on the decoder's device (one `viterbi_decode` launch a
frame on the card), the Golay code on the host (``fec/``).
"""

from __future__ import annotations

import numpy as np

from ..fec.golay import Golay24, encode24
from ..fec.viterbi import ConvEncoder, ViterbiDecoder

SYNC_LSF = np.array([0,1,0,1,0,1,0,1,1,1,1,1,0,1,1,1], np.uint8)
SYNC_STREAM = np.array([1,1,1,1,1,1,1,1,0,1,0,1,1,1,0,1], np.uint8)
SYNC_PACKET = np.array([0,1,1,1,0,1,0,1,1,1,1,1,1,1,1,1], np.uint8)

FRAME_BITS = 368  # payload bits per frame after the sync word
LSF_BITS = 240
ENC_LSF_BITS = 488
LICH_BITS = 96
PAYLOAD_ENC_BITS = 272
ENC_PAYLOAD_BITS = 296
PAYLOAD_BITS = 144

# M17 randomizer (spec section "Randomizer"): 46 bytes
_RANDOMIZER_BYTES = bytes([
    0xD6, 0xB5, 0xE2, 0x30, 0x82, 0xFF, 0x84, 0x62, 0xBA, 0x4E,
    0x96, 0x90, 0xD8, 0x98, 0xDD, 0x5D, 0x0C, 0xC8, 0x52, 0x43,
    0x91, 0x1D, 0xF8, 0x6E, 0x68, 0x2F, 0x35, 0xDA, 0x14, 0xEA,
    0xCD, 0x76, 0x19, 0x8D, 0xD5, 0x80, 0xD1, 0x33, 0x87, 0x13,
    0x57, 0x18, 0x2D, 0x29, 0x78, 0xC3,
])
SCRAMBLER = np.unpackbits(np.frombuffer(_RANDOMIZER_BYTES, np.uint8))[:FRAME_BITS]

# QPP interleaver pi(x) = (45x + 92x^2) mod 368
INTERLEAVER = np.array(
    [(45 * x + 92 * x * x) % FRAME_BITS for x in range(FRAME_BITS)], np.int32
)

# puncturing patterns (M17 spec P1/P2): P1 is the 61-entry sequence
# 1,1 then repeating 1,1,0,1 phase-aligned so entries at i%4==2 are 0
P1 = np.array([1, 1] + [1 if (i % 4) != 2 else 0 for i in range(2, 61)], np.uint8)
P2 = np.array([1] * 11 + [0], np.uint8)

M17_POLYS = (0b11001, 0b10111)  # G1 = x4+x3+1, G2 = x4+x2+x+1 (K=5)

BASE40 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."


def _crc16(data: bytes) -> int:
    """M17 CRC16 (poly 0x5935, init 0xFFFF)."""
    crc = 0xFFFF
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x5935) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def encode_callsign(call: str) -> int:
    v = 0
    for ch in reversed(call.upper()):
        v = v * 40 + max(BASE40.find(ch), 0)
    return v


def decode_callsign(value: int) -> str:
    if value == 0xFFFFFFFFFFFF:
        return "@ALL"
    out = []
    while value:
        out.append(BASE40[value % 40])
        value //= 40
    return "".join(out)


def slice_4fsk(symbols: np.ndarray) -> np.ndarray:
    """float symbols (normalized +/-1, +/-1/3) -> dibits (2 bits/symbol).

    M17 mapping: +3 -> 01, +1 -> 00, -1 -> 10, -3 -> 11 (msb = sign).
    High cut at (1 + 1/3)/2 like the reference slicer.
    """
    cut = (1.0 + 1.0 / 3.0) / 2.0 / 2.0  # symbols normalized to +/-1, +/-1/3
    s = np.asarray(symbols, np.float64)
    msb = (s < 0).astype(np.uint8)
    lsb = (np.abs(s) > cut * 2.0).astype(np.uint8)
    bits = np.empty(s.size * 2, np.uint8)
    bits[0::2] = msb
    bits[1::2] = lsb
    return bits


def _depuncture(bits: np.ndarray, pattern: np.ndarray, out_len: int) -> np.ndarray:
    out = np.zeros(out_len, np.float32)
    j = 0
    for i in range(out_len):
        if pattern[i % len(pattern)]:
            out[i] = 1.0 - 2.0 * float(bits[j])  # bit -> soft (+1 = 0)
            j += 1
    return out


def _puncture(bits: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    return np.array(
        [b for i, b in enumerate(bits) if pattern[i % len(pattern)]], np.uint8
    )


class M17FrameDecoder:
    """Feed frame bits (368 per frame, post-sync); emits decoded content."""

    def __init__(self, device="cuda"):
        self.viterbi = ViterbiDecoder(5, M17_POLYS, device=device)
        self.golay = Golay24()
        self.lsf = None          # dict with callsigns once decoded
        self.stream_frames = []  # (frame_number, voice_bits (128,))
        self.lich_chunks = [None] * 6

    # -- frame paths -------------------------------------------------------
    def _deinterleave_derandomize(self, bits: np.ndarray) -> np.ndarray:
        bits = np.asarray(bits, np.uint8) ^ SCRAMBLER
        out = np.zeros(FRAME_BITS, np.uint8)
        out[INTERLEAVER] = bits  # reference writes buf[interleaver[i]] = in[i]
        return out

    def decode_lsf_frame(self, bits: np.ndarray) -> dict | None:
        data = self._deinterleave_derandomize(bits)
        soft = _depuncture(data[:FRAME_BITS], P1, ENC_LSF_BITS)
        decoded = self.viterbi.decode(soft)[:LSF_BITS].cpu().numpy()
        return self._parse_lsf(decoded)

    def _parse_lsf(self, lsf_bits: np.ndarray) -> dict | None:
        by = np.packbits(lsf_bits)
        dst = int.from_bytes(by[0:6], "big")
        src = int.from_bytes(by[6:12], "big")
        type_field = int.from_bytes(by[12:14], "big")
        crc = int.from_bytes(by[28:30], "big")
        ok = _crc16(bytes(by[:28])) == crc
        out = {
            "dst": decode_callsign(dst),
            "src": decode_callsign(src),
            "type": type_field,
            "crc_ok": bool(ok),
        }
        if ok:
            self.lsf = out
        return out

    def decode_stream_frame(self, bits: np.ndarray) -> tuple[int, np.ndarray] | None:
        data = self._deinterleave_derandomize(bits)
        lich = data[:LICH_BITS]
        payload = data[LICH_BITS : LICH_BITS + PAYLOAD_ENC_BITS]
        # LICH: 4 golay words of 24 bits -> 48 bits
        chunk_bits = []
        for w in range(4):
            word = 0
            for b in lich[w * 24 : (w + 1) * 24]:
                word = (word << 1) | int(b)
            data12, nerr = self.golay.decode24(word)
            if data12 is None:
                chunk_bits = None
                break
            chunk_bits.extend((data12 >> (11 - i)) & 1 for i in range(12))
        if chunk_bits is not None:
            cb = np.asarray(chunk_bits, np.uint8)
            idx = (cb[40] << 2) | (cb[41] << 1) | cb[42]
            if idx < 6:
                self.lich_chunks[idx] = cb[:40]

        soft = _depuncture(payload, P2, ENC_PAYLOAD_BITS)
        decoded = self.viterbi.decode(soft)[:PAYLOAD_BITS].cpu().numpy()
        by = np.packbits(decoded)
        fn = int.from_bytes(by[0:2], "big")
        voice = decoded[16:144]
        self.stream_frames.append((fn, voice))
        return fn, voice

    def lsf_from_lich(self) -> dict | None:
        """Reassemble the LSF from collected LICH chunks (mid-stream join).

        Each stream frame carries 40 of the LSF's 240 bits plus a chunk
        index; once all six chunks have been seen the full link setup
        frame parses exactly like the dedicated LSF frame.
        """
        if any(c is None for c in self.lich_chunks):
            return None
        bits = np.concatenate(self.lich_chunks)
        return self._parse_lsf(bits)


# -- encode path (tests / tx) ----------------------------------------------

def _interleave_randomize(bits: np.ndarray) -> np.ndarray:
    out = bits[INTERLEAVER]  # inverse of decoder's scatter
    return out ^ SCRAMBLER


def lsf_content_bits(dst: str, src: str, type_field: int = 0x0005) -> np.ndarray:
    """240-bit link-setup-frame content (callsigns, type, CRC16).

    Also the payload carried 40 bits at a time in the stream frames'
    LICH chunks, letting receivers that missed the LSF frame recover the
    link info mid-stream (M17 spec; the reference decodes LICH-borne LSF
    in ``m17dsp.h``'s LICH path)."""
    by = bytearray(30)
    by[0:6] = encode_callsign(dst).to_bytes(6, "big")
    by[6:12] = encode_callsign(src).to_bytes(6, "big")
    by[12:14] = type_field.to_bytes(2, "big")
    crc = _crc16(bytes(by[:28]))
    by[28:30] = crc.to_bytes(2, "big")
    return np.unpackbits(np.frombuffer(bytes(by), np.uint8))[:LSF_BITS]


def encode_lsf_frame(dst: str, src: str, type_field: int = 0x0005) -> np.ndarray:
    lsf_bits = lsf_content_bits(dst, src, type_field)
    enc = ConvEncoder(5, M17_POLYS)
    # terminated encoding: encoder state flushed by 4 trailing zeros
    coded = enc.encode(np.concatenate([lsf_bits, np.zeros(4, np.uint8)]))[
        :ENC_LSF_BITS
    ]
    punct = _puncture(coded, P1)
    frame = np.zeros(FRAME_BITS, np.uint8)
    frame[: len(punct)] = punct[:FRAME_BITS]
    return np.concatenate([SYNC_LSF, _interleave_randomize(frame)])


def encode_stream_frame(fn: int, voice_bits: np.ndarray,
                        lich_chunk: np.ndarray | None = None,
                        chunk_idx: int = 0) -> np.ndarray:
    payload_bits = np.concatenate([
        np.unpackbits(np.frombuffer(int(fn).to_bytes(2, "big"), np.uint8)),
        np.asarray(voice_bits, np.uint8),
    ])
    assert len(payload_bits) == PAYLOAD_BITS
    enc = ConvEncoder(5, M17_POLYS)
    coded = enc.encode(np.concatenate([payload_bits, np.zeros(4, np.uint8)]))[
        :ENC_PAYLOAD_BITS
    ]
    punct = _puncture(coded, P2)[:PAYLOAD_ENC_BITS]

    if lich_chunk is None:
        lich_chunk = np.zeros(40, np.uint8)
    cb = np.concatenate([
        np.asarray(lich_chunk, np.uint8),
        np.array([(chunk_idx >> 2) & 1, (chunk_idx >> 1) & 1, chunk_idx & 1],
                 np.uint8),
        np.zeros(5, np.uint8),
    ])
    lich_bits = []
    for w in range(4):
        data12 = 0
        for b in cb[w * 12 : (w + 1) * 12]:
            data12 = (data12 << 1) | int(b)
        cw = encode24(data12)
        lich_bits.extend((cw >> (23 - i)) & 1 for i in range(24))
    frame = np.concatenate([
        np.asarray(lich_bits, np.uint8), punct,
    ])
    assert len(frame) == FRAME_BITS
    return np.concatenate([SYNC_STREAM, _interleave_randomize(frame)])


class M17BitSync:
    """Bit-stream framer: finds sync words, emits (type, 368 bits)."""

    def __init__(self, decoder: M17FrameDecoder | None = None,
                 device="cuda"):
        self.decoder = decoder or M17FrameDecoder(device=device)
        self._buf: list[int] = []

    def process(self, bits: np.ndarray) -> list[tuple[str, object]]:
        self._buf.extend(int(b) for b in np.asarray(bits, np.uint8))
        results = []
        i = 0
        buf = self._buf
        while i + 16 + FRAME_BITS <= len(buf):
            w = np.asarray(buf[i : i + 16], np.uint8)
            ftype = None
            if np.array_equal(w, SYNC_LSF):
                ftype = "lsf"
            elif np.array_equal(w, SYNC_STREAM):
                ftype = "stream"
            elif np.array_equal(w, SYNC_PACKET):
                ftype = "packet"
            if ftype is None:
                i += 1
                continue
            frame = np.asarray(buf[i + 16 : i + 16 + FRAME_BITS], np.uint8)
            if ftype == "lsf":
                results.append(("lsf", self.decoder.decode_lsf_frame(frame)))
            elif ftype == "stream":
                results.append(
                    ("stream", self.decoder.decode_stream_frame(frame))
                )
            else:
                results.append(("packet", frame))
            i += 16 + FRAME_BITS
        del buf[:i]
        return results


class M17Vocoder:
    """Stream-frame voice bits -> audio PCM via the system codec2.

    Mirrors ``M17Codec2Decode`` (``m17dsp.h:429-525``): each 128-bit
    stream payload is two 8-byte codec2 3200 frames decoded to 2x160
    samples at 8 kHz; output only while frame numbers run consecutively
    (the reference additionally times out on wall clock — meaningless in
    offline processing, so here non-consecutive input just re-arms).
    Construction raises if libcodec2 is absent; gate on
    `M17Vocoder.available()`.
    """

    SAMPLERATE = 8000.0

    def __init__(self):
        from .codec2 import MODE_3200, Codec2

        self.codec = Codec2(MODE_3200)
        self.last_fn: int | None = None

    @staticmethod
    def available() -> bool:
        from .codec2 import Codec2

        return Codec2.available()

    def vocode(self, frames) -> np.ndarray:
        """[(fn, voice_bits(128,)), ...] -> float32 mono PCM @ 8 kHz.

        First frame of a transmission always plays (the reference arms on
        the first consecutive pair; offline we cannot wait for the next
        frame before emitting this one, and dropping it would lose 40 ms
        of speech per over).
        """
        out = []
        for fn, bits in frames:
            fn = int(fn)
            consecutive = (
                self.last_fn is None
                or ((fn - self.last_fn) % 0x8000) == 1
            )
            self.last_fn = fn & 0x7FFF  # bit 15 = end-of-stream marker
            if not consecutive:
                continue
            by = np.packbits(np.asarray(bits, np.uint8)).tobytes()  # 16 B
            pcm = self.codec.decode(by)  # 2 frames -> 320 samples
            out.append(pcm.astype(np.float32) / 32768.0)
        if not out:
            return np.zeros(0, np.float32)
        return np.concatenate(out)

    def vocode_stereo(self, frames) -> np.ndarray:
        """Like `vocode` but duplicated to (2, n) stereo — the reference
        interleaves the mono signal into both channels (m17dsp.h:517)."""
        mono = self.vocode(frames)
        return np.stack([mono, mono])
