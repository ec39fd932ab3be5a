"""RyFi data modem — wire-compatible codec + streaming RF RX/TX (PyTorch
counterpart of ``sdrtpu/decoders/ryfi.py``; ``decoder_modules/ryfi_decoder``
capability).

SDR++'s experimental QPSK packet modem.  Wire format (all verified
bit-exact against a golden stream generated from the reference's own
vendored libcorrect — see tests/test_ryfi.py::test_wire_golden):

    Packet(s) -> Frame(counter, firstPacket, lastPacket, 886B data)
                 (``ryfi/frame.cpp:4-22``: big-endian u16 header fields)
      -> RS(255,223) x 4, CCSDS poly 0x187 fcr=1 prim=1
         (``ryfi/rs_codec.cpp:4-9``), blocks byte-INTERLEAVED into the
         1020-byte frame: block i byte k -> position i + 4k
         (``ryfi/rs_codec.cpp:27-32``)
      -> XOR with the 1020-byte scrambler sequence
         (``ryfi/rs_codec.cpp:35-38``)
      -> rate-1/2 K=7 convolutional encode, libcorrect conventions:
         polys {0o161, 0o127} with newest-bit-at-LSB register (equal to
         {0o107, 0o165} in this module's newest-at-MSB tables), p0 then
         p1 per input bit, 8 zero flush bits
         (``libcorrect convolutional/encode.c:34-56``) -> 16336 coded
         bits packed MSB-first
      -> QPSK, 2 bits MSB-first per symbol: pair MSB -> Re, LSB -> Im,
         bit 1 -> positive (``ryfi/framing.cpp:4-35``)
      -> 32-symbol sync from the 64-bit SYNC_WORD + 8168 data symbols
         = 8200 symbols/frame (``ryfi/framing.cpp:129`` recv=8168)

The scrambler sequence is an opaque wire-format constant: the
reference ships it as a literal table with no generator
(``ryfi/rs_codec.cpp:103``), and a Berlekamp–Massey scan of its
bitstream finds no LFSR structure (linear complexity ~n/2, i.e. random
bytes), so — like the sync word — the sequence itself IS the wire
constant and is embedded below for interoperability.

RF layer: `RyfiTransmitter` (frames -> RRC-shaped baseband,
``ryfi/transmitter.cpp:4-23``: zero-stuffing resampler + 511-tap
beta-0.6 unit-DC-gain RRC) and `RyfiReceiver` (PSK4 demod -> rotation-
searching deframer -> Viterbi -> RS -> packet reassembly,
``ryfi/receiver.h:55-64`` + ``receiver.cpp:72-193``).

In the port the wire layer, the deframer and the packet layer are the
reference's host numpy, copied as they are.  On the chain's device run
the transmitter's `RrcInterpolator`, the receiver's `Psk` (on the card
one `costas_scan` and one `mm_scan` launch a block) and the K=7 Viterbi
(one `viterbi_decode` launch a frame); Reed-Solomon runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fec.reed_solomon import ReedSolomon
from ..fec.viterbi import ConvEncoder, ViterbiDecoder

SYNC_WORD = 0x341CC540819D8963
SYNC_BITS = 64
SYNC_SYMS = SYNC_BITS // 2
RS_BLOCKS = 4
RS_N, RS_K = 255, 223
FRAME_SIZE = RS_K * RS_BLOCKS          # 892 bytes of frame payload
FRAME_DATA_SIZE = FRAME_SIZE - 6       # 886 data bytes
ENC_FRAME_BYTES = RS_N * RS_BLOCKS     # 1020 after RS
CONV_K = 7
# libcorrect's correct_conv_r12_7_polynomial {0o161, 0o127} uses a
# newest-bit-at-LSB shift register (encode.c:36-38); this module's FEC
# tables put the newest bit at the MSB, so the same code is the
# bit-reversed pair.
CONV_POLYS = (0o107, 0o165)
CONV_FLUSH_BITS = CONV_K + 1           # order+1 zero tail (encode.c:50-56)
DATA_BITS = ENC_FRAME_BYTES * 8
CODED_BITS = 2 * (DATA_BITS + CONV_FLUSH_BITS)   # 16336
FRAME_SYMS = CODED_BITS // 2                     # 8168
TOTAL_FRAME_SYMS = SYNC_SYMS + FRAME_SYMS        # 8200

# Wire-format constant (``ryfi/rs_codec.cpp:103``): 1020 opaque bytes
# XORed over the interleaved RS frame.  No generator exists (see module
# docstring); must match byte-for-byte for over-the-air interop.
_WIRE_SCRAMBLER_HEX = (
    "75057ccef1d06cf6fa65f6fce00a82176cbe76a0d646122edeb5f7adcb516347"
    "27307e43d1a1cb100849df86d4c4d73c6d0307375bb3cd796f1ebac56ec38c7a"
    "259961545a96579be0605b096d8b2d9d159d0ebf57fb9c49822c485992477917"
    "1674eaeabbc5723217d1b3deeb15c7558af288c233a6178bd47722006347455f"
    "3635588b88eccac460539ebdb2f55146349a07253ff56563773c5afa4e0cf71b"
    "82ab73067fb7c66bbfb146f30191b1ff5c6ff9430e6a70890bea8cd41b510131"
    "712edf24c1d5db0ef5eb7879395badc3a9a66030a29a7ba0f4aac557b316f9b5"
    "7920c1889a0043b2c6848d03f2d8907a21377ef775e5fbc9dcab4bbc3538b93a"
    "53897ed594122d9b91901d4d0ee093f3c1a19b7327224127ee2ad745bc8f9ba2"
    "361116371af12e71cf8689835af1246c567153e4d2cbca861ea0d5833bef0909"
    "c2075386e68ac670fb9143cb916ea9bc3142610c88b82cedd8e6a3ecacb9455e"
    "2c733f2e06e0bf73dd2e45506c5355f07f6e61faa07a1cf0bdac4861036bed54"
    "2a2794f6f96a04080b3cc3306601fbdcc96503837d0adfa50414e4f24c01df04"
    "d280b99bd95ef82a938d8c099b38ec3bc429907c653af24b69d3639b4095c3fb"
    "6754409b269f52fed8d0249c5cd4efde28667504cba4c0b94bc9204b56c786c5"
    "394518a748141a51cad0c015ddc1284a7ad210ea83d33aef482941a4d457a61d"
    "762493587eb7dd0bf2ce7155f5ab8cc8705973699d295e59f4b2c49775f0651b"
    "665fa4335cc7bf45e620c0bdadae9f9705d8042b0a46e8b8cb00e27c701b49de"
    "81eb24ac1b3e09fbacb7f2d1b278f3acc76aa2074ced61ad047f4583593127f0"
    "166b0caad4d1cb1c51410d2f8ff9f97f228946f4b893989e3e23f16e6408b6c9"
    "6e5353edad21cd1af045fc1400eaf742eeda580d85bc74fb7378b55e5e6f6f7e"
    "39c20550db3db8f38f80ec46293989f3559c6a5f7cd97c13e4565ee96019e27d"
    "c441928dda215820e9a84c163499acb730bd3919ac9b4b27fa32c148a1803436"
    "1efb924335722defd2f2fcc285ab59408d9d1a1fe29287a2f92c78e4c3265607"
    "b378af793d88f4ad667c075898821a26f7fdceff75edabbdae6d5c2891f3b75c"
    "2705ec3be3dd93247fad14aa49618f961faab2eea824417cdcf12826e67f9820"
    "505f90218a092659d0072fe1354d0b20b2d5ddb5ac1bfed9e335f1b83f3dfc0b"
    "5a57a9922bc83ec2aaefb9982ca8abf6a1bfbc8d97a274d9e599858115b0e78b"
    "4886f4949c6282d12c244bac7ab84e4ad2f6aaede09c98d2dfc1bcbf557d40b5"
    "ded425bb81f4071de73cb462c9550a3ad5ce97ed30767651bc8ce454beb7b5cd"
    "f87637532c9fe4c7ebf58d238adad1a9d84c53f349a71a5de5034952d3e21fa5"
    "359cbb0bc70da465548b39f13b67217110e776c4a8c29d93c651ba23"
)


def _wire_scrambler() -> np.ndarray:
    h = "".join(_WIRE_SCRAMBLER_HEX.split())
    seq = np.frombuffer(bytes.fromhex(h), np.uint8)
    assert seq.size == ENC_FRAME_BYTES
    return seq


SCRAMBLER = _wire_scrambler()

# QPSK mapping (``ryfi/framing.cpp:4-9``): 2-bit code b -> symbol with
# Re = +1 if b&2 else -1, Im = +1 if b&1 else -1 (unit amplitude here;
# the reference scales by 0.1, irrelevant after AGC).
_QPSK = np.array(
    [(-1 - 1j), (-1 + 1j), (1 - 1j), (1 + 1j)], np.complex64
) / np.sqrt(2.0)


def _sync_bits() -> np.ndarray:
    return np.array(
        [(SYNC_WORD >> (SYNC_BITS - 1 - i)) & 1 for i in range(SYNC_BITS)],
        np.uint8,
    )


def _bits_to_syms(bits: np.ndarray) -> np.ndarray:
    """MSB-first bit pairs -> QPSK symbols (pair MSB -> Re, 1 -> +)."""
    b = np.asarray(bits, np.uint8)
    code = (b[0::2] << 1) | b[1::2]
    return _QPSK[code]


def _syms_to_code(syms: np.ndarray) -> np.ndarray:
    """Hard 2-bit decisions (``framing.cpp:106``)."""
    return ((np.real(syms) > 0).astype(np.uint8) << 1) | (
        np.imag(syms) > 0
    ).astype(np.uint8)


def _interleave(blocks: np.ndarray) -> np.ndarray:
    """(RS_BLOCKS, RS_N) encoded blocks -> 1020-byte wire order.

    Block i byte k lands at position i + RS_BLOCKS*k
    (``rs_codec.cpp:27-32``).
    """
    return np.ascontiguousarray(blocks.T).reshape(-1)


def _deinterleave(frame: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(frame.reshape(RS_N, RS_BLOCKS).T)


class Frame:
    """Frame header + payload (``ryfi/frame.cpp:4-38``)."""

    def __init__(self, counter=0, first_packet=0xFFFF, last_packet=0xFFFF,
                 content=None):
        self.counter = counter
        self.first_packet = first_packet
        self.last_packet = last_packet
        self.content = (
            np.zeros(FRAME_DATA_SIZE, np.uint8) if content is None else content
        )

    def serialize(self) -> np.ndarray:
        out = np.zeros(FRAME_SIZE, np.uint8)
        out[0:2] = divmod(self.counter, 256)
        out[2:4] = divmod(self.first_packet, 256)
        out[4:6] = divmod(self.last_packet, 256)
        out[6:] = self.content
        return out

    @classmethod
    def deserialize(cls, data: np.ndarray) -> "Frame":
        d = np.asarray(data, np.uint8)
        return cls(
            counter=int(d[0]) << 8 | int(d[1]),
            first_packet=int(d[2]) << 8 | int(d[3]),
            last_packet=int(d[4]) << 8 | int(d[5]),
            content=d[6:FRAME_SIZE].copy(),
        )


class RyfiCodec:
    """Frame bytes <-> QPSK symbol stream (wire-exact, see module doc);
    the Viterbi decodes on ``device``."""

    def __init__(self, device="cuda"):
        self.rs = ReedSolomon(nroots=32, prim_poly=0x187, fcr=1, prim=1)
        self.conv_enc = ConvEncoder(CONV_K, CONV_POLYS)
        self.viterbi = ViterbiDecoder(CONV_K, CONV_POLYS, device=device)

    # -- TX ---------------------------------------------------------------
    def encode_frame(self, frame: Frame) -> np.ndarray:
        """Frame -> complex QPSK symbols (incl. sync), unit amplitude."""
        payload = frame.serialize()
        blocks = np.stack([
            np.asarray(self.rs.encode(payload[i * RS_K:(i + 1) * RS_K]))
            for i in range(RS_BLOCKS)
        ])
        scrambled = _interleave(blocks) ^ SCRAMBLER
        bits = np.unpackbits(scrambled)
        bits = np.concatenate([bits, np.zeros(CONV_FLUSH_BITS, np.uint8)])
        coded = self.conv_enc.encode(bits)
        assert coded.size == CODED_BITS
        return np.concatenate(
            [_bits_to_syms(_sync_bits()), _bits_to_syms(coded)]
        ).astype(np.complex64)

    # -- RX ---------------------------------------------------------------
    @staticmethod
    def symbols_to_soft(syms: np.ndarray) -> np.ndarray:
        """Symbols -> interleaved (re, im) soft bits, positive <=> bit 0.

        Wire mapping is bit 1 -> positive component, and this module's
        Viterbi convention is positive <=> bit 0 (fec/viterbi.py), so
        the components are negated.
        """
        soft = np.empty(syms.size * 2, np.float32)
        soft[0::2] = -np.real(syms)
        soft[1::2] = -np.imag(syms)
        return soft

    @staticmethod
    def symbols_to_bits(syms: np.ndarray) -> np.ndarray:
        """Hard wire bits (for sync search)."""
        code = _syms_to_code(syms)
        bits = np.empty(syms.size * 2, np.uint8)
        bits[0::2] = code >> 1
        bits[1::2] = code & 1
        return bits

    def decode_soft(self, soft: np.ndarray) -> tuple[Frame | None, int]:
        """Post-sync soft bits (positive<=>bit0) -> (frame, rs_errs|-1)."""
        decoded = self.viterbi.decode(soft[:CODED_BITS]).cpu().numpy()
        scrambled = np.packbits(decoded[:DATA_BITS])
        rs_in = _deinterleave(scrambled ^ SCRAMBLER)
        out = np.zeros(FRAME_SIZE, np.uint8)
        total_err = 0
        for i in range(RS_BLOCKS):
            data, nerr = self.rs.decode(rs_in[i])
            if nerr < 0:
                return None, -1
            total_err += nerr
            out[i * RS_K:(i + 1) * RS_K] = data
        return Frame.deserialize(out), total_err

    def decode_bits(self, coded_bits: np.ndarray) -> tuple[Frame | None, int]:
        """Hard-decision entry point: post-sync wire bits -> frame."""
        soft = 1.0 - 2.0 * np.asarray(
            coded_bits[:CODED_BITS], np.float32
        )
        # wire bit 1 -> soft -1 = "bit 1" in the viterbi's convention
        return self.decode_soft(soft)

    def frame_symbol_count(self) -> int:
        return FRAME_SYMS


# -- deframing -------------------------------------------------------------

def _rotate_code(code: np.ndarray, steps: int) -> np.ndarray:
    """Rotate hard 2-bit codes by 90deg*steps (``framing.cpp:56-81``)."""
    # one 90deg step: 00->10, 01->00, 11->01, 10->11
    lut = np.array([2, 0, 3, 1], np.uint8)
    out = np.asarray(code, np.uint8)
    for _ in range(steps % 4):
        out = lut[out]
    return out


# derotation factors per detected rotation (``framing.h:75-80``)
_SYM_ROTS = np.array([1.0, -1.0j, -1.0, 1.0j], np.complex64)


def _sync_patterns() -> np.ndarray:
    """(4, 64) ±1 patterns for the sync word under 0/90/180/270 rotation."""
    base = _sync_bits()
    code = (base[0::2] << 1) | base[1::2]
    pats = np.empty((4, SYNC_BITS), np.int8)
    for r in range(4):
        c = _rotate_code(code, r)
        bits = np.empty(SYNC_BITS, np.uint8)
        bits[0::2] = c >> 1
        bits[1::2] = c & 1
        pats[r] = 1 - 2 * bits.astype(np.int8)
    return pats


_SYNC_PATS = _sync_patterns()


class RyfiDeframer:
    """Streaming sync search + rotation correction (``framing.cpp:86-135``).

    ``push(symbols)`` consumes demodulated symbols and returns a list of
    derotated 8168-symbol frame payloads.  Keeps partial state across
    calls (pending symbols while searching, partially-received frames).
    """

    MAX_SYNC_ERRORS = 5  # reference: distance < 6

    def __init__(self):
        self._search = np.zeros(0, np.complex64)
        self._frame = None   # partially filled frame buffer
        self._fill = 0
        self._rot = 1.0 + 0j

    def push(self, syms: np.ndarray) -> list[np.ndarray]:
        out = []
        syms = np.asarray(syms, np.complex64)
        while syms.size:
            if self._frame is not None:
                take = min(FRAME_SYMS - self._fill, syms.size)
                self._frame[self._fill:self._fill + take] = (
                    syms[:take] * self._rot
                )
                self._fill += take
                syms = syms[take:]
                if self._fill == FRAME_SYMS:
                    out.append(self._frame)
                    self._frame = None
                    self._fill = 0
                continue
            buf = np.concatenate([self._search, syms])
            syms = syms[:0]
            bits = RyfiCodec.symbols_to_bits(buf)
            pm = 1.0 - 2.0 * bits.astype(np.float32)
            hit = -1
            if buf.size >= SYNC_SYMS:
                # window ending at symbol i covers bits [2i-62, 2i+2);
                # corr[j] = match score of window starting at bit 2j
                best_rot, best_idx = -1, -1
                for r in range(4):
                    corr = np.correlate(pm, _SYNC_PATS[r].astype(np.float32))
                    # starts at even bit offsets = symbol boundaries
                    starts = np.nonzero(
                        corr[0::2] > SYNC_BITS - 2 * (self.MAX_SYNC_ERRORS + 1)
                    )[0]
                    if starts.size and (best_idx < 0 or starts[0] < best_idx):
                        best_idx, best_rot = int(starts[0]), r
                if best_idx >= 0:
                    hit = best_idx + SYNC_SYMS  # first data symbol index
                    self._rot = _SYM_ROTS[best_rot]
            if hit < 0:
                # keep a sync word's worth of tail for the next call
                self._search = buf[-(SYNC_SYMS - 1):] if buf.size else buf
                return out
            self._search = np.zeros(0, np.complex64)
            self._frame = np.empty(FRAME_SYMS, np.complex64)
            self._fill = 0
            syms = buf[hit:]
        return out


def find_sync(bits: np.ndarray, max_errors: int = 4) -> int:
    """Index of the sync word in a wire bit stream, or -1."""
    sync = _sync_bits().astype(np.int8)
    b = np.asarray(bits, np.int8)
    if len(b) < SYNC_BITS:
        return -1
    pm = 1.0 - 2.0 * b.astype(np.float32)
    ps = 1.0 - 2.0 * sync.astype(np.float32)
    corr = np.correlate(pm, ps)
    idx = np.nonzero(corr > SYNC_BITS - 2 * (max_errors + 1))[0]
    return int(idx[0]) if idx.size else -1


# -- packet layer ----------------------------------------------------------

PKT_OFFS_NONE = 0xFFFF


def pack_packets(packets: list[bytes], counter: int = 0) -> Frame:
    """Pack length-prefixed packets into one frame (single-frame case)."""
    content = np.zeros(FRAME_DATA_SIZE, np.uint8)
    off = 0
    first = PKT_OFFS_NONE
    last = PKT_OFFS_NONE
    for p in packets:
        need = 2 + len(p)
        if off + need > FRAME_DATA_SIZE:
            break
        if first == PKT_OFFS_NONE:
            first = off
        last = off
        content[off] = len(p) >> 8
        content[off + 1] = len(p) & 0xFF
        content[off + 2: off + 2 + len(p)] = np.frombuffer(p, np.uint8)
        off += need
    return Frame(counter, first, last, content)


def pack_stream(packets: list[bytes], counter: int = 0) -> list[Frame]:
    """Pack packets into as many frames as needed, spanning boundaries.

    Mirrors the reference TX worker (``ryfi/transmitter.cpp:100-175``):
    each serialized packet is a big-endian u16 length + content and may
    continue into the next frame; ``firstPacket``/``lastPacket`` point
    at the offsets where packets *start* within each frame (a
    continuation tail occupies the head of the frame before
    ``firstPacket``).
    """
    frames = []
    queue = list(packets)
    buf = b""  # unsent remainder of the packet currently being written
    while queue or buf or not frames:
        frame = Frame(counter & 0xFFFF)
        counter += 1
        off = 0
        while off < FRAME_DATA_SIZE:
            if not buf:
                # a new packet needs >= 2 bytes for its length field
                if FRAME_DATA_SIZE - off < 2 or not queue:
                    break  # rest of the frame stays filler
                p = queue.pop(0)
                buf = len(p).to_bytes(2, "big") + p
                if frame.first_packet == PKT_OFFS_NONE:
                    frame.first_packet = off
                frame.last_packet = off
            w = min(len(buf), FRAME_DATA_SIZE - off)
            frame.content[off:off + w] = np.frombuffer(buf[:w], np.uint8)
            buf = buf[w:]
            off += w
        frames.append(frame)
        if not queue and not buf:
            break
    return frames


def unpack_packets(frame: Frame) -> list[bytes]:
    out = []
    if frame.first_packet == PKT_OFFS_NONE:
        return out
    off = frame.first_packet
    while off + 2 <= FRAME_DATA_SIZE:
        ln = int(frame.content[off]) << 8 | int(frame.content[off + 1])
        if ln == 0 or off + 2 + ln > FRAME_DATA_SIZE:
            break
        out.append(bytes(frame.content[off + 2: off + 2 + ln]))
        if off == frame.last_packet:
            break
        off += 2 + ln
    return out


class PacketReassembler:
    """Cross-frame packet extraction (``ryfi/receiver.cpp:72-193``).

    Feeds on decoded frames in order; packets may span frame boundaries
    (a frame carries a partial tail continued in the next).  Frame-loss
    (non-consecutive counters) cancels any partial packet.
    """

    MAX_PACKET = 0x10000

    def __init__(self):
        self._last_counter = None
        self._pkt = bytearray()
        self._expected = 0

    def push(self, frame: Frame) -> list[bytes]:
        out = []
        frame_read = 0
        if self._last_counter is not None and (
            frame.counter != ((self._last_counter + 1) & 0xFFFF)
        ):
            # lost frames: cancel the partial packet, resync on this
            # frame's first-packet offset
            self._pkt.clear()
            self._expected = 0
            if frame.first_packet != PKT_OFFS_NONE:
                if frame.first_packet > FRAME_DATA_SIZE - 2:
                    self._last_counter = frame.counter
                    return out
                frame_read = frame.first_packet
        self._last_counter = frame.counter
        if not self._expected and frame.first_packet == PKT_OFFS_NONE:
            return out
        first = True
        last = False
        content = frame.content
        while frame_read < FRAME_DATA_SIZE:
            if self._expected:
                readable = min(self._expected - len(self._pkt),
                               FRAME_DATA_SIZE - frame_read)
                self._pkt += bytes(content[frame_read:frame_read + readable])
                frame_read += readable
                if len(self._pkt) >= self._expected:
                    out.append(bytes(self._pkt))
                    self._pkt.clear()
                    self._expected = 0
                    if last or frame.first_packet == PKT_OFFS_NONE:
                        break
                continue
            if FRAME_DATA_SIZE - frame_read < 2:
                self._pkt.clear()
                self._expected = 0
                break
            if first:
                frame_read = frame.first_packet
                first = False
            last = frame_read == frame.last_packet
            self._expected = (int(content[frame_read]) << 8
                              | int(content[frame_read + 1]))
            frame_read += 2
            if self._expected == 0:
                self._expected = 0
                break
        return out


# -- RF layer --------------------------------------------------------------

class RyfiTransmitter:
    """Packets -> RRC-shaped QPSK baseband (``ryfi/transmitter.cpp:4-23``).

    The reference zero-stuffs symbols to the baseband rate and applies a
    511-tap beta-0.6 RRC normalized to unit DC gain; here the
    `RrcInterpolator` (kernels/mod.py) does both in one polyphase pass.
    """

    def __init__(self, baudrate: float, samplerate: float,
                 rrc_tap_count: int = 511, rrc_beta: float = 0.6,
                 device="cuda"):
        sps = samplerate / baudrate
        assert abs(sps - round(sps)) < 1e-9, "samplerate must be k*baud"
        from ..kernels.mod import RrcInterpolator

        self.sps = int(round(sps))
        self.codec = RyfiCodec(device=device)
        self.interp = RrcInterpolator(
            self.sps, rrc_tap_count, rrc_beta, dtype=torch.complex64,
            normalize_dc=True, device=device,
        )
        self.device = self.interp.poly.device
        self._counter = 0
        self._state = self.interp.init_state()

    def send(self, packets: list[bytes]) -> np.ndarray:
        """Pack + encode + shape; packets may span multiple frames.
        Returns the baseband on the host."""
        frames = pack_stream(packets, counter=self._counter)
        self._counter = (self._counter + len(frames)) & 0xFFFF
        syms = np.concatenate(
            [self.codec.encode_frame(f) for f in frames]
        ).astype(np.complex64)
        with torch.inference_mode():
            self._state, bb = self.interp(
                self._state, torch.as_tensor(syms, device=self.device))
            return bb.cpu().numpy()

    def idle(self) -> np.ndarray:
        """One idle frame (no packets) to keep the RX locked."""
        return self.send([])


class RyfiReceiver:
    """Streaming IQ -> packets (``ryfi/receiver.h:55-64``).

    PSK4 demod (RRC 31 taps beta 0.6, AGC 0.1, Costas bw 0.005, M&M
    1e-6/0.01 — ``receiver.cpp:19``) -> deframer -> Viterbi+RS ->
    packet reassembly.  The demod and the Viterbi run on ``device``; the
    valid symbols come to the host once a block for the deframer, and RS
    and the packet layer run on the host.
    """

    def __init__(self, baudrate: float, samplerate: float, device="cuda"):
        from ..kernels.psk import Psk

        self.demod = Psk(
            4, baudrate, samplerate,
            rrc_tap_count=31, rrc_beta=0.6, agc_rate=0.1,
            costas_bandwidth=0.005, omega_gain=1e-6, mu_gain=0.01,
            device=device,
        )
        self.device = self.demod.device
        self.deframer = RyfiDeframer()
        self.codec = RyfiCodec(device=self.device)
        self.reasm = PacketReassembler()
        self._state = self.demod.init_state()
        self.frames_decoded = 0
        self.frames_failed = 0
        self.rs_errors = 0

    def process(self, iq: np.ndarray) -> list[bytes]:
        """Demodulate one baseband block; returns completed packets."""
        with torch.inference_mode():
            x = torch.as_tensor(iq, device=self.device).to(torch.complex64)
            self._state, (syms, valid) = self.demod(self._state, x)
            syms = syms[valid].cpu().numpy()
        packets = []
        for payload in self.deframer.push(syms):
            frame, nerr = self.codec.decode_soft(
                self.codec.symbols_to_soft(payload)
            )
            if frame is None:
                self.frames_failed += 1
                continue
            self.frames_decoded += 1
            self.rs_errors += nerr
            packets.extend(self.reasm.push(frame))
        return packets
