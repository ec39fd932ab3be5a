"""Falcon-9 telemetry decoder (PyTorch counterpart of
``sdrtpu/decoders/falcon9.py``; ``decoder_modules/falcon9_decoder``).

Reference chain (``falcon9_decoder/src/main.cpp:52-61``): FM demod
(2 MHz deviation @ 6 Msps) -> M&M clock recovery @ 3.5714 Mbaud ->
binary slicer -> ASM deframer (0x1ACFFC1D, 10232-bit frames) ->
5-way-interleaved dual-basis RS(255,239) with CCSDS derandomization
(``falcon_fec.h:58-130``) -> frame-counter/packet-pointer reassembly and
packet-ID dispatch (``falcon_packet.h:28-105``).

`FalconDemod` runs on the chain's device: the `Quadrature`
discriminator, then the float `MuellerMuller` (one `mm_scan` launch a
block on the card).  The slicer's bits come to the host once a block;
the ASM search, the dual-basis RS (the port's `ReedSolomon`) and the
packet layer are the reference's host numpy, copied as they are.  The
dual-basis conversion is generated from its 8 basis images; the
derandomizer is the CCSDS PRBS of `decoders/ccsds.py`, with period 255.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fec.reed_solomon import ReedSolomon
from ..graph.block import StreamOp
from ..kernels.clock import MuellerMuller
from ..kernels.demod import Quadrature
from .ccsds import ccsds_randomizer

SAMPLERATE = 6_000_000.0  # main.cpp:35
DEVIATION = 2_000_000.0  # main.cpp:52
BAUDRATE = 3_571_400.0  # main.cpp:53
ASM = 0x1ACFFC1D  # main.cpp:232 (bit-expanded there)
ASM_BITS = 32
FRAME_BITS = 10232  # main.cpp:60
RS_INTERLEAVE = 5
RS_N, RS_K, RS_ROOTS = 255, 239, 16
RS_BYTES = RS_N * RS_INTERLEAVE  # 1275
DATA_BYTES = RS_K * RS_INTERLEAVE  # 1195
FRAME_DATA_LEN = 1191  # payload after the 4-byte header (falcon_packet.h:39)

# Images of 1<<k (k = 0..7) under the conventional->dual-basis map.
DUAL_BASIS = (0x7B, 0xAF, 0x99, 0xFA, 0x86, 0xEC, 0xEF, 0x8D)

_ASM_PATTERN = np.array(
    [(ASM >> (ASM_BITS - 1 - i)) & 1 for i in range(ASM_BITS)], np.uint8
)


def _linear_table(basis) -> np.ndarray:
    out = np.zeros(256, np.uint8)
    for x in range(256):
        v = 0
        for k in range(8):
            if (x >> k) & 1:
                v ^= basis[k]
        out[x] = v
    return out


def _invert_basis(basis) -> tuple[int, ...]:
    """Invert the GF(2) 8x8 bit matrix given by its column images."""
    # rows: augmented [M | I], eliminate to find M^-1 columns
    table = _linear_table(basis)
    inv = np.zeros(256, np.uint8)
    inv[table] = np.arange(256, dtype=np.uint8)
    return tuple(int(inv[1 << k]) for k in range(8))


TO_DUAL = _linear_table(DUAL_BASIS)
FROM_DUAL = _linear_table(_invert_basis(DUAL_BASIS))


def _falcon_rs() -> ReedSolomon:
    # correct_reed_solomon_create(ccsds poly, 120, 11, 16) (falcon_fec.h:73)
    return ReedSolomon(nroots=RS_ROOTS, prim_poly=0x187, fcr=120, prim=11)


def _rand255(n: int) -> np.ndarray:
    seq = ccsds_randomizer(RS_N)
    reps = -(-n // RS_N)
    return np.tile(seq, reps)[:n]


def rs_frame_decode(frame: np.ndarray, rs: ReedSolomon | None = None):
    """(1275,) dual-basis frame bytes -> ((1195,) data, errors or None).

    Mirrors ``FalconRS::run`` (``falcon_fec.h:80-126``): deinterleave
    i -> (i % 5, i // 5), dual->conventional, RS(255,239) decode x5,
    conventional->dual, derandomize with the 255-periodic CCSDS PRBS.
    """
    rs = rs or _falcon_rs()
    frame = np.asarray(frame, np.uint8)[:RS_BYTES]
    conv = FROM_DUAL[frame].reshape(RS_N, RS_INTERLEAVE)
    out = np.empty((RS_K, RS_INTERLEAVE), np.uint8)
    total_err = 0
    for i in range(RS_INTERLEAVE):
        data, nerr = rs.decode(conv[:, i])
        if nerr < 0:
            return None, None
        total_err += nerr
        out[:, i] = data
    flat = TO_DUAL[out.reshape(-1)] ^ _rand255(DATA_BYTES)
    return flat, total_err


def rs_frame_encode(data: np.ndarray, rs: ReedSolomon | None = None) -> np.ndarray:
    """Inverse of `rs_frame_decode` for loopback tests."""
    rs = rs or _falcon_rs()
    data = np.asarray(data, np.uint8)
    assert data.size == DATA_BYTES
    scr = FROM_DUAL[data ^ _rand255(DATA_BYTES)].reshape(RS_K, RS_INTERLEAVE)
    code = np.empty((RS_N, RS_INTERLEAVE), np.uint8)
    for i in range(RS_INTERLEAVE):
        code[:, i] = rs.encode(scr[:, i])
    return TO_DUAL[code.reshape(-1)]


@dataclass
class FalconPacket:
    pkt_id: int
    payload: bytes


class FalconPacketSync:
    """Frame-data reassembly into packets (``falcon_packet.h:28-105``).

    Each 1195-byte frame block = 4-byte header (19-bit counter, 11-bit
    first-packet pointer) + 1191 data bytes.  Packets carry a 2-byte
    length (low 12 bits + 2) and an 8-byte packet ID; a pointer of 2047
    means the whole frame continues the previous packet.
    """

    def __init__(self):
        self._partial: bytearray | None = None
        self._last_counter: int | None = None
        self.packets: list[FalconPacket] = []

    @staticmethod
    def parse_header(frame: np.ndarray) -> tuple[int, int]:
        b = np.asarray(frame, np.uint8)
        pointer = int(b[3]) | ((int(b[2]) & 0b111) << 8)
        counter = (int(b[2]) >> 3) | (int(b[1]) << 5) | ((int(b[0]) & 0x3F) << 13)
        return counter, pointer

    def _emit(self, raw: bytes):
        if len(raw) < 10:
            return
        pkt_id = int.from_bytes(raw[2:10], "big")
        self.packets.append(FalconPacket(pkt_id, raw[10:]))

    def process(self, frame: np.ndarray) -> list[FalconPacket]:
        start = len(self.packets)
        counter, pointer = self.parse_header(frame)
        data = np.asarray(frame, np.uint8)[4 : 4 + FRAME_DATA_LEN]
        expected = (
            (self._last_counter + 1) & 0x7FFFF  # 19-bit counter wraps
            if self._last_counter is not None else None
        )
        if expected is not None and counter != expected:
            self._partial = None  # missed frame: drop the partial packet
        self._last_counter = counter

        if pointer == 2047:  # frame is pure continuation
            if self._partial is not None:
                self._partial.extend(data.tobytes())
            return self.packets[start:]

        if self._partial is not None:
            self._partial.extend(data[:pointer].tobytes())
            self._emit(bytes(self._partial))
            self._partial = None

        i = pointer
        while i < FRAME_DATA_LEN:
            if FRAME_DATA_LEN - i < 4:
                self._partial = bytearray(data[i:].tobytes())
                break
            length = (((int(data[i]) & 0x0F) << 8) | int(data[i + 1])) + 2
            if length <= 2:
                self._partial = None
                break
            if FRAME_DATA_LEN - i < length:
                self._partial = bytearray(data[i:].tobytes())
                break
            self._emit(data[i : i + length].tobytes())
            i += length
        return self.packets[start:]


# Known packet IDs (main.cpp:190-199)
PKT_GPS_TEXT = (0x0117FE0800320303, 0x0112FA0800320303)
PKT_TLM = 0x01123201042E1403


class FalconDemod(StreamOp):
    """IQ @ 6 Msps -> soft bits @ 3.5714 Mbaud (main.cpp:52-53), masked
    ``(syms, valid)`` of length ``max_out(n)``."""

    def __init__(self, samplerate: float = SAMPLERATE, device="cuda"):
        self.quad = Quadrature(DEVIATION, samplerate, device=device)
        self.recov = MuellerMuller(
            samplerate / BAUDRATE,
            omega_gain=0.01**2 / 4.0,
            mu_gain=0.01,
            omega_rel_limit=100e-6,
            complex_mode=False,
            device=device,
        )

    def max_out(self, n: int) -> int:
        return self.recov.max_out(n)

    def init_state(self):
        return {"quad": self.quad.init_state(), "mm": self.recov.init_state()}

    def __call__(self, state, x):
        st = dict(state)
        st["quad"], y = self.quad(state["quad"], x)
        st["mm"], (syms, valid) = self.recov(state["mm"], y)
        return st, (syms, valid)


class FalconDeframer:
    """Hard bits -> 1279-byte frames via ASM correlation sync."""

    def __init__(self, max_errors: int = 2):
        self.max_errors = int(max_errors)
        self._bits = np.zeros(0, np.uint8)
        self.frames_seen = 0

    def process(self, bits: np.ndarray) -> list[np.ndarray]:
        buf = np.concatenate([self._bits, np.asarray(bits, np.uint8)])
        out = []
        pos = 0
        need = ASM_BITS + FRAME_BITS
        while buf.size - pos >= need:
            search = buf[pos:]
            n_align = search.size - need + 1
            win = np.lib.stride_tricks.sliding_window_view(search, ASM_BITS)[
                :n_align
            ]
            dist = np.count_nonzero(win != _ASM_PATTERN, axis=1)
            hits = np.nonzero(dist <= self.max_errors)[0]
            if hits.size == 0:
                pos += n_align
                break
            s = pos + int(hits[0]) + ASM_BITS
            out.append(np.packbits(buf[s : s + FRAME_BITS]))
            self.frames_seen += 1
            pos = s + FRAME_BITS
        self._bits = buf[pos:]
        return out


class Falcon9Decoder:
    """Full receive path: IQ blocks (host numpy or a tensor) -> telemetry
    packets.  The demodulator runs on ``device``; the hard bits come to
    the host once a block (`bits`)."""

    def __init__(self, samplerate: float = SAMPLERATE, device="cuda"):
        self.demod = FalconDemod(samplerate, device=device)
        self.device = self.demod.quad.device
        self.state = self.demod.init_state()
        self.deframer = FalconDeframer()
        self.rs = _falcon_rs()
        self.sync = FalconPacketSync()
        self.rs_failures = 0

    def bits(self, iq) -> np.ndarray:
        """Demodulate one block; its sliced bits on the host."""
        with torch.inference_mode():
            x = torch.as_tensor(iq, device=self.device).to(torch.complex64)
            self.state, (syms, valid) = self.demod(self.state, x)
            return (syms[valid] > 0).to(torch.uint8).cpu().numpy()

    def process(self, iq) -> list[FalconPacket]:
        return self.packets(self.bits(iq))

    def packets(self, bits: np.ndarray) -> list[FalconPacket]:
        """Deframe, RS-decode and reassemble one block's bits (host)."""
        pkts: list[FalconPacket] = []
        for frame in self.deframer.process(bits):
            data, nerr = rs_frame_decode(frame, self.rs)
            if data is None:
                self.rs_failures += 1
                continue
            pkts.extend(self.sync.process(data))
        return pkts
