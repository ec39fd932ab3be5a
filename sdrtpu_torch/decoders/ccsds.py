"""CCSDS concatenated-code deframer (PyTorch counterpart of
``sdrtpu/decoders/ccsds.py``): the Meteor M2 LRPT chain past the
demodulator.

    QPSK soft symbols
      -> rate-1/2 K=7 convolutional code (polys 0o171/0o133) -> Viterbi
      -> attached sync marker 0x1ACFFC1D on 1024-byte frames
      -> derandomizer (CCSDS PRBS x^8+x^7+x^5+x^3+1, all-ones init)
      -> Reed-Solomon (255,223) interleave depth 4 -> 892-byte CVCDU

Soft symbols stay on the decoder's device up to the Viterbi
(`fec.viterbi`): the carried soft tail, the 90-degree rotation and the
I/Q interleave are tensor ops there.  The decoded bits come to the host
once per `CcsdsDeframer.process`, and the ASM search, derandomizer and
Reed-Solomon decode are the reference's NumPy, as in the reference.

Spans (`metrics.span`): ``sdrtpu.deframe`` around
`QpskAmbiguityResolver.process` (the Viterbi launch, its wait, the bit
copy, the ASM search and the RS decodes) and ``sdrtpu.deframe.rs``
around each `rs_interleave_decode`.  Counters (`CcsdsDeframer.counters`,
the resolver's of its active deframer): ``frames``, ``rs_codewords``,
``rs_corrected_bytes``, ``rs_failures`` (codewords RS could not correct:
their codeblock gives no frame) and ``viterbi_steps`` (trellis steps
decoded, the carried tail's again).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..fec.reed_solomon import ReedSolomon
from ..fec.viterbi import ConvEncoder, ViterbiDecoder
from ..metrics import span

ASM = 0x1ACFFC1D
ASM_BITS = np.array([(ASM >> (31 - i)) & 1 for i in range(32)], np.uint8)
FRAME_BYTES = 1024           # ASM-framed codeblock (after the 4-byte ASM)
RS_INTERLEAVE = 4
RS_N, RS_K = 255, 223
CVCDU_BYTES = RS_K * RS_INTERLEAVE  # 892
CONV_POLYS = (0o171, 0o133)


def ccsds_randomizer(n_bytes: int) -> np.ndarray:
    """CCSDS pseudo-randomizer sequence (x^8+x^7+x^5+x^3+1, init 0xFF).

    255-bit-periodic; the standard sequence begins
    ``ff 48 0e c0 9a 0d 70 bc`` (CCSDS 131.0-B).  MSB-first output from
    a Fibonacci LFSR whose feedback taps for this polynomial are bits
    7, 4, 2, 0 of the shift register.
    """
    reg = 0xFF
    out = np.empty(n_bytes, np.uint8)
    for i in range(n_bytes):
        b = 0
        for _ in range(8):
            fb = ((reg >> 7) ^ (reg >> 4) ^ (reg >> 2) ^ reg) & 1
            b = (b << 1) | ((reg >> 7) & 1)
            reg = ((reg << 1) | fb) & 0xFF
        out[i] = b
    return out


_RAND = ccsds_randomizer(FRAME_BYTES)


def rs_interleave_encode(data: np.ndarray, rs: ReedSolomon) -> np.ndarray:
    """(892,) CVCDU bytes -> (1020,) RS codeblock, interleave depth 4."""
    d = np.asarray(data, np.uint8).reshape(RS_K, RS_INTERLEAVE)
    out = np.empty((RS_N, RS_INTERLEAVE), np.uint8)
    for i in range(RS_INTERLEAVE):
        out[:, i] = rs.encode(d[:, i])
    return out.reshape(-1)


def rs_interleave_decode(code: np.ndarray, rs: ReedSolomon):
    """(1020,) RS codeblock -> ((892,) CVCDU, corrections), or (None, -k)
    when k of the four codewords fail (each of the four is decoded)."""
    c = np.asarray(code, np.uint8).reshape(RS_N, RS_INTERLEAVE)
    out = np.empty((RS_K, RS_INTERLEAVE), np.uint8)
    total = failed = 0
    for i in range(RS_INTERLEAVE):
        data, nerr = rs.decode(c[:, i])
        if nerr < 0:
            failed += 1
            continue
        total += nerr
        out[:, i] = data
    if failed:
        return None, -failed
    return out.reshape(-1), total


def _ccsds_rs() -> ReedSolomon:
    return ReedSolomon(nroots=32, prim_poly=0x187, fcr=112, prim=11)


class CcsdsEncoder:
    """Frame bytes -> soft QPSK symbols (host NumPy; tests and tx)."""

    def __init__(self):
        self.rs = _ccsds_rs()
        self.conv = ConvEncoder(7, CONV_POLYS)

    def encode(self, cvcdus: list[np.ndarray]) -> np.ndarray:
        bits = []
        for cv in cvcdus:
            code = rs_interleave_encode(cv, self.rs)
            # pad codeblock to FRAME_BYTES with zeros (1020 -> 1024)
            frame = np.zeros(FRAME_BYTES, np.uint8)
            frame[: len(code)] = code
            frame ^= _RAND
            bits.append(ASM_BITS)
            bits.append(np.unpackbits(frame))
        coded = self.conv.encode(np.concatenate(bits))
        # soft symbols: bit 0 -> +1
        return 1.0 - 2.0 * coded.astype(np.float32)


class CcsdsDeframer:
    """Soft channel symbols -> CVCDU frames with RS statistics.

    Streaming: the soft symbols not consumed by a frame are carried to
    the next call (at most two frames' worth, on the device), so frames
    straddling a `process()` boundary are not lost; the carried symbols
    are decoded again together with the next block, which also heals the
    trellis seam.  The carry starts `_LEAD_BITS` before the first bit not
    yet scanned: the Viterbi starts each call in state 0, and the bits it
    decodes first may be wrong where the stream's state is another (a
    180-degree lock's complemented stream: ~6 of an ASM's 32 bits), so
    the scan resumes past them.  A frame is found in the call whose input
    holds its last bit.  ``positions[i]`` is the stream index (in decoded
    bits, one a QPSK symbol) of ``frames[i]``'s ASM.
    """

    _FRAME_BITS = 32 + FRAME_BYTES * 8
    _MAX_TAIL_BITS = 2 * _FRAME_BITS  # bound the re-decoded carry
    _LEAD_BITS = 64  # decoded again ahead of the scan: 9 constraint lengths

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.rs = _ccsds_rs()
        self.viterbi = ViterbiDecoder(7, CONV_POLYS, device=self.device)
        self.frames: list[np.ndarray] = []
        self.rs_errors: list[int] = []
        self.positions: list[int] = []
        self.rs_codewords = 0
        self.rs_corrected_bytes = 0
        self.rs_failures = 0
        self.viterbi_steps = 0
        self._soft_tail = torch.zeros(0, dtype=torch.float32,
                                      device=self.device)
        self._bit_tail = np.zeros(0, np.uint8)
        self._seen = 0  # bits handed in so far
        self._lead = 0  # bits at the soft tail's head already scanned

    @property
    def counters(self) -> dict:
        return {"frames": len(self.frames), "rs_codewords": self.rs_codewords,
                "rs_corrected_bytes": self.rs_corrected_bytes,
                "rs_failures": self.rs_failures,
                "viterbi_steps": self.viterbi_steps}

    def process(self, soft) -> list[np.ndarray]:
        """Decode a block of soft symbols (a tensor on any device or host
        numpy); returns the new CVCDUs."""
        soft = torch.as_tensor(soft, dtype=torch.float32, device=self.device)
        start = self._seen - self._soft_tail.shape[0] // 2
        self._seen += soft.shape[0] // 2
        soft = torch.cat([self._soft_tail, soft])
        self.viterbi_steps += soft.shape[0] // 2
        decoded = self.viterbi.decode(soft).cpu().numpy()
        new, consumed = self._scan(decoded, start, self._lead)
        keep = max(consumed - self._LEAD_BITS, 0)
        tail = soft[2 * keep:]
        cut = max(tail.shape[0] // 2 - self._MAX_TAIL_BITS, 0)
        self._soft_tail = tail[2 * cut:]
        self._lead = max(consumed - keep - cut, 0)
        return new

    def process_bits(self, bits: np.ndarray) -> list[np.ndarray]:
        """Decode a block of hard bits (post-Viterbi input path)."""
        bits = np.asarray(bits, np.uint8)
        start = self._seen - len(self._bit_tail)
        self._seen += len(bits)
        bits = np.concatenate([self._bit_tail, bits])
        new, consumed = self._scan(bits, start)
        self._bit_tail = bits[consumed:][-self._MAX_TAIL_BITS:]
        return new

    def _scan(self, bits: np.ndarray, start: int = 0,
              first: int = 0) -> tuple[list[np.ndarray], int]:
        """Frames in ``bits`` from bit ``first`` on, ``bits[0]`` being
        stream bit ``start``; returns them and the bits consumed."""
        new = []
        frame_bits = self._FRAME_BITS
        i = first
        while i + frame_bits <= len(bits):
            w = bits[i : i + 32]
            inv = np.count_nonzero(w != ASM_BITS)
            if inv <= 3 or inv >= 29:  # direct or inverted sync
                fb = bits[i + 32 : i + frame_bits]
                if inv >= 29:
                    fb = fb ^ 1
                frame = np.packbits(fb) ^ _RAND
                with span("sdrtpu.deframe.rs"):
                    data, nerr = rs_interleave_decode(
                        frame[: RS_N * RS_INTERLEAVE], self.rs)
                self.rs_codewords += RS_INTERLEAVE
                if data is None:
                    self.rs_failures -= nerr
                else:
                    new.append(data)
                    self.frames.append(data)
                    self.rs_errors.append(nerr)
                    self.positions.append(start + i)
                    self.rs_corrected_bytes += nerr
                i += frame_bits
            else:
                i += 1
        return new, i


def deframe_qpsk_symbols(symbols, deframer=None, device="cuda"):
    """Resolve the QPSK lock ambiguity and deframe complex soft symbols.

    A 4th-order Costas loop (`MeteorDemod`) locks at any of 4 rotations;
    the ASM search absorbs the 180-degree pair (inverted sync), so two
    candidate streams remain: direct (I = even bits, Q = odd) and the
    90-degree rotation.  Both are tried until one syncs.  ``device`` is
    where a new resolver decodes.

    Returns (frames, resolver); the resolver keeps RS statistics.
    """
    if deframer is None:
        deframer = QpskAmbiguityResolver(device=device)
    return deframer.process(symbols), deframer


class QpskAmbiguityResolver:
    """Streaming 90-degree-ambiguity resolver over two `CcsdsDeframer`s.

    Both rotation candidates keep their own streaming state (soft tails),
    so frames straddling `process()` calls survive.  Once one candidate
    produces a frame the resolver locks to it and drops the other (a
    Costas re-lock to a new rotation mid-pass is a stream restart in the
    reference too).
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cands = [CcsdsDeframer(self.device), CcsdsDeframer(self.device)]
        self.locked: int | None = None

    @property
    def deframer(self) -> CcsdsDeframer:
        """The active deframer (frames / rs_errors statistics)."""
        return self._cands[self.locked if self.locked is not None else 0]

    @property
    def frames(self) -> list[np.ndarray]:
        return self.deframer.frames

    @property
    def rs_errors(self) -> list[int]:
        return self.deframer.rs_errors

    @property
    def positions(self) -> list[int]:
        return self.deframer.positions

    @property
    def counters(self) -> dict:
        return self.deframer.counters

    def process(self, symbols) -> list[np.ndarray]:
        """Deframe complex soft symbols (a complex tensor on any device or
        host numpy); returns the new CVCDUs."""
        with span("sdrtpu.deframe"):
            return self._process(symbols)

    def _process(self, symbols) -> list[np.ndarray]:
        symbols = torch.as_tensor(symbols, device=self.device).to(
            torch.complex64)
        ks = (self.locked,) if self.locked is not None else (0, 1)
        new: list[np.ndarray] = []
        for k in ks:
            # k = 1: the symbols times -1j, i.e. (re, im) -> (im, -re)
            pair = ((symbols.real, symbols.imag) if k == 0
                    else (symbols.imag, -symbols.real))
            soft = torch.stack(pair, dim=-1).reshape(-1)
            frames = self._cands[k].process(soft)
            new += frames
            if frames and self.locked is None:
                self.locked = k
                self._cands[1 - k] = self._cands[k]  # free the loser
                # stop: running the other rotation through the (now
                # aliased) locked deframer would corrupt its soft tail
                break
        return new
