"""FLEX pager frame-layer decoder (PyTorch counterpart of
``sdrtpu/decoders/flex.py``).

Host code, copied from the reference as it is, on the port's `pocsag`
BCH code; `FlexDecoder.process` takes a numpy array or a tensor of bits
on any device.

Parity target: ``decoder_modules/pager_decoder/src/flex`` — which in the
reference snapshot is an **empty stub** (``flex/flex.cpp`` is 4 lines;
the DSP and decode calls in ``flex/decoder.h:50-73`` are commented out).
This module therefore goes beyond parity with a functional FLEX
1600 bps / 2-FSK Phase-A frame layer:

- 64-bit frame sync: the 0xA6C6AAAA sync marker followed by the
  mode-specific sync code (1600/2 = 0x870C78F3), matched by block
  correlation with a configurable error budget.
- Frame Information Word: BCH(31,21)+parity protected (same code as
  POCSAG — shared from ``decoders/pocsag.py``), carrying 4-bit cycle and
  7-bit frame numbers guarded by a 4-bit nibble checksum.
- 11 data blocks of 8 bit-interleaved 32-bit codewords each
  (bit i of a block lands in word ``i % 8`` bit ``i // 8``), each word
  BCH-corrected.
- Phase-A word parse: block-information word, short-address +
  alphanumeric-vector pairs, and 3x7-bit packed alphanumeric message
  words.

Off-air field layouts beyond this subset (long addresses, numeric
vectors, fragmented messages) are not modeled — the loopback encoder
``build_flex_frame`` defines the contract the decoder is tested against.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..convert import to_numpy
from .pocsag import correct_codeword, encode_codeword

SYNC_MARKER = 0xA6C6AAAA
SYNC_1600_2 = 0x870C78F3
SYNC64 = (SYNC_MARKER << 32) | SYNC_1600_2
SYNC_MAX_ERRORS = 4
BLOCKS_PER_FRAME = 11
WORDS_PER_BLOCK = 8
BLOCK_BITS = 32 * WORDS_PER_BLOCK

VECTOR_ALPHA = 0b101

_SYNC_BITS = np.array(
    [(SYNC64 >> (63 - i)) & 1 for i in range(64)], np.uint8
)


def _fiw_checksum_ok(data21: int) -> bool:
    s = sum((data21 >> k) & 0xF for k in (0, 4, 8, 12, 16)) + (data21 >> 20)
    return (s & 0xF) == 0xF


def make_fiw(cycle: int, frame: int) -> int:
    """Build a 21-bit FIW with a valid nibble checksum."""
    body = ((frame & 0x7F) << 8) | ((cycle & 0xF) << 4)
    s = sum((body >> k) & 0xF for k in (4, 8, 12, 16)) + (body >> 20)
    chk = (0xF - (s & 0xF)) & 0xF
    return body | chk


def parse_fiw(data21: int) -> dict | None:
    if not _fiw_checksum_ok(data21):
        return None
    return {"cycle": (data21 >> 4) & 0xF, "frame": (data21 >> 8) & 0x7F}


def interleave_block(words: np.ndarray) -> np.ndarray:
    """8 x 32-bit words -> 256 transmitted bits (MSB-first per word)."""
    bits = np.zeros((WORDS_PER_BLOCK, 32), np.uint8)
    for w in range(WORDS_PER_BLOCK):
        bits[w] = [(int(words[w]) >> (31 - b)) & 1 for b in range(32)]
    # transmit order: bit i comes from word i%8, bit position i//8
    return bits.T.reshape(-1)


def deinterleave_block(bits: np.ndarray) -> np.ndarray:
    grid = np.asarray(bits, np.uint8).reshape(32, WORDS_PER_BLOCK).T
    words = np.zeros(WORDS_PER_BLOCK, np.uint64)
    for w in range(WORDS_PER_BLOCK):
        v = 0
        for b in range(32):
            v = (v << 1) | int(grid[w, b])
        words[w] = v
    return words


@dataclass
class FlexMessage:
    address: int
    text: str
    cycle: int
    frame: int


@dataclass
class FlexDecoder:
    """Bit-stream FLEX decoder: feed hard bits, collect messages."""

    max_sync_errors: int = SYNC_MAX_ERRORS
    messages: list[FlexMessage] = field(default_factory=list)
    frames_seen: int = 0
    _buf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    def _frame_len(self) -> int:
        return 64 + 32 + BLOCKS_PER_FRAME * BLOCK_BITS

    def process(self, bits: np.ndarray) -> list[FlexMessage]:
        buf = np.concatenate([self._buf,
                              to_numpy(bits).astype(np.uint8, copy=False)])
        out: list[FlexMessage] = []
        flen = self._frame_len()
        pos = 0
        while buf.size - pos >= flen:
            search = buf[pos:]
            n_align = search.size - flen + 1
            windows = np.lib.stride_tricks.sliding_window_view(search, 64)[
                :n_align
            ]
            dist = np.count_nonzero(windows != _SYNC_BITS, axis=1)
            hits = np.nonzero(dist <= self.max_sync_errors)[0]
            if hits.size == 0:
                pos += n_align
                break
            start = pos + int(hits[0])
            msgs = self._decode_frame(buf[start + 64 : start + flen])
            out.extend(msgs)
            pos = start + flen
        self._buf = buf[pos:]
        self.messages.extend(out)
        return out

    def _decode_frame(self, body: np.ndarray) -> list[FlexMessage]:
        fiw_cw = 0
        for b in body[:32]:
            fiw_cw = (fiw_cw << 1) | int(b)
        corrected = correct_codeword(fiw_cw)
        if corrected is None:
            return []
        fiw = parse_fiw(corrected >> 11)
        if fiw is None:
            return []
        self.frames_seen += 1

        words: list[int | None] = []
        for blk in range(BLOCKS_PER_FRAME):
            raw = body[32 + blk * BLOCK_BITS : 32 + (blk + 1) * BLOCK_BITS]
            for w in deinterleave_block(raw):
                cw = correct_codeword(int(w))
                words.append(None if cw is None else cw >> 11)

        return self._parse_words(words, fiw)

    def _parse_words(
        self, words: list[int | None], fiw: dict
    ) -> list[FlexMessage]:
        if not words or words[0] is None:
            return []
        biw = words[0]
        addr_start = (biw >> 16) & 0x1F  # word index of first address
        vec_start = (biw >> 10) & 0x3F  # word index of first vector
        if not (1 <= addr_start < vec_start <= len(words)):
            return []
        out: list[FlexMessage] = []
        n_addr = vec_start - addr_start
        for k in range(n_addr):
            aw = words[addr_start + k]
            vw = (
                words[vec_start + k] if vec_start + k < len(words) else None
            )
            if aw is None or vw is None:
                continue
            vec_type = (vw >> 18) & 0x7
            if vec_type != VECTOR_ALPHA:
                continue
            msg_start = (vw >> 11) & 0x7F
            msg_len = (vw >> 4) & 0x7F
            if msg_start + msg_len > len(words):
                continue
            chars: list[str] = []
            for mw in words[msg_start : msg_start + msg_len]:
                if mw is None:
                    chars.append("�" * 3)
                    continue
                for slot in range(3):
                    c = (mw >> (14 - 7 * slot)) & 0x7F
                    if c:
                        chars.append(chr(c))
            out.append(
                FlexMessage(
                    address=aw & 0x1FFFFF,
                    text="".join(chars),
                    cycle=fiw["cycle"],
                    frame=fiw["frame"],
                )
            )
        return out


def build_flex_frame(
    cycle: int, frame: int, messages: list[tuple[int, str]]
) -> np.ndarray:
    """Loopback encoder: (address, text) pairs -> transmitted bit stream."""
    total_words = BLOCKS_PER_FRAME * WORDS_PER_BLOCK
    data = np.zeros(total_words, np.int64)  # 21-bit payloads per word
    addr_start = 1
    vec_start = addr_start + len(messages)
    msg_ptr = vec_start + len(messages)
    data[0] = ((addr_start & 0x1F) << 16) | ((vec_start & 0x3F) << 10)
    for k, (addr, text) in enumerate(messages):
        data[addr_start + k] = addr & 0x1FFFFF
        n_words = (len(text) + 2) // 3
        if msg_ptr + n_words > total_words:
            raise ValueError("frame overflow")
        data[vec_start + k] = (
            (VECTOR_ALPHA << 18) | ((msg_ptr & 0x7F) << 11) | ((n_words & 0x7F) << 4)
        )
        for w in range(n_words):
            v = 0
            for slot in range(3):
                i = w * 3 + slot
                c = ord(text[i]) & 0x7F if i < len(text) else 0
                v |= c << (14 - 7 * slot)
            data[msg_ptr + w] = v
        msg_ptr += n_words

    words = np.array([encode_codeword(int(d)) for d in data], np.uint64)
    parts = [_SYNC_BITS]
    fiw_cw = encode_codeword(make_fiw(cycle, frame))
    parts.append(np.array([(fiw_cw >> (31 - i)) & 1 for i in range(32)], np.uint8))
    for blk in range(BLOCKS_PER_FRAME):
        parts.append(
            interleave_block(words[blk * WORDS_PER_BLOCK : (blk + 1) * WORDS_PER_BLOCK])
        )
    return np.concatenate(parts)
