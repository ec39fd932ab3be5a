"""POCSAG pager decoder (PyTorch counterpart of
``sdrtpu/decoders/pocsag.py``; ``decoder_modules/pager_decoder/src/pocsag``).

The bit layer is host code, copied from the reference as it is; `process`
takes a numpy array or a tensor of bits on any device.

Bit layer: sync on the frame sync codeword 0x7CD215D8 (<=4 bit errors),
batches of 16 x 32-bit codewords; each codeword is BCH(31,21) + even
parity.  Address codewords carry the 18 MSBs of the address (3 LSBs from
the frame position) and 2 function bits; message codewords carry 20 data
bits — 5 BCD digits (numeric) or a 7-bit-reversed ASCII stream
(alphanumeric).

Improvement over the reference: `correct_codeword` actually performs the
BCH(31,21) double-error correction (generator 0b11101101001) that the
reference stubs out (``pocsag.cpp:80-84``).

DSP front end: FSK at 512/1200/2400 baud, `kernels.psk.Gfsk` (the FM
discriminator, RRC and the float M&M, one `mm_scan` launch a block on
the card), hard decisions ``symbol < 0`` -> 1.
"""

from __future__ import annotations

import functools

import numpy as np

from ..convert import to_numpy

FRAME_SYNC = 0b01111100110100100001010111011000
IDLE_DATA = 0x7A89C197 >> 11  # standard idle codeword's 21-bit data field
GEN_POLY = 0b11101101001  # degree-10 BCH generator
SYNC_DIST = 4
BATCH_CODEWORDS = 16

NUMERIC_CHARSET = "0123456789*U -]["

MESSAGE_NUMERIC = 0b00
MESSAGE_ALPHA = 0b11


def _bch_syndrome(cw31: int) -> int:
    reg = cw31
    for i in range(30, 9, -1):
        if reg & (1 << i):
            reg ^= GEN_POLY << (i - 10)
    return reg & 0x3FF


@functools.cache
def _syndrome_table() -> dict[int, int]:
    """Syndrome -> error pattern of weight 0, 1 or 2 (first found)."""
    table = {0: 0}
    for i in range(31):
        table.setdefault(_bch_syndrome(1 << i), 1 << i)
    for i in range(31):
        for j in range(i + 1, 31):
            p = (1 << i) | (1 << j)
            table.setdefault(_bch_syndrome(p), p)
    return table


def encode_codeword(data21: int) -> int:
    """21 data bits -> 32-bit codeword (BCH check bits + even parity)."""
    data21 &= 0x1FFFFF
    cw31 = data21 << 10
    check = _bch_syndrome(cw31)
    cw31 |= check
    parity = bin(cw31).count("1") & 1
    return (cw31 << 1) | parity


def correct_codeword(cw: int) -> int | None:
    """32-bit codeword -> corrected codeword, or None if uncorrectable."""
    cw31 = cw >> 1
    syn = _bch_syndrome(cw31)
    if syn == 0:
        return cw
    err = _syndrome_table().get(syn)
    if err is None:
        return None
    cw31 ^= err
    parity = bin(cw31).count("1") & 1
    return (cw31 << 1) | parity


class PocsagDecoder:
    """Feed bits; emits (address, message_type, text) via ``messages``."""

    def __init__(self):
        self.sync_sr = 0
        self.synced = False
        self.batch_bits: list[int] = []
        self.messages: list[tuple[int, int, str]] = []
        self._addr = 0
        self._msg_type = MESSAGE_ALPHA
        self._msg = ""
        self._char = 0
        self._char_off = 0
        self._gap = 0

    def process(self, bits) -> None:
        for b in to_numpy(bits).astype(np.uint8, copy=False):
            b = int(b & 1)
            if not self.synced:
                self.sync_sr = ((self.sync_sr << 1) | b) & 0xFFFFFFFF
                self._gap += 1
                if bin(self.sync_sr ^ FRAME_SYNC).count("1") <= SYNC_DIST:
                    self.synced = True
                    self.batch_bits = []
                    self._gap = 0
                elif self._gap == 64:
                    # in-transmission batches are separated by exactly one
                    # 32-bit sync codeword: a longer gap means the carrier
                    # dropped, so the open message (if any) is complete.
                    # (A message may span BATCHES — it ends only at the
                    # next address/idle codeword or end of transmission.)
                    self.flush()
                continue
            self.batch_bits.append(b)
            if len(self.batch_bits) >= BATCH_CODEWORDS * 32:
                self._decode_batch()
                self.batch_bits = []
                self.synced = False
                self._gap = 0

    def flush(self) -> None:
        """End of transmission: emit any open message."""
        if self._msg:
            self.messages.append((self._addr, self._msg_type, self._msg))
        self._msg = ""
        self._char = 0
        self._char_off = 0

    _flush = flush

    def _decode_batch(self):
        for i in range(BATCH_CODEWORDS):
            bits = self.batch_bits[i * 32 : (i + 1) * 32]
            cw = 0
            for b in bits:
                cw = (cw << 1) | b
            fixed = correct_codeword(cw)
            if fixed is None:
                continue
            cw = fixed
            is_message = (cw >> 31) & 1
            if not is_message and (cw >> 11) == IDLE_DATA:
                self._flush()
                continue
            if not is_message:
                self._flush()
                self._msg_type = (cw >> 11) & 0b11
                self._addr = (((cw >> 13) & 0x3FFFF) << 3) | (i >> 1)
            else:
                data = (cw >> 11) & 0xFFFFF
                if self._msg_type == MESSAGE_NUMERIC:
                    for shift in (16, 12, 8, 4, 0):
                        nib = (data >> shift) & 0xF
                        # BCD digits are transmitted LSB-first (like the
                        # 7-bit alphanumeric path below): reverse the
                        # nibble before indexing the charset
                        nib = ((nib & 1) << 3) | ((nib & 2) << 1) \
                            | ((nib & 4) >> 1) | ((nib & 8) >> 3)
                        self._msg += NUMERIC_CHARSET[nib]
                else:
                    for k in range(19, -1, -1):
                        self._char |= ((data >> k) & 1) << self._char_off
                        self._char_off += 1
                        if self._char_off == 7:
                            if self._char:
                                self._msg += chr(self._char)
                            self._char = 0
                            self._char_off = 0
        # NO flush here: an alphanumeric message routinely continues in
        # the next batch (after its 32-bit sync codeword); it is closed
        # by the next address/idle codeword or by carrier drop (flush()).


def build_transmission(
    addr: int, text: str, msg_type: int = MESSAGE_ALPHA, frame: int = 0
) -> np.ndarray:
    """Encode a POCSAG transmission (for tests/tx).

    Long messages continue across batch boundaries (each batch prefixed
    by its own frame-sync codeword), as real pages do.
    """
    idle = encode_codeword(IDLE_DATA)
    pos = frame * 2
    addr_data = (0 << 20) | (((addr >> 3) & 0x3FFFF) << 2) | msg_type
    # pack message bits (both alpha chars and BCD nibbles go LSB-first)
    bits = []
    if msg_type == MESSAGE_NUMERIC:
        for ch in text:
            nib = NUMERIC_CHARSET.index(ch)
            for k in range(4):
                bits.append((nib >> k) & 1)
    else:
        for ch in text:
            for k in range(7):
                bits.append((ord(ch) >> k) & 1)
    while len(bits) % 20:
        bits.append(0)
    words = []
    for off in range(0, len(bits), 20):
        data = 0
        for k in range(20):
            data |= bits[off + k] << (19 - k)
        words.append(encode_codeword((1 << 20) | data))

    batches = []
    cws = [idle] * BATCH_CODEWORDS
    cws[pos] = encode_codeword(addr_data)
    idx = pos + 1
    for w in words:
        if idx >= BATCH_CODEWORDS:
            batches.append(cws)
            cws = [None] * BATCH_CODEWORDS
            idx = 0
        cws[idx] = w
        idx += 1
    for i in range(idx, BATCH_CODEWORDS):
        cws[i] = idle
    batches.append(cws)

    out = [1, 0] * 288  # preamble
    for batch in batches:
        for b in range(31, -1, -1):
            out.append((FRAME_SYNC >> b) & 1)
        for cw in batch:
            for b in range(31, -1, -1):
                out.append((cw >> b) & 1)
    out.extend([0] * 80)  # carrier drop closes any open message
    return np.asarray(out, np.uint8)
