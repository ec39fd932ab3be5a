"""RDS: the DSP demodulation chain and the bit-level group decoder
(PyTorch counterpart of ``sdrtpu/decoders/rds.py``).

DSP chain (``decoder_modules/radio/src/rds_demod.h:19-88``), on the
5 ksps complex RDS baseband tapped off the WFM demod (`BroadcastFm`'s
``rds_out``):

    FastAGC(1.0, 1e6, 0.1) -> Costas(2, 0.005) ->
    bandpass 0..2375 Hz (trans 100) -> Costas(2, 0.01) centered at the
    1187.5 Hz baud rate (+/-10%) -> Re -> M&M(float, sps=5000/1187.5,
    1e-6, 0.01) -> slicer -> differential decode

On the card each block is two `costas_scan` launches and one `mm_scan`.
The differential decode carries the last *valid* hard bit from one
block to the next.  (The reference decodes its masked M&M output and
carries the last slot, which is always an invalid padding slot, i.e. 0;
so each of its blocks' first bit is decoded against 0.  The port does
not copy that.)

Bit-level decoder (``decoder_modules/radio/src/rds.cpp``), a host copy
of the reference's: 26-bit blocks with the RDS CRC (poly 0b0110111001,
input poly 0b1100011011), offset words A/B/C/C'/D, +/-1 sync hysteresis
(0..4), burst error correction via the syndrome LFSR, and group decoding
for PI/PTY/TP plus group 0 (program service name), group 2 (RadioText)
and group 10A (PTYN).  Host Python: the bit rate is 1187.5 bit/s.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from ..kernels import taps as tapsmod
from ..kernels.clock import MuellerMuller
from ..kernels.fir import Fir
from ..kernels.loops import Costas
from ..kernels.psk import FastAgc
from ..kernels.taps import hz_to_rads

RDS_RATE = 5000.0
RDS_BAUD = 2375.0 / 2.0


class RdsDemod(StreamOp):
    """5 ksps RDS baseband -> (bits, valid) masked arrays of length
    ``max_out(n)``; the valid bits are a prefix."""

    def __init__(self, device="cuda"):
        self.device = dev = resolve_device(device)
        self.agc = FastAgc(1.0, 1e6, 0.1, device=dev)
        self.costas = Costas(2, 0.005, device=dev)
        self.fir = Fir(
            tapsmod.band_pass(0.0 + 1e-9, 2375.0, 100.0, RDS_RATE),
            dtype=torch.complex64, device=dev,
        )
        baud_w = hz_to_rads(RDS_BAUD, RDS_RATE)
        self.costas2 = Costas(
            2, 0.01, init_freq=baud_w,
            min_freq=baud_w * 0.9, max_freq=baud_w * 1.1, device=dev,
        )
        self.recov = MuellerMuller(
            RDS_RATE / RDS_BAUD, 1e-6, 0.01, 0.01, complex_mode=False,
            device=dev,
        )

    def max_out(self, n: int) -> int:
        return self.recov.max_out(n)

    def init_state(self):
        return {
            "agc": self.agc.init_state(),
            "c1": self.costas.init_state(),
            "fir": self.fir.init_state(),
            "c2": self.costas2.init_state(),
            "mm": self.recov.init_state(),
            # the last valid hard bit of the stream so far
            "diff": torch.zeros((), dtype=torch.uint8, device=self.device),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["agc"], y = self.agc(state["agc"], x)
        st["c1"], y = self.costas(state["c1"], y)
        st["fir"], y = self.fir(state["fir"], y)
        st["c2"], y = self.costas2(state["c2"], y)
        st["mm"], (sym, valid) = self.recov(state["mm"], y.real)
        hard = (sym > 0.0).to(torch.uint8)
        # valid slots are a prefix: decode them against the previous
        # block's last valid bit, and carry this block's last valid bit
        prev = torch.cat([state["diff"].reshape(1), hard[:-1]])
        bits = hard ^ prev
        m = valid.sum()
        st["diff"] = torch.where(m > 0, hard[torch.clamp(m - 1, min=0)],
                                 state["diff"])
        return st, (bits, valid)


# --- bit-level decoder ----------------------------------------------------

LFSR_POLY = 0b0110111001
IN_POLY = 0b1100011011
BLOCK_LEN = 26
DATA_LEN = 16
POLY_LEN = 10

BLOCK_A, BLOCK_B, BLOCK_C, BLOCK_CP, BLOCK_D = range(5)

SYNDROMES = {
    0b1111011000: BLOCK_A,
    0b1111010100: BLOCK_B,
    0b1001011100: BLOCK_C,
    0b1111001100: BLOCK_CP,
    0b1001011000: BLOCK_D,
}
OFFSETS = {
    BLOCK_A: 0b0011111100,
    BLOCK_B: 0b0110011000,
    BLOCK_C: 0b0101101000,
    BLOCK_CP: 0b1101010000,
    BLOCK_D: 0b0110110100,
}
NEXT_TYPE = {BLOCK_A: BLOCK_B, BLOCK_B: BLOCK_C, BLOCK_C: BLOCK_D,
             BLOCK_CP: BLOCK_D, BLOCK_D: BLOCK_A}


def calc_syndrome(block: int) -> int:
    syn = 0
    for i in range(BLOCK_LEN - 1, -1, -1):
        out_bit = (syn >> (POLY_LEN - 1)) & 1
        syn = (syn << 1) & 0b1111111111
        syn ^= LFSR_POLY * out_bit
        syn ^= IN_POLY * ((block >> i) & 1)
    return syn


def correct_errors(block: int, btype: int) -> tuple[int, bool]:
    """Burst error correction via the syndrome LFSR (``rds.cpp:209-236``)."""
    block ^= OFFSETS[btype]
    out = block
    syn = calc_syndrome(block)
    error_found = 0
    if syn:
        for i in range(DATA_LEN - 1, -1, -1):
            error_found |= int(not (syn & 0b11111))
            out_bit = (syn >> (POLY_LEN - 1)) & 1
            out ^= (error_found & out_bit) << (i + POLY_LEN)
            syn = (syn << 1) & 0b1111111111
            syn ^= LFSR_POLY * out_bit * (not error_found)
    recovered = not (syn & 0b11111)
    return out, recovered


class RdsDecoder:
    """Stateful RDS group decoder fed with demodulated bits."""

    def __init__(self):
        self.shift_reg = 0
        self.skip = 0
        self.sync = 0
        self.last_type = BLOCK_A
        self.cont_group = 0
        self.blocks = [0] * 5
        self.block_avail = [False] * 5
        self.pi_code = None
        self.pty = None
        self.traffic_program = None
        self.ps_name = [" "] * 8
        self.radio_text = [" "] * 64
        self.rt_ab = False
        self.ptn = [" "] * 8
        self.ptn_ab = False
        self.group_ver = 0  # 0 = A, 1 = B

    def process(self, bits: np.ndarray) -> None:
        for b in np.asarray(bits, np.uint8):
            self.shift_reg = ((self.shift_reg << 1) & 0x3FFFFFF) | int(b & 1)
            self.skip -= 1
            if self.skip > 0:
                continue
            syn = calc_syndrome(self.shift_reg)
            known = syn in SYNDROMES
            self.sync = int(np.clip(self.sync + (1 if known else -1), 0, 4))
            if not self.sync:
                continue
            btype = SYNDROMES[syn] if known else NEXT_TYPE[self.last_type]
            corrected, ok = correct_errors(self.shift_reg, btype)
            self.blocks[btype] = corrected
            self.block_avail[btype] = ok

            if btype == BLOCK_A:
                self._decode_a()
            elif btype == BLOCK_B:
                self.cont_group = 1
            elif btype in (BLOCK_C, BLOCK_CP) and self.last_type == BLOCK_B:
                self.cont_group += 1
            elif btype == BLOCK_D and self.last_type in (BLOCK_C, BLOCK_CP):
                self.cont_group += 1
            else:
                self.cont_group = 0

            if self.cont_group >= 3:
                self.cont_group = 0
                self._decode_group()

            self.last_type = btype
            self.skip = BLOCK_LEN

    def _data(self, btype: int) -> int:
        return (self.blocks[btype] >> 10) & 0xFFFF

    def _decode_a(self):
        if not self.block_avail[BLOCK_A]:
            return
        self.pi_code = self._data(BLOCK_A)

    def _decode_group(self):
        if not self.block_avail[BLOCK_B]:
            return
        b = self._data(BLOCK_B)
        group_type = (b >> 12) & 0xF
        self.group_ver = (b >> 11) & 1
        self.traffic_program = bool((b >> 10) & 1)
        self.pty = (b >> 5) & 0x1F

        if group_type == 0:
            offset = b & 0b11
            if self.block_avail[BLOCK_D]:
                d = self._data(BLOCK_D)
                self.ps_name[offset * 2] = chr((d >> 8) & 0xFF)
                self.ps_name[offset * 2 + 1] = chr(d & 0xFF)
        elif group_type == 2:
            n_ab = bool((b >> 4) & 1)
            offset = b & 0xF
            if n_ab != self.rt_ab:
                self.radio_text = [" "] * 64
            self.rt_ab = n_ab
            if self.group_ver == 0:
                base = offset * 4
                if self.block_avail[BLOCK_C]:
                    c = self._data(BLOCK_C)
                    self.radio_text[base] = chr((c >> 8) & 0xFF)
                    self.radio_text[base + 1] = chr(c & 0xFF)
                if self.block_avail[BLOCK_D]:
                    d = self._data(BLOCK_D)
                    self.radio_text[base + 2] = chr((d >> 8) & 0xFF)
                    self.radio_text[base + 3] = chr(d & 0xFF)
            else:
                base = offset * 2
                if self.block_avail[BLOCK_D]:
                    d = self._data(BLOCK_D)
                    self.radio_text[base] = chr((d >> 8) & 0xFF)
                    self.radio_text[base + 1] = chr(d & 0xFF)
        elif group_type == 10 and self.group_ver == 0:
            # 10A: Program Type Name, 8 chars in two 4-char segments
            # (reference `rds.cpp:360-398` decodeGroup10)
            ab = bool((b >> 4) & 1)
            if ab != self.ptn_ab:
                self.ptn = [" "] * 8
            self.ptn_ab = ab
            base = 4 if (b & 1) else 0
            if self.block_avail[BLOCK_C]:
                c = self._data(BLOCK_C)
                self.ptn[base] = chr((c >> 8) & 0xFF)
                self.ptn[base + 1] = chr(c & 0xFF)
            if self.block_avail[BLOCK_D]:
                d = self._data(BLOCK_D)
                self.ptn[base + 2] = chr((d >> 8) & 0xFF)
                self.ptn[base + 3] = chr(d & 0xFF)

    @property
    def program_service_name(self) -> str:
        return "".join(self.ps_name)

    @property
    def radiotext(self) -> str:
        return "".join(self.radio_text)

    @property
    def program_type_name(self) -> str:
        return "".join(self.ptn)


def encode_group(pi: int, group_type: int, version: int, b_low: int,
                 c_word: int, d_word: int) -> np.ndarray:
    """Build the 104-bit RDS group (for tests): 4 blocks with CRC+offsets."""

    def crc(word: int) -> int:
        # the 10 check bits that make the block's syndrome zero
        for check in range(1024):
            if calc_syndrome((word << 10) | check) == 0:
                return check
        raise AssertionError

    # EVERY version-B group uses offset C' in block 3 (IEC 62106 2.1.5.2),
    # including type 0B
    btypes = [BLOCK_A, BLOCK_B, BLOCK_CP if version else BLOCK_C, BLOCK_D]
    b_word = (group_type << 12) | (version << 11) | (b_low & 0x7FF)
    words = [pi, b_word, c_word, d_word]
    bits = []
    for word, btype in zip(words, btypes):
        block = (word << 10) | crc(word)
        block ^= OFFSETS[btype]
        bits.extend((block >> i) & 1 for i in range(BLOCK_LEN - 1, -1, -1))
    return np.asarray(bits, np.uint8)
