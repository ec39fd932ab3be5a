"""KG-STV image-mode decoder (PyTorch counterpart of
``sdrtpu/decoders/kg_sstv.py``; ``decoder_modules/kg_sstv_decoder``).

Reference chain (``kg_sstv_decoder/src/kg_sstv_dsp.h:226-279``):
FM discriminator (300 Hz deviation) -> RRC FIR (31 taps, 1200 baud,
beta 0.7) -> M&M clock recovery -> soft-symbol deframer
(``kg_sstv_dsp.h:113-224``): 63-bit sync word match (<=4 errors),
108 soft symbols per frame, scramble inversion, soft-decision
convolutional decode (K=7, polys 0o155/0o117 — ``kg_sstv_dsp.h:55``).

The port's structure, as the reference package's:

- The demod front end is the port's stream ops on the chain's device
  (`Quadrature`, `Fir`, the float `MuellerMuller`: one `mm_scan` launch a
  block on the card); the valid symbols come to the host once a block.
- Sync is a block-parallel correlation against the 63-bit pattern: every
  alignment is scored at once and any position with <=4 bit errors
  starts a frame (the symmetric Hamming distance, stricter than the
  reference's matcher).
- FEC is the port's `ViterbiDecoder` (one `viterbi_decode` launch a
  frame on the card): 108 coded symbols decode to 54 bits = 6 payload
  bytes + 6 flush bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fec.viterbi import ConvEncoder, ViterbiDecoder
from ..graph.block import StreamOp
from ..kernels import taps as tapsmod
from ..kernels.clock import MuellerMuller
from ..kernels.demod import Quadrature
from ..kernels.fir import Fir

DEVIATION = 300.0  # kg_sstv_dsp.h:14
BAUDRATE = 1200.0  # kg_sstv_dsp.h:15
RRC_ALPHA = 0.7  # kg_sstv_dsp.h:16
RRC_TAPS = 31  # kg_sstv_dsp.h:238
POLYS = (0o155, 0o117)  # kg_sstv_dsp.h:55
FRAME_SYMBOLS = 108  # kg_sstv_dsp.h:179
DATA_BITS = FRAME_SYMBOLS // 2 - 6  # 54 coded-pair bits minus K-1 flush
SYNC_MAX_ERRORS = 4  # kg_sstv_dsp.h:149

# kg_sstv_dsp.h:30-35 — 63-symbol sync word (bit 1 <=> positive symbol)
SYNC_WORD = np.array(
    [0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 1, 0,
     0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0,
     1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1,
     0, 1, 0, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0],
    np.uint8,
)

# kg_sstv_dsp.h:37-46 — per-symbol scramble flags (first 108 used)
SCRAMBLING = np.array(
    [1, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0,
     1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1,
     0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0,
     1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 0,
     0, 0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1,
     0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1,
     1, 0, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0,
     0, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1],
    np.uint8,
)


class KgSstvDemod(StreamOp):
    """IQ -> soft 2FSK symbols (``kg_sstv_dsp.h:234-246``)."""

    def __init__(
        self,
        samplerate: float,
        omega_gain: float = 1e-6,
        mu_gain: float = 0.01,
        omega_rel_limit: float = 0.01,
        device="cuda",
    ):
        rrc = tapsmod.root_raised_cosine_rate(
            RRC_TAPS, RRC_ALPHA, BAUDRATE, samplerate
        )
        self.quad = Quadrature(DEVIATION, samplerate, device=device)
        self.rrc = Fir(rrc, dtype=torch.float32, device=device)
        self.recov = MuellerMuller(
            samplerate / BAUDRATE,
            omega_gain,
            mu_gain,
            omega_rel_limit,
            complex_mode=False,
            device=device,
        )

    def max_out(self, n: int) -> int:
        return self.recov.max_out(n)

    def init_state(self):
        return {
            "quad": self.quad.init_state(),
            "rrc": self.rrc.init_state(),
            "mm": self.recov.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["quad"], y = self.quad(state["quad"], x)
        st["rrc"], y = self.rrc(state["rrc"], y)
        st["mm"], (syms, valid) = self.recov(state["mm"], y)
        return st, (syms, valid)


class KgSstvDeframer:
    """Soft symbols -> 6-byte decoded frames (``kg_sstv_dsp.h:113-224``).

    Host-side framing (data-dependent frame starts) around the port's
    Viterbi on ``device``; call ``process`` with each soft-symbol block,
    get a list of decoded frames back.
    """

    def __init__(self, device="cuda"):
        self.viterbi = ViterbiDecoder(7, POLYS, device=device)
        self._buf = np.zeros(0, np.float32)
        self.frames_seen = 0

    def _decode_frame(self, soft: np.ndarray) -> bytes:
        # descramble: scramble bit set => symbol inverted (255-v byte-domain
        # inversion at kg_sstv_dsp.h:185-191 == sign flip in soft domain)
        soft = np.where(SCRAMBLING[:FRAME_SYMBOLS] == 1, -soft, soft)
        # positive symbol <=> coded bit 1; shared Viterbi wants + <=> bit 0
        bits = self.viterbi.decode(-soft)[:DATA_BITS].cpu().numpy()
        self.frames_seen += 1
        return np.packbits(bits).tobytes()

    def process(self, symbols: np.ndarray) -> list[bytes]:
        buf = np.concatenate([self._buf, np.asarray(symbols, np.float32)])
        out: list[bytes] = []
        ns = len(SYNC_WORD)
        pos = 0
        while True:
            search = buf[pos:]
            if search.size < ns + FRAME_SYMBOLS:
                break
            hard = (search > 0.0).astype(np.uint8)
            # correlation sync: Hamming distance at every alignment at once
            n_align = search.size - (ns + FRAME_SYMBOLS) + 1
            windows = np.lib.stride_tricks.sliding_window_view(hard, ns)[
                :n_align
            ]
            dist = np.count_nonzero(windows != SYNC_WORD, axis=1)
            hits = np.nonzero(dist <= SYNC_MAX_ERRORS)[0]
            if hits.size == 0:
                pos += n_align
                break
            start = pos + int(hits[0]) + ns
            out.append(self._decode_frame(buf[start : start + FRAME_SYMBOLS]))
            pos = start + FRAME_SYMBOLS
        self._buf = buf[pos:]
        return out


class KgSstvDecoder:
    """Full KG-STV receive path: IQ blocks (host numpy or a tensor) in,
    frame bytes out; demodulator and Viterbi on ``device``."""

    def __init__(self, samplerate: float, device="cuda"):
        self.demod = KgSstvDemod(samplerate, device=device)
        self.device = self.demod.quad.device
        self.deframer = KgSstvDeframer(device=self.device)
        self.state = self.demod.init_state()

    def process(self, iq) -> list[bytes]:
        with torch.inference_mode():
            x = torch.as_tensor(iq, device=self.device).to(torch.complex64)
            self.state, (syms, valid) = self.demod(self.state, x)
            soft = syms[valid].cpu().numpy()
            return self.deframer.process(soft)


def encode_frame(payload: bytes) -> np.ndarray:
    """6-byte payload -> 171 ±1 symbols (sync + scrambled coded bits).

    Transmit-side inverse of the deframer, for loopback tests (the
    reference has no transmitter for this mode).
    """
    if len(payload) != DATA_BITS // 8 + (1 if DATA_BITS % 8 else 0):
        raise ValueError(f"payload must be {DATA_BITS // 8} bytes")
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))[:DATA_BITS]
    bits = np.concatenate([bits, np.zeros(6, np.uint8)])  # K-1 flush
    coded = ConvEncoder(7, POLYS).encode(bits)  # 108 bits, 1 <=> positive
    sym = 2.0 * coded.astype(np.float32) - 1.0
    sym = np.where(SCRAMBLING[:FRAME_SYMBOLS] == 1, -sym, sym)
    sync = 2.0 * SYNC_WORD.astype(np.float32) - 1.0
    return np.concatenate([sync, sym])
