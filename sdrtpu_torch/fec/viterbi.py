"""Convolutional encoding + soft-decision Viterbi decoding (PyTorch
counterpart of ``sdrtpu/fec/viterbi.py``).

Any constraint length and polynomials of a feed-forward code (e.g. CCSDS
rate-1/2 K=7, polys 0o171/0o133: Meteor LRPT, falcon9, RyFi).  Soft
symbols are floats where positive means bit 0.

`ConvEncoder` is a host numpy copy of the reference's.  `ViterbiDecoder`
decodes a whole block on the decoder's device: on a CUDA tensor one
`viterbi_decode` launch (``csrc/viterbi.cu``: add-compare-select and
traceback; rate 1/2, 1/3 or 1/4, K <= 7), on a CPU tensor the plain
PyTorch loop `viterbi_decode_ref`, and only then; `decode_rows` decodes
several independent blocks in one launch.  Both repeat the reference's
arithmetic (branch metric = the R exact products summed in r order,
each add rounded, first-maximum pick, normalisation by the maximum), so
kernel and plain loop agree to the bit.  At rate 1/2 that is also the
JAX package's order; at R = 3 or 4 its einsum may sum the products in
another order, which gives the same bits whenever the sums are exact
(DAB's +-1 and 0 soft symbols) and agrees within float32 rounding
otherwise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, resolve_device
from ..graph.block import StreamOp

CCSDS_POLY_A = 0o171  # 0x79
CCSDS_POLY_B = 0o133  # 0x5B


def _poly_parity_table(constraint_len: int, polys: tuple[int, ...]) -> np.ndarray:
    """out[state, bit, r] = encoded bit for shift-register value."""
    K = constraint_len
    S = 1 << (K - 1)
    out = np.zeros((S, 2, len(polys)), np.uint8)
    for s in range(S):
        for b in (0, 1):
            reg = (b << (K - 1)) | s  # newest bit at MSB
            for r, p in enumerate(polys):
                out[s, b, r] = bin(reg & p).count("1") & 1
    return out


class ConvEncoder:
    """Feed-forward convolutional encoder (host NumPy)."""

    def __init__(self, constraint_len: int = 7, polys=(CCSDS_POLY_A, CCSDS_POLY_B)):
        self.K = constraint_len
        self.polys = tuple(polys)
        self.rate = len(self.polys)
        self._table = _poly_parity_table(self.K, self.polys)

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """bits (N,) 0/1 -> coded (N*rate,) 0/1, zero-flushed start state."""
        state = 0
        out = np.empty(len(bits) * self.rate, np.uint8)
        S_mask = (1 << (self.K - 1)) - 1
        for i, b in enumerate(np.asarray(bits, np.uint8)):
            out[i * self.rate : (i + 1) * self.rate] = self._table[state, b]
            state = ((state >> 1) | (b << (self.K - 2))) & S_mask
        return out

    def encode_to_soft(self, bits: np.ndarray, amplitude: float = 1.0) -> np.ndarray:
        """Coded bits mapped to soft floats: bit 0 -> +amp, bit 1 -> -amp."""
        coded = self.encode(bits).astype(np.float32)
        return (1.0 - 2.0 * coded) * amplitude


def viterbi_decode_ref(sym, exp_prev, prev, prev_bit):
    """Plain PyTorch version of `viterbi_decode`, all rows at once.

    ``sym`` (rows, n, R) float32; ``exp_prev`` (S, 2, R) expected symbols
    of the branches into each state; ``prev``, ``prev_bit`` (S, 2) the
    branches' predecessor states and bits.  Returns (bits (rows, n)
    uint8, final metrics (rows, S) float32).
    """
    dev = sym.device
    rows, n, R = sym.shape
    e = torch.as_tensor(exp_prev, dtype=torch.float32, device=dev)
    prev_t = torch.as_tensor(prev, dtype=torch.int64, device=dev)
    pbit_t = torch.as_tensor(prev_bit, dtype=torch.uint8, device=dev)
    S = prev_t.shape[0]
    # branch metrics of every step: <r, expected>, summed in r order
    prods = sym[:, :, None, None, :] * e
    bm = prods[..., 0]
    for r in range(1, R):
        bm = bm + prods[..., r]
    metrics = torch.full((rows, S), -1e9, dtype=torch.float32, device=dev)
    metrics[:, 0] = 0.0
    choices = torch.empty((rows, n, S), dtype=torch.bool, device=dev)
    for i in range(n):
        cand = metrics[:, prev_t] + bm[:, i]
        pick = cand[..., 1] > cand[..., 0]  # the first maximum
        best = torch.where(pick, cand[..., 1], cand[..., 0])
        metrics = best - best.amax(dim=-1, keepdim=True)
        choices[:, i] = pick
    state = metrics.argmax(dim=-1)  # the first maximum
    at = torch.arange(rows, device=dev)
    bits = torch.empty((rows, n), dtype=torch.uint8, device=dev)
    for i in range(n - 1, -1, -1):
        j = choices[at, i, state].to(torch.int64)
        bits[:, i] = pbit_t[state, j]
        state = prev_t[state, j]
    return bits, metrics


def viterbi_decode(sym, exp_prev, prev, prev_bit):
    """Decoded bits and final metrics of each row of ``sym``: see
    `viterbi_decode_ref` for the arguments.  CPU tensors:
    `viterbi_decode_ref`.  CUDA tensors: the kernel on the current stream
    (``viterbi_decode.launches`` counts); no fallback.  The kernel takes
    rate 1/R for R in {2, 3, 4} and S = 2^(K-1) <= 64 states of the
    reference's shift-register trellis, and raises otherwise."""
    if sym.device.type == "cpu":
        return viterbi_decode_ref(sym, exp_prev, prev, prev_bit)
    if sym.device.type != "cuda":
        raise ValueError(f"viterbi_decode: unsupported device {sym.device}")
    if sym.dtype != torch.float32 or sym.ndim != 3 or not sym.is_contiguous():
        raise ValueError(f"viterbi_decode: want contiguous (rows, n, R) "
                         f"float32, got {sym.dtype} {tuple(sym.shape)}")
    rows, n, R = sym.shape
    prev, prev_bit = np.asarray(prev), np.asarray(prev_bit)
    S = prev.shape[0]
    K = S.bit_length()
    s = np.arange(S)
    trellis = (S == 1 << (K - 1) and 2 <= K <= 7
               and np.array_equal(prev, np.stack(
                   [(s << 1) & (S - 1), ((s << 1) & (S - 1)) | 1], axis=1))
               and np.array_equal(prev_bit, np.stack([s >> (K - 2)] * 2, 1)))
    if not 2 <= R <= 4 or not trellis or not 1 <= rows < 2 ** 31:
        raise ValueError(f"viterbi_decode: the kernel takes R in (2, 3, 4) "
                         f"and the shift-register trellis of K <= 7, got "
                         f"R {R}, S {S}, rows {rows}")
    bits = torch.empty((rows, n), dtype=torch.uint8, device=sym.device)
    metrics = torch.empty((rows, S), dtype=torch.float32, device=sym.device)
    if n == 0:
        metrics.fill_(-1e9)
        metrics[:, 0] = 0.0
        return bits, metrics
    e = torch.as_tensor(np.asarray(exp_prev, np.float32),
                        device=sym.device).contiguous()
    choices = torch.empty((rows, n, 2), dtype=torch.int32, device=sym.device)
    entry = _build.bind("viterbi", "viterbi_decode_launch",
                        (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) * 2
                        + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
    _build.launch(viterbi_decode, entry, sym.device, sym.data_ptr(),
                  e.data_ptr(), choices.data_ptr(), bits.data_ptr(),
                  metrics.data_ptr(), rows, n, K, R)
    return bits, metrics


viterbi_decode.launches = 0


class ViterbiDecoder(StreamOp):
    """Block soft-decision Viterbi decoder.

    ``decode(soft)`` takes (N*rate,) soft symbols (positive means bit 0;
    a tensor on any device or host numpy, moved to the decoder's device)
    and returns (N,) decoded bits, uint8 on the decoder's device.  The
    whole block is decoded at once (truncated traceback from the best
    final state).
    """

    def __init__(self, constraint_len: int = 7, polys=(CCSDS_POLY_A, CCSDS_POLY_B),
                 device="cuda"):
        self.device = resolve_device(device)
        self.K = constraint_len
        self.polys = tuple(polys)
        self.rate = len(self.polys)
        self.S = 1 << (self.K - 1)
        table = _poly_parity_table(self.K, self.polys).astype(np.float32)
        # expected soft symbols (+1 for bit0, -1 for bit1): (S, 2, R)
        self.expected = 1.0 - 2.0 * table
        s = np.arange(self.S)
        self.next_state = np.stack(
            [((s >> 1) | (b << (self.K - 2))).astype(np.int32) for b in (0, 1)],
            axis=1,
        )  # (S, 2)
        # predecessor table: for next state ns, the two (prev_state, bit)
        prev = np.zeros((self.S, 2), np.int32)
        prev_bit = np.zeros((self.S, 2), np.int32)
        cnt = np.zeros(self.S, np.int32)
        for st in range(self.S):
            for b in (0, 1):
                ns = self.next_state[st, b]
                prev[ns, cnt[ns]] = st
                prev_bit[ns, cnt[ns]] = b
                cnt[ns] += 1
        assert np.all(cnt == 2)
        self.prev = prev
        self.prev_bit = prev_bit
        # branch into ns via (prev, prev_bit): its expected symbols
        self.exp_prev = self.expected[prev, prev_bit]  # (S, 2, R)

    def decode(self, soft) -> torch.Tensor:
        soft = torch.as_tensor(soft, dtype=torch.float32, device=self.device)
        return self.decode_rows(soft[None])[0]

    def decode_rows(self, soft) -> torch.Tensor:
        """(rows, N*rate) soft symbols -> (rows, N) bits: each row an
        independent block, all decoded by one launch (the same bits as a
        `decode` of each row)."""
        soft = torch.as_tensor(soft, dtype=torch.float32, device=self.device)
        rows = soft.shape[0]
        n = soft.shape[-1] // self.rate
        sym = soft[:, : n * self.rate].reshape(rows, n, self.rate).contiguous()
        bits, _ = viterbi_decode(sym, self.exp_prev, self.prev, self.prev_bit)
        return bits

    # StreamOp interface: stateless block decode
    def init_state(self):
        return ()

    def __call__(self, state, soft):
        return state, self.decode(soft)
