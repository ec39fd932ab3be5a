"""Symbol timing recovery (PyTorch counterpart of ``sdrtpu/kernels/clock.py``).

`MuellerMuller` is the reference's M&M synchroniser: a polyphase-bank
fractional interpolator (by default 128 phases x 8 taps, Nuttall windowed
sinc)
driven by a second-order loop whose per-output input stride depends on
the data (``offset += floor(phase)``).  Its outputs keep the reference's
static shape: ``max_out(n)`` slots and a validity mask.  On a CUDA tensor
the loop over output symbols is one `mm_scan` launch (``csrc/
sync_loops.cu``); on a CPU tensor the wrapper runs the plain PyTorch loop
`mm_scan_ref`, and only then.  Both take the tap sum as a pairwise tree
in the same order, so they agree to the last place and make the same
``floor`` decisions.  The kernel takes up to 32 taps (its bank padded
with zero taps to 8, 16 or 32) and any phase count whose bank fits the
shared memory one block may take on the card.

`costas_mm_scan` runs a Costas loop and the complex M&M behind it, on its
output, in one launch (``costas_scan_into_mm_scan``, two warps a row: the
M&M walk follows the Costas walk a window behind it); `MeteorDemod`
takes it where no Q delay stands between the loops.

`FeedforwardSymbolSync` is the block-parallel alternative (Oerder & Meyr
timing per block, then interpolation at that phase): no carry, plain
torch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build, resolve_device
from .._precision import fp32_contractions
from ..graph.block import StreamOp
from ..graph.cuda_graph import count_launches
from . import loops
from . import taps as tapsmod
from .loops import _f32, _sign
from .resample import build_polyphase_bank

_MM_TAP_WIDTHS = (8, 16, 32)  # the kernel's padded interpolator lengths
# M&M's carries as `MuellerMuller`'s state keeps them, after its tail
_MM_LEAVES = (("offset", torch.int32), ("phase", torch.float32),
              ("freq", torch.float32), ("last_out", torch.float32),
              ("p1", torch.complex64), ("p2", torch.complex64),
              ("c1", torch.complex64), ("c2", torch.complex64))


def interp_bank(phase_count: int = 128, tap_count: int = 8) -> np.ndarray:
    """Fractional-delay interpolator bank (``mm.h:generateInterpTaps``)."""
    bw = 0.5 / phase_count
    proto = tapsmod.windowed_sinc(
        phase_count * tap_count,
        tapsmod.hz_to_rads(bw, 1.0),
        norm=phase_count,
    )
    return build_polyphase_bank(phase_count, proto)


def _tree_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree (neighbours first), the
    order of the kernel's ``tree8``; an odd width gets a zero."""
    while p.shape[-1] > 1:
        if p.shape[-1] % 2:
            p = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def mm_scan_ref(ext, bank, n, n_out, offset0, fstate0, cstate0, fmin, fmax,
                omega_gain, mu_gain):
    """Plain PyTorch version of `mm_scan`: the loop over output symbols,
    all rows at once.

    ``ext`` (rows, L) complex64 or float32 (carried tail ++ block of
    ``n``); ``bank`` (P, T) float32; ``offset0`` (rows,) int32; ``fstate0``
    (rows, 3) float32 = (phase, freq, last); ``cstate0`` (rows, 4)
    complex64 = (p1, p2, c1, c2).  Returns ``(syms, valid, offset, fstate,
    cstate)``: ``n_out`` slots per row, the valid ones first, the rest 0;
    the offset unreduced.
    """
    cplx = ext.is_complex()
    rows, L = ext.shape
    P, T = bank.shape
    taps_at = torch.arange(T, device=ext.device)
    offset = offset0.to(torch.int32).clone()
    phase, freq, last = (fstate0[:, k].clone() for k in range(3))
    p1, p2, c1, c2 = (cstate0[:, k].clone() for k in range(4))
    syms, valid = [], []
    for _ in range(n_out):
        ok = offset < n
        ph = torch.clamp(torch.floor(phase * P).to(torch.int32), 0, P - 1)
        start = torch.clamp(offset, 0, L - T).to(torch.int64)
        win = torch.gather(ext, 1, start[:, None] + taps_at)
        taps = bank[ph.to(torch.int64)]
        if cplx:
            out = torch.complex(_tree_sum(win.real * taps),
                                _tree_sum(win.imag * taps))
            c0 = torch.complex(_sign(out.real), _sign(out.imag))
            d1, d2 = out - p2, c0 - c2
            err = ((d1.real * c1.real + d1.imag * c1.imag)
                   - (d2.real * p1.real + d2.imag * p1.imag))
            p1, p2, c1, c2 = (torch.where(ok, a, b) for a, b in
                              ((out, p1), (p1, p2), (c0, c1), (c1, c2)))
        else:
            out = _tree_sum(win * taps)
            err = _sign(last) * out - last * _sign(out)
            last = torch.where(ok, out, last)
        err = torch.clamp(err, -1.0, 1.0)
        nfreq = torch.clamp(freq + omega_gain * err, fmin, fmax)
        nphase = phase + nfreq + mu_gain * err
        delta = torch.floor(nphase)
        offset = torch.where(ok, offset + delta.to(torch.int32), offset)
        phase = torch.where(ok, nphase - delta, phase)
        freq = torch.where(ok, nfreq, freq)
        syms.append(torch.where(ok, out, torch.zeros_like(out)))
        valid.append(ok)
    if n_out == 0:
        syms = torch.zeros((rows, 0), dtype=ext.dtype, device=ext.device)
        valid = torch.zeros((rows, 0), dtype=torch.bool, device=ext.device)
    else:
        syms, valid = torch.stack(syms, -1), torch.stack(valid, -1)
    return (syms, valid, offset, torch.stack([phase, freq, last], dim=1),
            torch.stack([p1, p2, c1, c2], dim=1))


@functools.cache
def _mm_room(device_index: int, cplx: bool, Tp: int) -> int:
    """The largest bank (bytes) the kernel for ``Tp`` padded taps takes
    on that card (`mm_scan_max_bank_bytes`); the C side opts the kernel
    in to it there, so this runs before the first launch on each card."""
    room = _build.bind("sync_loops", "mm_scan_max_bank_bytes",
                       (ctypes.c_int,) * 2, ctypes.c_longlong)
    with torch.cuda.device(device_index):
        return room(int(cplx), Tp)


def mm_scan(ext, bank, n, n_out, offset0, fstate0, cstate0, fmin, fmax,
            omega_gain, mu_gain):
    """Mueller & Muller symbols of ``n`` new samples: see `mm_scan_ref`
    for the arguments and results.  CPU tensors: `mm_scan_ref`.  CUDA
    tensors: the kernel on the current stream (``mm_scan.launches``
    counts); no fallback.  The kernel takes up to 32 taps and a bank that
    fits one block's shared memory, and raises otherwise."""
    if ext.device.type == "cpu":
        return mm_scan_ref(ext, bank, n, n_out, offset0, fstate0, cstate0,
                           fmin, fmax, omega_gain, mu_gain)
    if ext.device.type != "cuda":
        raise ValueError(f"mm_scan: unsupported device {ext.device}")
    cplx = ext.is_complex()
    want = torch.complex64 if cplx else torch.float32
    if ext.dtype != want or ext.ndim != 2 or not ext.is_contiguous():
        raise ValueError(f"mm_scan: want contiguous 2-D complex64 or float32 "
                         f"ext, got {ext.dtype} {tuple(ext.shape)}")
    rows, L = ext.shape
    P, T = bank.shape
    if not 1 <= T <= _MM_TAP_WIDTHS[-1] or P < 1:
        raise ValueError(f"mm_scan: the kernel takes 1 to "
                         f"{_MM_TAP_WIDTHS[-1]} taps, got bank {(P, T)}")
    if not (1 <= rows < 2 ** 31 and n >= 1 and L == n + T - 1
            and n_out >= 0):
        raise ValueError(f"mm_scan: bad shape ext {(rows, L)}, n {n}")
    Tp = next(w for w in _MM_TAP_WIDTHS if w >= T)
    limit = _mm_room(ext.device.index, cplx, Tp)
    if P * Tp * 4 > limit:
        raise ValueError(f"mm_scan: a bank of {P} phases x {Tp} taps "
                         f"({P * Tp * 4} bytes) exceeds the {limit} bytes of "
                         f"shared memory one block may take on this card")
    bank = bank.to(device=ext.device, dtype=torch.float32)
    if Tp != T:
        bank = torch.nn.functional.pad(bank, (0, Tp - T))
    bank = bank.contiguous()
    offset0 = offset0.to(torch.int32).contiguous()
    fstate0 = fstate0.to(torch.float32).contiguous()
    cstate0 = cstate0.to(torch.complex64).contiguous()
    if (offset0.shape != (rows,) or fstate0.shape != (rows, 3)
            or cstate0.shape != (rows, 4)):
        raise ValueError("mm_scan: carry shapes disagree")
    syms = torch.empty((rows, n_out), dtype=ext.dtype, device=ext.device)
    valid = torch.empty((rows, n_out), dtype=torch.bool, device=ext.device)
    offset = torch.empty_like(offset0)
    fstate = torch.empty_like(fstate0)
    cstate = torch.empty_like(cstate0)
    entry = _build.bind("sync_loops", "mm_scan_launch",
                        (ctypes.c_void_p,) * 10 + (ctypes.c_longlong,) * 4
                        + (ctypes.c_int,) * 4 + (ctypes.c_float,) * 4
                        + (ctypes.c_void_p,))
    _build.launch(mm_scan, entry, ext.device, ext.data_ptr(),
                  bank.data_ptr(), syms.data_ptr(), valid.data_ptr(),
                  offset0.data_ptr(), fstate0.data_ptr(), cstate0.data_ptr(),
                  offset.data_ptr(), fstate.data_ptr(), cstate.data_ptr(),
                  rows, L, n, n_out, P, T, Tp, int(cplx), fmin, fmax,
                  omega_gain, mu_gain)
    return syms, valid, offset, fstate, cstate


mm_scan.launches = 0

# the Costas error modes and the padded tap width `costas_mm_scan` is
# built for: those of the Meteor demodulator
_COSTAS_MM_MODES = (loops.COSTAS_ORDER4, loops.COSTAS_BROKEN)
_COSTAS_MM_TAPS = 8


@functools.cache
def _costas_mm_room(device_index: int) -> int:
    """The largest bank (bytes) `costas_mm_scan`'s kernel takes on that
    card; the C side opts its instances in to the shared memory there,
    so this runs before the first launch on each card."""
    room = _build.bind("sync_loops", "costas_mm_scan_max_bank_bytes", (),
                       ctypes.c_longlong)
    with torch.cuda.device(device_index):
        return room()


def _costas_mm_check(x, tail, phase0, freq0, mode, bank, n_out, carries):
    """Raise unless the arguments are ones `costas_mm_scan` takes."""
    if x.dtype != torch.complex64 or x.ndim != 2:
        raise ValueError(f"costas_mm_scan: want 2-D complex64 x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    rows, n = x.shape
    if bank.ndim != 2 or bank.dtype != torch.float32:
        raise ValueError(f"costas_mm_scan: want a 2-D float32 bank, got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    P, T = bank.shape
    if mode not in _COSTAS_MM_MODES or not 1 <= T <= _COSTAS_MM_TAPS or P < 1:
        raise ValueError(f"costas_mm_scan: built for Costas order 4 or the "
                         f"broken modulation and banks of 1 to "
                         f"{_COSTAS_MM_TAPS} taps, got mode {mode}, bank "
                         f"{(P, T)}")
    if not (1 <= rows < 2 ** 31 and 1 <= n < 2 ** 30 and n_out >= 0):
        raise ValueError(f"costas_mm_scan: bad shape {(rows, n)}")
    if tail.dtype != torch.complex64 or tail.shape != (rows, T - 1):
        raise ValueError(f"costas_mm_scan: want a ({rows}, {T - 1}) "
                         f"complex64 tail, got {tail.dtype} "
                         f"{tuple(tail.shape)}")
    want = [("phase0", phase0, torch.float32), ("freq0", freq0, torch.float32)]
    if len(carries) != len(_MM_LEAVES):
        raise ValueError(f"costas_mm_scan: want {len(_MM_LEAVES)} carries")
    want += [(k, c, dt) for (k, dt), c in zip(_MM_LEAVES, carries)]
    for name, t, dtype in want:
        if t.dtype != dtype or t.shape != (rows,):
            raise ValueError(f"costas_mm_scan: want {name} ({rows},) "
                             f"{dtype}, got {t.dtype} {tuple(t.shape)}")


def costas_mm_scan(x, tail, phase0, freq0, alpha, beta, fmin, fmax, mode,
                   bank, n_out, carries, mm_fmin, mm_fmax, omega_gain,
                   mu_gain):
    """`loops.costas_scan` over ``x``, then `mm_scan` (complex) over its
    output behind the carried ``tail``.

    ``x`` (rows, n) complex64; ``tail`` (rows, T - 1) complex64; ``phase0``,
    ``freq0`` (rows,) float32 and the Costas coefficients as
    `loops.costas_scan` takes them, ``mode`` `COSTAS_ORDER4` or
    `COSTAS_BROKEN`; ``bank`` (P, T) float32, T <= 8; ``carries``: M&M's
    carries as `MuellerMuller`'s state keeps them (offset int32, phase,
    freq, last float32, p1, p2, c1, c2 complex64), each (rows,); the loop
    bounds and gains as `mm_scan` takes them.  Returns ``(y, phase, freq,
    syms, valid, tail, carries)``: Costas's output and carries, then
    `mm_scan`'s symbols and valid mask, the new tail (ext's last T - 1
    samples, ext = tail ++ y) and the carries, the offset reduced by n.

    CPU tensors: `loops.costas_scan` then `mm_scan`, their plain loops.
    CUDA tensors: one launch on the current stream, which counts as one
    of each of the two functions (``costas_scan.launches``,
    ``mm_scan.launches``) and as ``costas_mm_scan.launches``; no
    fallback.  Raises on any other mode or bank, or a bank past the
    card's shared memory."""
    _costas_mm_check(x, tail, phase0, freq0, mode, bank, n_out, carries)
    rows, n = x.shape
    if x.device.type == "cpu":
        y, phase, freq = loops.costas_scan(x, phase0, freq0, alpha, beta,
                                           fmin, fmax, mode)
        ext = torch.cat([tail, y], dim=-1)
        offset0, ph, fr, last, *c = carries
        syms, valid, offset, fstate, cstate = mm_scan(
            ext, bank, n, n_out, offset0, torch.stack([ph, fr, last], 1),
            torch.stack(c, 1), mm_fmin, mm_fmax, omega_gain, mu_gain)
        return (y, phase, freq, syms, valid, ext[:, n:],
                (offset - n, *fstate.unbind(1), *cstate.unbind(1)))
    if x.device.type != "cuda":
        raise ValueError(f"costas_mm_scan: unsupported device {x.device}")
    P, T = bank.shape
    limit = _costas_mm_room(x.device.index)
    if P * _COSTAS_MM_TAPS * 4 > limit:
        raise ValueError(f"costas_mm_scan: a bank of {P} phases x "
                         f"{_COSTAS_MM_TAPS} taps exceeds the {limit} bytes "
                         f"of shared memory left to it on this card")
    if T != _COSTAS_MM_TAPS:
        bank = torch.nn.functional.pad(bank, (0, _COSTAS_MM_TAPS - T))
    x, tail, phase0, freq0, bank = (t.contiguous() for t in
                                    (x, tail, phase0, freq0, bank))
    carries = [t.contiguous() for t in carries]
    y = torch.empty_like(x)
    phase, freq = torch.empty_like(phase0), torch.empty_like(freq0)
    syms = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    valid = torch.empty((rows, n_out), dtype=torch.bool, device=x.device)
    new_tail = torch.empty_like(tail)
    new_carries = [torch.empty_like(t) for t in carries]
    ptrs = (ctypes.c_void_p * (2 * len(carries)))(
        *(t.data_ptr() for t in carries + new_carries))
    entry = _build.bind("sync_loops", "costas_mm_scan_launch",
                        (ctypes.c_void_p,) * 12 + (ctypes.c_longlong,) * 3
                        + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 14
                        + (ctypes.c_void_p,))
    _build.launch(costas_mm_scan, entry, x.device, x.data_ptr(),
                  y.data_ptr(), phase0.data_ptr(), freq0.data_ptr(),
                  phase.data_ptr(), freq.data_ptr(), tail.data_ptr(),
                  new_tail.data_ptr(), bank.data_ptr(), syms.data_ptr(),
                  valid.data_ptr(), ptrs, rows, n, n_out, P, T, mode, alpha,
                  beta, fmin, fmax, *(_f32(b) for b in loops.BROKEN_PHASES),
                  loops.COSTAS_WRAP_FAST, loops.COSTAS_WRAP_TURN, mm_fmin,
                  mm_fmax, omega_gain, mu_gain)
    # one launch computes one of each: their per-launch counts hold
    count_launches(loops.costas_scan)
    count_launches(mm_scan)
    return y, phase, freq, syms, valid, new_tail, tuple(new_carries)


costas_mm_scan.launches = 0


class MuellerMuller(StreamOp):
    """M&M symbol synchroniser with masked static-shape outputs.

    ``omega``: nominal samples per symbol.  Returns ``(symbols, valid)``
    where ``symbols`` has length ``max_out(n)`` and ``valid`` marks the
    real symbols (a prefix).  ``complex_mode`` selects the complex error
    equation (``mm.h:124-140``) or the float one (``mm.h:119-122``).
    Leading axes of the input are independent rows.  The state keeps the
    reference's keys, so it converts one to one.
    """

    def __init__(self, omega: float, omega_gain: float, mu_gain: float,
                 omega_rel_limit: float, interp_phase_count: int = 128,
                 interp_tap_count: int = 8, complex_mode: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.omega = float(omega)
        self.omega_gain = float(omega_gain)
        self.mu_gain = float(mu_gain)
        self.omega_rel_limit = float(omega_rel_limit)
        self.P = int(interp_phase_count)
        self.T = int(interp_tap_count)
        self.complex_mode = complex_mode
        self.bank = interp_bank(self.P, self.T)  # (P, T) host numpy
        self._bank = torch.as_tensor(self.bank, device=self.device)
        self.dtype = torch.complex64 if complex_mode else torch.float32

    def max_out(self, n: int) -> int:
        # the reference's bound: freq clamps at fmin but the mu term can
        # still subtract a clipped err each symbol
        worst = max(
            self.omega * (1.0 - self.omega_rel_limit) - self.mu_gain, 1.0
        )
        return int(np.ceil(n / worst)) + 2

    def init_state(self):
        dev = self.device

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        return {
            "tail": torch.zeros(self.T - 1, dtype=self.dtype, device=dev),
            "offset": scalar(0, torch.int32),
            "phase": scalar(0.0, torch.float32),
            "freq": scalar(np.float32(self.omega), torch.float32),
            "last_out": scalar(0.0, torch.float32),
            "p1": scalar(0j, torch.complex64),
            "p2": scalar(0j, torch.complex64),
            "c1": scalar(0j, torch.complex64),
            "c2": scalar(0j, torch.complex64),
        }

    def _loop(self):
        """The loop's frequency bounds and gains, as the scans take them."""
        return (_f32(self.omega * (1.0 - self.omega_rel_limit)),
                _f32(self.omega * (1.0 + self.omega_rel_limit)),
                _f32(self.omega_gain), _f32(self.mu_gain))

    def _new_state(self, tail, leaves, lead):
        """The state from the new tail and the carries (`_MM_LEAVES`'
        order, the offset reduced), rows back to ``lead``."""
        state = {"tail": tail.reshape(lead + (self.T - 1,))}
        state.update((k, v.reshape(lead))
                     for (k, _), v in zip(_MM_LEAVES, leaves))
        return state

    def __call__(self, state, x):
        lead = x.shape[:-1]
        n = x.shape[-1]
        rows = int(np.prod(lead, dtype=np.int64))
        tail = state["tail"].expand(lead + (self.T - 1,))
        ext = torch.cat([tail, x.to(self.dtype)], dim=-1)

        def flat(key):
            return state[key].expand(lead).reshape(rows)

        fstate = torch.stack([flat("phase").to(torch.float32),
                              flat("freq").to(torch.float32),
                              flat("last_out").to(torch.float32)], dim=1)
        cstate = torch.stack([flat(k).to(torch.complex64)
                              for k in ("p1", "p2", "c1", "c2")], dim=1)
        syms, valid, offset, fstate, cstate = mm_scan(
            ext.reshape(rows, -1).contiguous(), self._bank, n,
            self.max_out(n), flat("offset"), fstate, cstate, *self._loop())
        new_state = self._new_state(
            ext[..., n:], (offset - n, *fstate.unbind(1), *cstate.unbind(1)),
            lead)
        n_out = syms.shape[-1]
        return new_state, (syms.reshape(lead + (n_out,)),
                           valid.reshape(lead + (n_out,)))


def oerder_meyr_timing(x: torch.Tensor, sps: float) -> torch.Tensor:
    """Feedforward square-law timing estimate (Oerder & Meyr 1988).

    The fractional symbol timing offset in [0, 1) over the whole block:
    ``tau = -angle(sum |x[n]|^2 e^{-j2pi n/sps}) / 2pi``.  Block-parallel;
    no carry.
    """
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=x.device)
    ang = -2.0 * np.pi * idx / _f32(sps)
    w = torch.complex(torch.cos(ang), torch.sin(ang))
    c = torch.sum(x.abs() ** 2 * w, dim=-1)
    tau = -torch.angle(c) / (2.0 * np.pi)
    return torch.remainder(tau, 1.0)


class FeedforwardSymbolSync(StreamOp):
    """Block-parallel symbol sync: O&M timing + polyphase interpolation.

    Emits exactly ``n // sps`` symbols per block at the bank phase that
    the block's timing estimate picks.  Suits a symbol clock that is
    stable within a block.  Integer samples per symbol only.
    """

    def __init__(self, sps: float, interp_phase_count: int = 128,
                 interp_tap_count: int = 8, device="cuda"):
        assert abs(sps - round(sps)) < 1e-9, (
            "feedforward sync requires integer samples/symbol; use "
            "a resampler upstream or MuellerMuller for fractional rates"
        )
        self.device = resolve_device(device)
        self.sps = int(round(sps))
        self.P = interp_phase_count
        self.T = interp_tap_count
        self.bank = interp_bank(self.P, self.T)
        self._bank = torch.as_tensor(self.bank, device=self.device)

    def init_state(self):
        return torch.zeros(self.T - 1 + self.sps, dtype=torch.complex64,
                           device=self.device)

    def out_len(self, n: int) -> int:
        return n // self.sps

    def __call__(self, state, x):
        n = x.shape[-1]
        n_sym = n // self.sps
        ext = torch.cat([state, x.to(torch.complex64)])
        tau = oerder_meyr_timing(x, self.sps)  # in symbols
        frac = tau * self.sps  # in samples
        base = torch.floor(frac).to(torch.int64)
        ph = torch.clamp(torch.floor((frac - base) * self.P).to(torch.int64),
                         0, self.P - 1)
        taps = self._bank[ph].to(torch.complex64)  # (T,)
        k = torch.arange(n_sym, device=x.device) * self.sps
        t = torch.arange(self.T, device=x.device)
        frames = ext[(base + k)[:, None] + t[None, :]]
        with fp32_contractions():
            y = frames @ taps
        return ext[n:], y
