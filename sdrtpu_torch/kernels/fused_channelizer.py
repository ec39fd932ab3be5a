"""Fused multi-channel mix + decimate (K2): the CUDA kernel and its plain version.

Counterpart of ``sdrtpu/kernels/pallas_channelizer.py``.  For each
channel c, with ``ext = tail(T-1) ++ x`` and decimation M,

    y_c[j] = sum_t ext[jM + t] * rot_c(jM + t) * h[t],   j in [0, n/M)

where ``rot_c(e) = coarse_c[e // 1024] * fine_c[e % 1024]`` and the
coarse row is rotated by the carried per-channel phase.  The tables are
built on the host in float64 and stored float32, exactly as the
reference, so the rotation never takes a float32 angle of a large
sample index.  They are the tables of a rotation, ``coarse_c[g] =
e^{i w_c (1024 g - halo)}`` and ``fine_c[r] = e^{i w_c r}``.

On a CUDA tensor `mix_decimate` launches ``csrc/mix_decimate.cu``.  The
kernel is bound by instruction throughput, not bytes, so it moves the
rotation from the input samples to the outputs: ``rot_c(jM + t) =
rot_c(jM) * fine_c[t]``, hence ``y_c[j] = rot_c(jM) * sum_t ext[jM + t]
* g_c[t]`` with the modulated taps ``g_c[t] = h[t] * fine_c[t]``.  One
raw ext window per tile, copied asynchronously into shared memory,
serves 8 channels; each lane keeps 8 channels x 2 or 4 outputs of
complex accumulators in registers; the warps of persistent CTAs sized
to the card's SMs walk the tiles (see the source's note).
`mix_decimate_modulated_ref` states that arithmetic in float32 PyTorch,
for the tests.

On a CPU tensor `mix_decimate` runs `mix_decimate_ref`, which keeps the
reference's own arithmetic: the planar rotation of every sample, then
the banded-Toeplitz float32 matmuls ``W1``/``W2`` of `_toeplitz_mats`.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, resolve_device
from .._precision import fp32_contractions
from ..graph.block import StreamOp

ROW = 1024
TILE_ROWS = 64          # the reference's tile: 64 rows x 1024 samples
TILE_IN = TILE_ROWS * ROW
SPILL = 32              # rows of W2: taps may reach 32 samples past a row
_TWO_PI = 2.0 * np.pi


def _toeplitz_mats(taps: torch.Tensor, M: int):
    """W1 (1024, 1024//M) and spill W2 (32, 1024//M) for decim-by-M, on
    the taps' device: ``W[M*c + t, c] = taps[t]``, rows past 1024 in W2
    (the reference's tables, value for value)."""
    T = int(taps.shape[0])
    cols = ROW // M
    assert M * (cols - 1) + T - 1 < ROW + SPILL, (
        "tap spill exceeds one 32-row pad")
    dev = taps.device
    d = (torch.arange(ROW + SPILL, device=dev)[:, None]
         - M * torch.arange(cols, device=dev)[None, :])
    inside = (d >= 0) & (d < T)
    W = torch.where(inside, taps.to(torch.float32)[d.clamp(0, T - 1)],
                    torch.zeros((), dtype=torch.float32, device=dev))
    return W[:ROW], W[ROW:]


def mix_decimate_ref(tail, x, coarse, fine, taps, phase,
                     decim: int) -> torch.Tensor:
    """Plain PyTorch version, in the reference's arithmetic.

    ``ext = tail ++ x`` laid out as rows of 1024; per channel the coarse
    rows are rotated by ``phase`` (float32 cos/sin), the rotation is the
    outer product coarse (x) fine, and the decimating FIR is
    ``mixed[:, :R] @ W1 + mixed[:, 1:, :32] @ W2``.
    """
    M = int(decim)
    n = int(x.shape[-1])
    n_out = n // M
    rows_out = -(-n // ROW)
    ext = torch.cat([tail, x])
    ext = torch.cat([ext, ext.new_zeros((rows_out + 1) * ROW - ext.shape[0])])
    e_re = ext.real.reshape(rows_out + 1, ROW)
    e_im = ext.imag.reshape(rows_out + 1, ROW)
    pr, pi = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    cr = coarse.real[:, : rows_out + 1]
    ci = coarse.imag[:, : rows_out + 1]
    ctr = (cr * pr - ci * pi)[:, :, None]
    cti = (cr * pi + ci * pr)[:, :, None]
    fr, fi = fine.real[:, None, :], fine.imag[:, None, :]
    rot_re = ctr * fr - cti * fi
    rot_im = ctr * fi + cti * fr
    mr = e_re * rot_re - e_im * rot_im  # (C, rows_out + 1, 1024)
    mi = e_re * rot_im + e_im * rot_re
    w1, w2 = _toeplitz_mats(taps, M)
    with fp32_contractions():
        y_re = mr[:, :rows_out] @ w1 + mr[:, 1:, :SPILL] @ w2
        y_im = mi[:, :rows_out] @ w1 + mi[:, 1:, :SPILL] @ w2
    C = coarse.shape[0]
    return torch.complex(y_re, y_im).reshape(C, -1)[:, :n_out]


def mix_decimate_modulated_ref(tail, x, coarse, fine, taps, phase,
                               decim: int) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain float32 PyTorch.

    Modulated taps ``g_c[t] = h[t] * fine_c[t]``, one complex FIR of the
    raw ``ext = tail ++ x`` per channel, then one rotation per output
    from the tables at ext index ``jM``.  Equal to `mix_decimate_ref` up
    to float32 rounding when the tables are those of a rotation
    (``fine_c[r] = e^{i w_c r}``), as `FusedChannelizerStage` builds
    them.  Used by the tests and the on-card check only.
    """
    M = int(decim)
    T = int(taps.shape[0])
    n_out = int(x.shape[-1]) // M
    ext = torch.cat([tail, x])
    g = taps[None, :] * fine[:, :T]                      # (C, T)
    frames = ext.unfold(0, T, M)[:n_out]                 # (n_out, T)
    # planar float32 products, as the kernel's four FFMA per tap
    fr, fi = frames.real, frames.imag
    gr, gi = g.real.T.contiguous(), g.imag.T.contiguous()
    with fp32_contractions():
        z_re = fr @ gr - fi @ gi                         # (n_out, C)
        z_im = fr @ gi + fi @ gr
    # the coarse rows rotated by the carried phase, as the reference does
    pr, pi = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    e = torch.arange(n_out, device=x.device) * M
    row, lane = e >> 10, e & (ROW - 1)
    cr, ci = coarse.real[:, row], coarse.imag[:, row]
    ctr, cti = cr * pr - ci * pi, cr * pi + ci * pr
    fr, fi = fine.real[:, lane], fine.imag[:, lane]
    rot_re = ctr * fr - cti * fi                         # (C, n_out)
    rot_im = ctr * fi + cti * fr
    return torch.complex(rot_re * z_re.T - rot_im * z_im.T,
                         rot_re * z_im.T + rot_im * z_re.T)


def launch_plan(n: int, C: int, decim: int, T: int) -> dict:
    """The grid `mix_decimate` takes for this plan on the current card:
    CTAs, the card's SMs, how many CTAs fit on one SM, CTAs per SM as
    launched, waves (CTAs over the CTAs the card holds at once), channel
    groups, output ranges (one CTA each), tiles per warp, dynamic shared
    bytes, threads per CTA and outputs per lane."""
    report = (ctypes.c_int * 9)()
    # (n, C, M, T, report[9]) -> cudaError_t
    plan_fn = _build.bind("mix_decimate", "mix_decimate_plan",
                          (ctypes.c_longlong,) + (ctypes.c_int,) * 3
                          + (ctypes.POINTER(ctypes.c_int),))
    rc = plan_fn(n, C, int(decim), T, report)
    if rc != 0:
        raise RuntimeError(f"mix_decimate: no plan (error {rc})")
    keys = ("ctas", "sms", "resident_ctas_per_sm", "channel_groups",
            "ranges", "tiles_per_warp", "dynamic_shared_bytes", "threads",
            "outputs_per_lane")
    plan = dict(zip(keys, report))
    plan["ctas_per_sm"] = plan["ctas"] / plan["sms"]
    plan["waves"] = plan["ctas"] / (plan["sms"] * plan["resident_ctas_per_sm"])
    return plan


def mix_decimate(tail, x, coarse, fine, taps, phase, decim: int):
    """complex64 ``tail`` (T-1,) and ``x`` (n,) -> complex64 (C, n/M).

    ``coarse`` (C, rows) and ``fine`` (C, 1024) complex64 rotation
    tables (``rows > ceil(n / 1024)``), ``taps`` (T,) float32 with
    ``T <= 40``, ``phase`` (C,) float32, M in {2, 4, 8}.  The tables are
    those of a rotation, as `FusedChannelizerStage` builds them.  CPU
    tensors: `mix_decimate_ref`.  CUDA tensors: the hand-written kernel
    on the current stream (``mix_decimate.launches`` counts its
    launches); anything else raises.
    """
    M = int(decim)
    args = {"tail": tail, "x": x, "coarse": coarse, "fine": fine,
            "taps": taps, "phase": phase}
    want = {"tail": (torch.complex64, 1), "x": (torch.complex64, 1),
            "coarse": (torch.complex64, 2), "fine": (torch.complex64, 2),
            "taps": (torch.float32, 1), "phase": (torch.float32, 1)}
    for name, t in args.items():
        if t.device != x.device or (t.dtype, t.ndim) != want[name]:
            raise ValueError(
                f"mix_decimate: {name} wants {want[name]} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n, T = int(x.shape[0]), int(taps.shape[0])
    C, rows = int(coarse.shape[0]), int(coarse.shape[1])
    if (M not in (2, 4, 8) or n % M or not 1 <= T <= 40
            or tail.shape[0] != T - 1):
        raise ValueError(f"mix_decimate: bad plan n={n} M={M} T={T} "
                         f"tail={tuple(tail.shape)}")
    if (fine.shape != (C, ROW) or phase.shape != (C,)
            or rows <= -(-n // ROW)):
        raise ValueError("mix_decimate: tables do not cover the block")
    if x.device.type == "cpu":
        return mix_decimate_ref(tail, x, coarse, fine, taps, phase, M)
    if x.device.type != "cuda":
        raise ValueError(f"mix_decimate: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError("mix_decimate: every input must be contiguous")
    out = torch.empty((C, n // M), dtype=torch.complex64, device=x.device)
    # (tail, x, coarse, fine, taps, phase, out, n, halo, rows, C, M, T,
    # stream) -> cudaError_t
    entry = _build.bind("mix_decimate", "mix_decimate_launch",
                        (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,)
                        + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    _build.launch(mix_decimate, entry, x.device, tail.data_ptr(),
                  x.data_ptr(), coarse.data_ptr(), fine.data_ptr(),
                  taps.data_ptr(), phase.data_ptr(), out.data_ptr(), n,
                  T - 1, rows, C, M, T)
    return out


mix_decimate.launches = 0


def _complex_table(angles: np.ndarray) -> np.ndarray:
    """float64 angles -> complex64 whose parts are the float32 cos/sin."""
    out = np.empty(angles.shape, np.complex64)
    out.real = np.cos(angles).astype(np.float32)
    out.imag = np.sin(angles).astype(np.float32)
    return out


class FusedChannelizerStage(StreamOp):
    """Mix each channel to baseband and decimate by M in one kernel.

    ``y_c = decimate_M(x * exp(-i*2*pi*f_c*t/fs), taps)`` with streaming
    state ``{"tail": (T-1,) complex64, "phase": (C,) float32}``.  The
    rotation tables are offset constants of the stage (the reference
    keeps them out of the state too; a retune rebuilds the stage).
    """

    def __init__(self, offsets_hz, samplerate: float, taps: np.ndarray,
                 decim: int, block_len: int, device="cuda"):
        assert decim in (2, 4, 8) and ROW % decim == 0
        assert block_len % decim == 0
        self.device = resolve_device(device)
        offsets = np.asarray(offsets_hz, np.float64)
        self.C = len(offsets)
        self.taps = np.asarray(taps, np.float32)
        self.T = len(self.taps)
        assert self.T <= int(decim) + SPILL, (
            f"{self.T} taps exceed the kernel's spill budget for M={decim}")
        self.decim = int(decim)
        self.n = int(block_len)
        # offsets are channel centers: rotate by -center (RxVFO convention)
        omega = -_TWO_PI * offsets / float(samplerate)  # (C,) float64
        self.halo = self.T - 1
        r = np.arange(ROW, dtype=np.float64)
        fine = _complex_table(np.mod(omega[:, None] * r, _TWO_PI))
        # coarse row g covers ext samples [g*1024, (g+1)*1024); ext starts
        # `halo` samples before the block, folded into the row angle.  The
        # reference's rows: whole 65536-sample tiles plus one halo row.
        self.n_tiles = -(-self.n // TILE_IN)
        g = np.arange(self.n_tiles * TILE_ROWS + 1, dtype=np.float64)
        coarse = _complex_table(
            np.mod(omega[:, None] * (g * ROW - self.halo), _TWO_PI))
        self.block_delta = np.mod(omega * self.n, _TWO_PI).astype(np.float32)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        self._fine, self._coarse = dev(fine), dev(coarse)
        self._taps, self._delta = dev(self.taps), dev(self.block_delta)

    def init_state(self):
        return {
            "tail": torch.zeros(self.halo, dtype=torch.complex64,
                                device=self.device),
            "phase": torch.zeros(self.C, dtype=torch.float32,
                                 device=self.device),
        }

    def out_len(self, n: int) -> int:
        assert n == self.n
        return n // self.decim

    def __call__(self, state, x):
        assert x.shape[-1] == self.n, (x.shape, self.n)
        x = x.to(torch.complex64).contiguous()
        y = mix_decimate(state["tail"], x, self._coarse, self._fine,
                         self._taps, state["phase"], self.decim)
        return {
            # x[-0:] would be the whole block: a 1-tap filter carries none
            "tail": x[-self.halo:].clone() if self.halo else x[:0],
            "phase": torch.remainder(state["phase"] + self._delta, _TWO_PI),
        }, y
