"""Streaming FIR filtering (PyTorch counterpart of ``sdrtpu/kernels/fir.py``).

Semantics as in the reference: ``out[i] = sum_t ext[i + t] * taps[t]``
with ``ext = [tail ++ x]`` — a valid cross-correlation against the taps
as stored; state is the trailing ``taps - 1`` input samples.

Three evaluations of the same sum:

- `correlate_valid`: shift-and-add over the taps (short filters), and
  `correlate_valid_bank` for a bank of per-channel taps (the xla-fused
  channelizer's modulated taps);
- `matmul_correlate_valid`: banded-Toeplitz matmuls on shifted row views
  (the WFM pilot and de-emphasis paths);
- `fft_correlate_valid`: FFT overlap-save (long filters).

`Fir`, `DecimatingFir` and `MultistageDecimator` (a cascade of half-band
decimate-by-2 stages) are the stream ops on top.  On the card a
`DecimatingFir` stage is one launch of a hand-written kernel
(`decim_fir`, ``csrc/decim_fir.cu``), bit-equal to the shift-and-add,
which stays its plain version and serves CPU tensors.

Contractions are float32 ``torch.matmul``.  The reference pins its TPU
matmuls to multi-pass precision because one bf16 pass broke the demod
SINAD floors; the port pins full float32 on each call
(`fp32_contractions`: TF32 off, the caller's settings restored).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, resolve_device
from .._precision import fp32_contractions
from ..graph.block import StreamOp


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis by ``n`` samples on the right."""
    if n == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (n,))], dim=-1)


def correlate_valid(x: torch.Tensor, taps, stride: int = 1) -> torch.Tensor:
    """Valid correlation along the last axis, any real/complex combination.

    ``out[..., i] = sum_t x[..., i*stride + t] * taps[t]`` as a
    shift-and-add over host tap values, accumulated in tap order as the
    reference does.
    """
    taps = np.asarray(taps)
    cplx = np.iscomplexobj(taps)
    if cplx and not x.is_complex():
        x = x.to(torch.complex64)
    L = x.shape[-1]
    T = int(taps.shape[0])
    vals = [complex(t) if cplx else float(t) for t in taps]
    M = int(stride)
    A = (L - T) // M + 1
    acc = None
    for t in range(T):
        seg = x[..., t : t + (A - 1) * M + 1 : M]
        term = vals[t] * seg
        acc = term if acc is None else acc + term
    return acc


def correlate_valid_bank(x: torch.Tensor, taps_bank, stride: int = 1,
                         live=None) -> torch.Tensor:
    """Valid correlation against a bank of per-channel taps ``(C, T)``.

    ``x`` 1-D ``(n,)`` is one shared signal:
    ``out[c, i] = sum_t x[i*stride + t] * taps_bank[c, t]``; ``x`` 2-D
    ``(C, n)`` filters each channel with its own taps.  ``taps_bank`` is a
    host array (all-zero tap columns are skipped) or a tensor on ``x``'s
    device (every column, unless the caller passes the ``live`` column
    list).  Shift-and-add over the taps, summed in tap order.
    """
    host = isinstance(taps_bank, np.ndarray)
    taps = torch.as_tensor(taps_bank, device=x.device)
    assert x.ndim in (1, 2) and taps.ndim == 2
    if taps.is_complex() and not x.is_complex():
        x = x.to(torch.complex64)
    C, T = taps.shape
    shared = x.ndim == 1
    if not shared:
        assert x.shape[0] == C
    if live is None:
        live = ([t for t in range(T) if np.any(taps_bank[:, t] != 0)]
                if host else range(T))
    M = int(stride)
    A = (int(x.shape[-1]) - T) // M + 1
    out_dtype = torch.complex64 if taps.is_complex() else x.dtype
    acc = torch.zeros((C, A), dtype=out_dtype, device=x.device)
    for t in live:
        seg = x[..., t : t + (A - 1) * M + 1 : M]
        acc = acc + taps[:, t, None] * (seg[None, :] if shared else seg)
    return acc


def decim_fir_ref(tail: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                  stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `decim_fir`: ``ext = tail ++ x``, the
    shift-and-add `correlate_valid` of ``ext`` against ``h``'s values at
    ``stride``, and the last ``T - 1`` samples of ``ext``.  Returns
    (new tail, y)."""
    ext = torch.cat([tail, x], dim=-1)
    y = correlate_valid(ext, h.tolist(), stride)
    return ext[..., x.shape[-1]:], y


_DECIM_FIR_OUTPUTS = 256  # outputs a block at most: one a thread
_SMEM_STATIC = 48 * 1024  # shared bytes a block takes without opting in
_SMEM_MAX = 232448  # the H100's most a block can opt in to


def decim_fir_plan(stride: int, ntaps: int,
                   itemsize: int) -> tuple[int, int, int]:
    """Tile of a `decim_fir` launch: (outputs a block ``ob``, length of a
    phase row ``qw``, shared bytes).  The block stages the ``(ob - 1) *
    stride + ntaps`` samples its outputs read as ``stride`` phase rows
    of ``qw = ob + (ntaps - 1) // stride`` samples, then the taps.  The
    largest power-of-two ``ob`` whose tile fits 48 KB, else the card's
    most; raises where even one output's does not fit."""
    for limit in (_SMEM_STATIC, _SMEM_MAX):
        ob = _DECIM_FIR_OUTPUTS
        while ob >= 1:
            qw = ob + (ntaps - 1) // stride
            smem = stride * qw * itemsize + 4 * ntaps
            if smem <= limit:
                return ob, qw, smem
            ob //= 2
    raise ValueError(f"decim_fir: stride {stride} with {ntaps} taps does "
                     f"not fit in shared memory")


def decim_fir(tail: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
              stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One stage of a decimating FIR: ``y[..., i] = sum_t ext[..., i *
    stride + t] * h[t]`` with ``ext = tail ++ x``, and the stage's next
    tail, the last ``T - 1`` samples of ``ext``.  Returns (new tail, y).

    ``x`` (..., n) complex64 or float32, ``tail`` (..., T - 1) of its
    dtype (broadcast rows, such as an expanded 1-D state, are read in
    place); ``h`` the ``T`` real taps as a float32 tensor on ``x``'s
    device.  CPU tensors: `decim_fir_ref`.  CUDA tensors: the kernel on
    the current stream (``decim_fir.launches`` counts), bit-equal to the
    shift-and-add on the card; no fallback.
    """
    if x.device.type == "cpu":
        return decim_fir_ref(tail, x, h, stride)
    if x.device.type != "cuda":
        raise ValueError(f"decim_fir: unsupported device {x.device}")
    if x.dtype not in (torch.complex64, torch.float32):
        raise ValueError(f"decim_fir: want complex64 or float32, got "
                         f"{x.dtype}")
    if (h.dtype != torch.float32 or h.ndim != 1 or not h.is_contiguous()
            or h.device != x.device):
        raise ValueError(f"decim_fir: want contiguous 1-D float32 taps on "
                         f"{x.device}, got {h.dtype} {tuple(h.shape)} on "
                         f"{h.device}")
    M, T, n = int(stride), int(h.shape[0]), int(x.shape[-1])
    lead = x.shape[:-1]
    if (tail.dtype != x.dtype or tail.device != x.device
            or tail.shape != lead + (T - 1,)):
        raise ValueError(f"decim_fir: want a {x.dtype} tail of shape "
                         f"{tuple(lead + (T - 1,))} on {x.device}, got "
                         f"{tail.dtype} {tuple(tail.shape)} on {tail.device}")
    rows = int(np.prod(lead, dtype=np.int64))
    if M < 1 or T < 1 or n < 1 or not 1 <= rows < 2 ** 16:
        raise ValueError(f"decim_fir: bad shape {tuple(x.shape)}, stride "
                         f"{M}, {T} taps")
    x2 = x.reshape(rows, n)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    t2 = tail.reshape(rows, T - 1)
    if T > 1 and t2.stride(-1) != 1:
        t2 = t2.contiguous()
    ob, qw, smem = decim_fir_plan(M, T, x.element_size())
    A = (n - 1) // M + 1  # correlate_valid's (L - T) // M + 1, L = T - 1 + n
    y = torch.empty((rows, A), dtype=x.dtype, device=x.device)
    tail_out = torch.empty((rows, T - 1), dtype=x.dtype, device=x.device)
    entry = _build.bind("decim_fir", "decim_fir_launch",
                        (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)
                        + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    _build.launch(decim_fir, entry, x.device, t2.data_ptr(),
                  t2.stride(0) if T > 1 else 0, x2.data_ptr(), x2.stride(0),
                  n, h.data_ptr(), T, M, y.data_ptr(), A,
                  tail_out.data_ptr(), rows, int(x.is_complex()), ob, qw,
                  smem)
    return tail_out.reshape(lead + (T - 1,)), y.reshape(lead + (A,))


decim_fir.launches = 0


def toeplitz_matrix(taps, block: int) -> np.ndarray:
    """Host banded-Toeplitz matrix ``H[j, i] = taps[j - i]`` for
    ``0 <= j - i < T``, shape ``(R*block, block)`` with
    ``R = 1 + ceil((T-1)/block)``; float32 or complex64 like the taps."""
    taps = np.asarray(taps)
    T = int(taps.shape[0])
    M = int(block)
    R = 1 + -(-(T - 1) // M) if T > 1 else 1
    d = np.arange(R * M)[:, None] - np.arange(M)[None, :]
    H = np.where((d >= 0) & (d < T), taps[np.clip(d, 0, T - 1)], 0)
    return H.astype(np.complex64 if np.iscomplexobj(taps) else np.float32)


def shifted_window_matmul(xr: torch.Tensor, mat: torch.Tensor,
                          A: int) -> torch.Tensor:
    """``out[..., a, w] = sum_q xr[..., a+q, :] @ mat[q*M:(q+1)*M, w]``.

    ``xr``: (..., rows, M) — one input laid out as rows of M.  The
    (A, R*M) frame matrix is never built: each of the R row blocks of
    ``mat`` contracts a shifted unit-stride view of the same rows.  Full
    float32 (`fp32_contractions`).
    """
    M = int(xr.shape[-1])
    R = int(mat.shape[0]) // M
    acc = None
    with fp32_contractions():
        for q in range(R):
            term = torch.matmul(xr[..., q : q + A, :],
                                mat[q * M : (q + 1) * M])
            acc = term if acc is None else acc + term
    return acc


def matmul_correlate_valid(x: torch.Tensor, taps, block: int = 128,
                           H: torch.Tensor | None = None) -> torch.Tensor:
    """`correlate_valid` (stride 1) as banded-Toeplitz float32 matmuls.

    ``y[a*M + i] = sum_j ext[a*M + j] * H[j, i]``; ``H`` is
    `toeplitz_matrix` (pass it prebuilt on the device to skip the host
    build).  Real taps filter the real and imaginary planes of a complex
    input in one batched matmul; complex taps run a complex matmul.
    """
    taps = np.asarray(taps)
    T = int(taps.shape[0])
    M = int(block)
    L = int(x.shape[-1])
    span = L - T + 1
    assert span >= 1
    R = 1 + -(-(T - 1) // M) if T > 1 else 1
    A = -(-span // M)
    rows = A + R - 1
    if H is None:
        H = torch.as_tensor(toeplitz_matrix(taps, M), device=x.device)
    lead = x.shape[:-1]
    if H.is_complex():
        x = x.to(torch.complex64)
        xr = _pad_last(x, rows * M - L).reshape(lead + (rows, M))
        y = shifted_window_matmul(xr, H, A)
    elif x.is_complex():
        xr = _pad_last(x, rows * M - L).reshape(lead + (rows, M))
        planes = torch.stack((xr.real, xr.imag))
        out = shifted_window_matmul(planes, H, A)
        y = torch.complex(out[0], out[1])
    else:
        xr = _pad_last(x, rows * M - L).reshape(lead + (rows, M))
        y = shifted_window_matmul(xr, H, A)
    return y.reshape(lead + (A * M,))[..., :span]


def _next_fft_len(n: int) -> int:
    """Smallest 2^a (a >= 4) >= n."""
    m = 16
    while m < n:
        m *= 2
    return m


def _plan_corr_nfft(L: int, T: int) -> int:
    """FFT size for overlap-save correlation (the reference's cost model:
    one transform for short signals, else the power of two minimizing
    ``ceil(span/valid) * nfft * log2(nfft)``)."""
    span = L - T + 1
    if L + T - 1 <= 32768:
        return _next_fft_len(L + T - 1)
    best = None
    nfft = _next_fft_len(2 * T)
    while True:
        valid = nfft - T + 1
        cost = -(-span // valid) * nfft * np.log2(nfft)
        if best is None or cost < best[0]:
            best = (cost, nfft)
        if nfft >= L + T - 1 or nfft >= (1 << 20):
            break
        nfft *= 2
    return best[1]


def fft_correlate_valid(x: torch.Tensor, taps,
                        spectra: dict | None = None) -> torch.Tensor:
    """`correlate_valid` (stride 1) via FFT overlap-save.

    Correlation is convolution with reversed taps:
    ``out = IFFT(FFT(x_pad) * FFT(reverse(taps)))[T-1 : T-1+span]``, the
    tap spectrum built on the host in float64.  Long inputs are cut into
    overlap-save chunks of the planned size.  ``spectra``, a dict the
    caller keeps for these taps, holds each spectrum on the device per
    ``(nfft, device)``: a host copy on every call would wait for the
    device's queue, and cannot be captured in a CUDA graph.
    """
    taps = np.asarray(taps)
    L = int(x.shape[-1])
    T = int(taps.shape[0])
    span = L - T + 1
    nfft = _plan_corr_nfft(L, T)
    if nfft < L + T - 1:
        valid = nfft - T + 1
        P = -(-span // valid)
        Q = -(-nfft // valid)
        rows_n = P + Q - 1
        lead = x.shape[:-1]
        rows = _pad_last(x, rows_n * valid - L).reshape(lead + (rows_n, valid))
        chunks = torch.cat(
            [rows[..., q : q + P, :] for q in range(Q)], dim=-1
        )[..., :nfft]
        y = _fft_corr_padded(chunks, taps, nfft, spectra)  # (..., P, valid)
        return y.reshape(lead + (P * valid,))[..., :span]
    return _fft_corr_padded(x, taps, nfft, spectra)


def _fft_corr_padded(x: torch.Tensor, taps: np.ndarray, nfft: int,
                     spectra: dict | None) -> torch.Tensor:
    """Circular correlation core: the ``L - T + 1`` valid outputs of the
    last axis zero-padded to ``nfft``."""
    L = int(x.shape[-1])
    T = int(taps.shape[0])
    span = L - T + 1
    complex_out = x.is_complex() or np.iscomplexobj(taps)
    xf = torch.fft.fft(_pad_last(x.to(torch.complex64), nfft - L))
    key = (nfft, x.device)
    hf_t = None if spectra is None else spectra.get(key)
    if hf_t is None:
        hf = np.fft.fft(taps[::-1].astype(np.complex128), nfft)
        hf_t = torch.as_tensor(hf.astype(np.complex64), device=x.device)
        if spectra is not None:
            spectra[key] = hf_t
    y = torch.fft.ifft(xf * hf_t)[..., T - 1 : T - 1 + span]
    return y if complex_out else y.real


class Fir(StreamOp):
    """Streaming FIR: state = last ``taps - 1`` input samples.

    ``method``: "direct" (shift-and-add), "fft" (overlap-save), "mm"
    (banded-Toeplitz matmuls) or "auto" (fft from 128 taps, direct
    below — the reference's crossover, chosen on a TPU and not measured
    on the card; every method computes the same sum).
    """

    _FFT_MIN_TAPS = 128

    def __init__(self, taps: np.ndarray, dtype=torch.complex64,
                 method: str = "auto", device="cuda"):
        taps = np.asarray(taps)
        self.device = resolve_device(device)
        self.taps = taps
        self.ntaps = int(taps.shape[0])
        self.dtype = dtype
        assert method in ("auto", "direct", "fft", "mm")
        if method == "auto":
            method = "fft" if self.ntaps >= self._FFT_MIN_TAPS else "direct"
        self.method = method
        self._H = (torch.as_tensor(toeplitz_matrix(taps, 128),
                                   device=self.device)
                   if method == "mm" else None)
        self._spectra = {}  # (nfft, device) -> the "fft" tap spectrum

    def init_state(self):
        return torch.zeros((self.ntaps - 1,), dtype=self.dtype,
                           device=self.device)

    def out_len(self, n: int) -> int:
        return n

    def __call__(self, state, x):
        x = x.to(self.dtype)
        state = state.expand(x.shape[:-1] + (self.ntaps - 1,))
        ext = torch.cat([state, x], dim=-1)
        if self.method == "fft":
            y = fft_correlate_valid(ext, self.taps, self._spectra)
        elif self.method == "mm":
            y = matmul_correlate_valid(ext, self.taps, H=self._H)
        else:
            y = correlate_valid(ext, self.taps)
        if not y.is_complex():
            y = y.to(self.dtype)
        new_state = ext[..., x.shape[-1]:] if self.ntaps > 1 else state
        return new_state, y


class DecimatingFir(StreamOp):
    """FIR evaluated every ``decimation`` input samples; block lengths
    must be divisible by the decimation (no phase carry).  Real taps
    only.  Each call is one `decim_fir`: on the card one launch, which
    also writes the next state; the taps are a float32 tensor on the
    device, made here once (a host copy in the call would wait for the
    device's queue, and cannot be captured in a CUDA graph)."""

    def __init__(self, taps: np.ndarray, decimation: int,
                 dtype=torch.complex64, device="cuda"):
        taps = np.asarray(taps)
        if np.iscomplexobj(taps):
            raise ValueError("DecimatingFir: complex taps are not taken")
        self.device = resolve_device(device)
        self.taps = taps
        self.ntaps = int(taps.shape[0])
        self.decimation = int(decimation)
        self.dtype = dtype
        self._h = torch.as_tensor(taps.astype(np.float32),
                                  device=self.device)

    def init_state(self):
        return torch.zeros((self.ntaps - 1,), dtype=self.dtype,
                           device=self.device)

    def out_len(self, n: int) -> int:
        assert n % self.decimation == 0, (
            f"block length {n} not divisible by decimation {self.decimation}"
        )
        return n // self.decimation

    def __call__(self, state, x):
        n = x.shape[-1]
        assert n % self.decimation == 0
        x = x.to(self.dtype)
        state = state.expand(x.shape[:-1] + (self.ntaps - 1,))
        return decim_fir(state, x, self._h, self.decimation)


class MultistageDecimator(StreamOp):
    """Power-of-two decimation as a cascade of half-band decimate-by-2
    FIRs (the reference's redesign of ``PowerDecimator``): one
    `DecimatingFir` per halving, taps from ``taps_fn`` (default
    `taps.half_band`); state is the tuple of the stages' tails."""

    def __init__(self, ratio: int, dtype=torch.complex64, taps_fn=None,
                 device="cuda"):
        assert ratio >= 1 and (ratio & (ratio - 1)) == 0, "ratio must be 2^k"
        from . import taps as tapsmod

        self.ratio = int(ratio)
        self.dtype = dtype
        taps_fn = taps_fn or (lambda: tapsmod.half_band())
        self.stages = []
        r = self.ratio
        while r > 1:
            self.stages.append(DecimatingFir(taps_fn(), 2, dtype,
                                             device=device))
            r //= 2

    def init_state(self):
        return tuple(s.init_state() for s in self.stages)

    def out_len(self, n: int) -> int:
        assert n % self.ratio == 0
        return n // self.ratio

    def __call__(self, state, x):
        new_states = []
        for s, st in zip(self.stages, state):
            st, x = s(st, x)
            new_states.append(st)
        return tuple(new_states), x
