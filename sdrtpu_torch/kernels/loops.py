"""Feedback control loops (PyTorch counterpart of ``sdrtpu/kernels/loops.py``).

- `Agc`, `Pll` and `Costas` are per-sample recurrences.  On a CUDA
  tensor each runs as one launch of a hand-written scan (`agc_scan`,
  `pll_scan`, ``csrc/seq_loops.cu``; `costas_scan`,
  ``csrc/sync_loops.cu``); on a CPU tensor the wrapper runs the plain
  PyTorch loop (`agc_scan_ref`, `pll_scan_ref`, `costas_scan_ref`), and
  only then.
- `NormalizedPilot` and `pilot_phase_fit` are the block-parallel pilot
  trackers with no sequential carry.

All loops take ``(..., n)``: leading axes are independent rows, each with
its own carry (a 0-d carry is shared as the start of every row).  The
reference runs one row.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, resolve_device
from ..graph.block import StreamOp

_TWO_PI = float(np.float32(2.0 * np.pi))


def critically_damped(bandwidth: float) -> tuple[float, float]:
    """alpha/beta of a critically damped second-order loop."""
    zeta = np.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * zeta * bandwidth + bandwidth * bandwidth
    alpha = (4.0 * zeta * bandwidth) / denom
    beta = (4.0 * bandwidth * bandwidth) / denom
    return float(alpha), float(beta)


def _wrap_pi(phase: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]; ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  The divisor is a tensor: PyTorch on the card
    multiplies by the reciprocal of a Python scalar divisor, which rounds
    twice, where a tensor divisor is one IEEE division on either device,
    as in the kernels' wrap."""
    return phase - _TWO_PI * torch.round(
        phase / torch.full_like(phase, _TWO_PI))


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def _cuda_args(name: str, x: torch.Tensor, dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != dtype or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous 2-D {dtype}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not 1 <= x.shape[0] < 2 ** 31 or x.shape[1] < 1:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")


# -- AGC ---------------------------------------------------------------

def agc_scan_ref(in_amp, suffix_max, amp0, one_m_atk, atk, one_m_dcy, dcy,
                 set_point, max_gain, max_out):
    """Plain PyTorch version of `agc_scan`: the loop over time, all rows
    at once.  ``in_amp``, ``suffix_max``: (rows, n) float32; ``amp0``:
    (rows,).  Returns (gain (rows, n), amp (rows,))."""
    amp = amp0.clone()
    gains = torch.empty_like(in_amp)
    one = torch.ones_like(amp)
    # a tensor numerator: ``scalar / tensor`` would be reciprocal-then-
    # multiply, which rounds twice
    set_point = torch.full_like(amp, set_point)
    for i in range(in_amp.shape[-1]):
        ia = in_amp[:, i]
        live = ia != 0.0
        a = torch.where(ia > amp, amp * one_m_atk + ia * atk,
                        amp * one_m_dcy + ia * dcy)
        a = torch.where(live, a, amp)
        g = torch.where(live, torch.clamp(set_point / a, max=max_gain), one)
        clip = ia * g > max_out
        a = torch.where(clip, suffix_max[:, i], a)
        g = torch.where(clip, torch.clamp(set_point / a, max=max_gain), g)
        amp = a
        gains[:, i] = g
    return gains, amp


def agc_scan(in_amp, suffix_max, amp0, one_m_atk, atk, one_m_dcy, dcy,
             set_point, max_gain, max_out):
    """Gain per sample and final average of the attack/decay AGC.

    ``in_amp`` = |x| and ``suffix_max[r, i] = max(in_amp[r, i:])``, both
    (rows, n) float32; ``amp0`` (rows,).  The coefficients are float32
    values.  CPU tensors: `agc_scan_ref`.  CUDA tensors: the kernel on
    the current stream (``agc_scan.launches`` counts); no fallback.
    """
    if in_amp.device.type == "cpu":
        return agc_scan_ref(in_amp, suffix_max, amp0, one_m_atk, atk,
                            one_m_dcy, dcy, set_point, max_gain, max_out)
    _cuda_args("agc_scan", in_amp, torch.float32)
    _cuda_args("agc_scan", suffix_max, torch.float32)
    rows, n = in_amp.shape
    if suffix_max.shape != in_amp.shape or amp0.shape != (rows,):
        raise ValueError("agc_scan: shapes disagree")
    amp0 = amp0.to(torch.float32).contiguous()
    gains = torch.empty_like(in_amp)
    amp = torch.empty_like(amp0)
    entry = _build.bind("seq_loops", "agc_scan_launch",
                        (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) * 2
                        + (ctypes.c_float,) * 7 + (ctypes.c_void_p,))
    _build.launch(agc_scan, entry, in_amp.device, in_amp.data_ptr(),
                  suffix_max.data_ptr(), gains.data_ptr(), amp0.data_ptr(),
                  amp.data_ptr(), rows, n, one_m_atk, atk, one_m_dcy, dcy,
                  set_point, max_gain, max_out)
    return gains, amp


agc_scan.launches = 0


class Agc(StreamOp):
    """Attack/decay AGC.  The clipping look-ahead (scan the rest of the
    block for its maximum) is a suffix maximum of |x| taken beforehand.
    State: the running average amplitude ``amp`` (set_point/init_gain,
    so 0 for ``init_gain=inf``)."""

    def __init__(self, set_point: float, attack: float, decay: float,
                 max_gain: float = 1e4, max_output_amp: float = 10.0,
                 init_gain: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        self.set_point = float(set_point)
        self.attack = float(attack)
        self.decay = float(decay)
        self.max_gain = float(max_gain)
        self.max_output_amp = float(max_output_amp)
        self.init_gain = float(init_gain)

    def init_state(self):
        return torch.tensor(self.set_point / self.init_gain,
                            dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        lead = x.shape[:-1]
        n = x.shape[-1]
        in_amp = x.abs().to(torch.float32).reshape(-1, n).contiguous()
        suffix_max = in_amp.flip(-1).cummax(-1).values.flip(-1).contiguous()
        atk, dcy = np.float32(self.attack), np.float32(self.decay)
        amp0 = state.to(torch.float32).expand(lead).reshape(-1)
        gains, amp = agc_scan(
            in_amp, suffix_max, amp0,
            float(np.float32(1) - atk), float(atk),
            float(np.float32(1) - dcy), float(dcy),
            _f32(self.set_point), _f32(self.max_gain),
            _f32(self.max_output_amp))
        return amp.reshape(lead), x * gains.reshape(x.shape)


# -- PLL ---------------------------------------------------------------

# A `pll_scan` row whose |phase0| is at most this, in a loop whose alpha
# and frequency bounds keep both wraps' inputs below COSTAS_WRAP_TURN,
# keeps |phase| below it at every step; the kernel wraps such a row
# without the division (`pll_bounded`).
PLL_PHASE_BOUND = 3.2


def pll_bounded(phase0: float, alpha: float, fmin: float,
                fmax: float) -> bool:
    """Whether the `pll_scan` kernel walks a row from ``phase0`` with
    these coefficients without the division (``csrc/seq_loops.cu``
    `pll_params_bounded` and the row's test, in float32 as there):
    |phase0| <= PLL_PHASE_BOUND, and PLL_PHASE_BOUND + max(|fmin|,
    |fmax|) + |alpha| * PLL_PHASE_BOUND below 0.999 * COSTAS_WRAP_TURN,
    which bounds |phase + freq + alpha * err| (|err| <= float32(pi)) and
    leaves |ang - phase| below a turn too.  NaN bounds: False."""
    f = np.float32
    bound = f(PLL_PHASE_BOUND)
    if np.isnan(f(fmin)) or np.isnan(f(fmax)):
        return False
    reach = (bound + max(abs(f(fmin)), abs(f(fmax)))
             + abs(f(alpha)) * bound)
    return bool(reach < f(0.999) * f(COSTAS_WRAP_TURN)
                and abs(f(phase0)) <= bound)


def pll_scan_ref(x, phase0, freq0, alpha, beta, fmin, fmax):
    """Plain PyTorch version of `pll_scan`: the loop over time, all rows
    at once.  ``x``: (rows, n) complex64; carries (rows,) float32."""
    phase, freq = phase0.clone(), freq0.clone()
    ang = torch.atan2(x.imag, x.real)
    phases = torch.empty_like(ang)
    for i in range(x.shape[-1]):
        phases[:, i] = phase  # the VCO is emitted before the update
        err = _wrap_pi(ang[:, i] - phase)
        freq = torch.clamp(freq + beta * err, fmin, fmax)
        phase = _wrap_pi(phase + freq + alpha * err)
    return torch.complex(torch.cos(phases), torch.sin(phases)), phase, freq


def pll_scan(x, phase0, freq0, alpha, beta, fmin, fmax):
    """VCO phasor per sample and final (phase, freq) of the carrier PLL.

    ``x`` (rows, n) complex64; ``phase0``, ``freq0`` (rows,) float32; the
    coefficients are float32 values.  CPU tensors: `pll_scan_ref`.  CUDA
    tensors: the kernel on the current stream (``pll_scan.launches``
    counts); no fallback.
    """
    if x.device.type == "cpu":
        return pll_scan_ref(x, phase0, freq0, alpha, beta, fmin, fmax)
    _cuda_args("pll_scan", x, torch.complex64)
    rows, n = x.shape
    if phase0.shape != (rows,) or freq0.shape != (rows,):
        raise ValueError("pll_scan: shapes disagree")
    phase0 = phase0.to(torch.float32).contiguous()
    freq0 = freq0.to(torch.float32).contiguous()
    vco = torch.empty_like(x)
    phase, freq = torch.empty_like(phase0), torch.empty_like(freq0)
    entry = _build.bind("seq_loops", "pll_scan_launch",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 2
                        + (ctypes.c_float,) * 4 + (ctypes.c_void_p,))
    _build.launch(pll_scan, entry, x.device, x.data_ptr(), vco.data_ptr(),
                  phase0.data_ptr(), freq0.data_ptr(), phase.data_ptr(),
                  freq.data_ptr(), rows, n, alpha, beta, fmin, fmax)
    return vco, phase, freq


pll_scan.launches = 0


# -- Costas ------------------------------------------------------------

# error functions of `costas_scan` (the kernel's `mode` argument)
COSTAS_ORDER2, COSTAS_ORDER4, COSTAS_ORDER8, COSTAS_BROKEN = range(4)
# constellation phases of the malfunctioning Meteor-M2 transmitter
# (``meteor_costas.h``), the reference of `COSTAS_BROKEN`
BROKEN_PHASES = (0.47439988279190737, 2.1777839908413044,
                 3.8682349942715186, -0.29067248091319986)
_K8 = _f32(np.sqrt(2.0) - 1.0)
# The largest float32 T such that for every float32 |v| < T the float32
# quotient v / 2pi rounds (half to even) to +-0, so that the wrap
# v - 2pi * round(v / 2pi) is v - 2pi * (+-0) = v + 0: the float32 after
# float32(pi) (float32(pi) / 2pi is 0.5 exactly, which rounds to 0; the
# next float32's quotient is 0.5 + 2**-24, which rounds to 1).  The
# `costas_scan` kernel wraps its phase by the division only from T on
# (tests/test_torch_scan_exactness.py checks T exhaustively).
COSTAS_WRAP_FAST = float(np.nextafter(np.float32(np.pi), np.float32(np.inf)))
# The float32 where that quotient first rounds to 2 (v / 2pi = 1.5
# exactly): below it in magnitude the wrap is v - 2pi * k with k in
# {-1, +-0, 1}, which the kernel takes from two compares, without the
# division, where every |phase + freq + alpha * err| stays below it.
COSTAS_WRAP_TURN = float(np.float32(3.0) * np.float32(np.pi))


def _sign(t: torch.Tensor) -> torch.Tensor:
    """+1 where t > 0, else -1 (the reference's ``step``)."""
    return torch.where(t > 0, 1.0, -1.0).to(torch.float32)


def costas_error(re: torch.Tensor, im: torch.Tensor, mode: int):
    """Phase error of the mixed-down sample ``re + i*im``, clipped to
    [-1, 1]; every product and sum rounded on its own, in the kernel's
    order."""
    if mode == COSTAS_ORDER2:
        err = re * im
    elif mode == COSTAS_ORDER4:
        err = _sign(re) * im - _sign(im) * re
    elif mode == COSTAS_ORDER8:
        e_big = _sign(re) * im - _sign(im) * re * _K8
        e_small = _sign(re) * im * _K8 - _sign(im) * re
        err = torch.where(re.abs() >= im.abs(), e_big, e_small)
    elif mode == COSTAS_BROKEN:
        ang = torch.atan2(im, re)
        dps = torch.stack([_wrap_pi(ang - _f32(p)) for p in BROKEN_PHASES])
        first = dps.abs().argmin(dim=0, keepdim=True)  # first minimum
        err = torch.gather(dps, 0, first)[0] * torch.hypot(re, im)
    else:
        raise ValueError(f"costas: unknown error mode {mode}")
    return torch.clamp(err, -1.0, 1.0)


def costas_scan_ref(x, phase0, freq0, alpha, beta, fmin, fmax, mode):
    """Plain PyTorch version of `costas_scan`: the loop over time, all
    rows at once.  ``x``: (rows, n) complex64; carries (rows,) float32."""
    phase, freq = phase0.clone(), freq0.clone()
    xr, xi = x.real.unbind(-1), x.imag.unbind(-1)
    yr, yi = [], []
    for i in range(x.shape[-1]):
        neg = -phase
        c, s = torch.cos(neg), torch.sin(neg)
        re = xr[i] * c - xi[i] * s
        im = xr[i] * s + xi[i] * c
        err = costas_error(re, im, mode)
        freq = torch.clamp(freq + beta * err, fmin, fmax)
        phase = _wrap_pi(phase + freq + alpha * err)
        yr.append(re)
        yi.append(im)
    if not yr:
        return x.clone(), phase, freq
    return (torch.complex(torch.stack(yr, -1), torch.stack(yi, -1)),
            phase, freq)


def costas_scan(x, phase0, freq0, alpha, beta, fmin, fmax, mode):
    """Mixed-down samples and final (phase, freq) of the Costas loop.

    ``x`` (rows, n) complex64; ``phase0``, ``freq0`` (rows,) float32; the
    coefficients are float32 values; ``mode`` one of ``COSTAS_*``.  CPU
    tensors: `costas_scan_ref`.  CUDA tensors: the kernel on the current
    stream (``costas_scan.launches`` counts); no fallback.
    """
    if x.device.type == "cpu":
        return costas_scan_ref(x, phase0, freq0, alpha, beta, fmin, fmax,
                               mode)
    _cuda_args("costas_scan", x, torch.complex64)
    rows, n = x.shape
    if phase0.shape != (rows,) or freq0.shape != (rows,):
        raise ValueError("costas_scan: shapes disagree")
    if mode not in (COSTAS_ORDER2, COSTAS_ORDER4, COSTAS_ORDER8,
                    COSTAS_BROKEN):
        raise ValueError(f"costas_scan: unknown error mode {mode}")
    phase0 = phase0.to(torch.float32).contiguous()
    freq0 = freq0.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    phase, freq = torch.empty_like(phase0), torch.empty_like(freq0)
    entry = _build.bind("sync_loops", "costas_scan_launch",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 2
                        + (ctypes.c_float,) * 4 + (ctypes.c_int,)
                        + (ctypes.c_float,) * 6 + (ctypes.c_void_p,))
    _build.launch(costas_scan, entry, x.device, x.data_ptr(), y.data_ptr(),
                  phase0.data_ptr(), freq0.data_ptr(), phase.data_ptr(),
                  freq.data_ptr(), rows, n, alpha, beta, fmin, fmax, mode,
                  *(_f32(p) for p in BROKEN_PHASES), COSTAS_WRAP_FAST,
                  COSTAS_WRAP_TURN)
    return y, phase, freq


costas_scan.launches = 0


class _PhaseLoop(StreamOp):
    """Shared set-up of the second-order phase loops."""

    def __init__(self, bandwidth: float, init_phase: float = 0.0,
                 init_freq: float = 0.0, min_freq: float = -np.pi,
                 max_freq: float = np.pi, device="cuda"):
        self.device = resolve_device(device)
        self.alpha, self.beta = critically_damped(bandwidth)
        self.init_phase = float(init_phase)
        self.init_freq = float(init_freq)
        self.min_freq = float(min_freq)
        self.max_freq = float(max_freq)

    def init_state(self):
        return (torch.tensor(self.init_phase, dtype=torch.float32,
                             device=self.device),
                torch.tensor(self.init_freq, dtype=torch.float32,
                             device=self.device))

    def _coefficients(self):
        return (_f32(self.alpha), _f32(self.beta), _f32(self.min_freq),
                _f32(self.max_freq))


class Pll(_PhaseLoop):
    """Carrier-tracking PLL: emits the VCO phasor exp(i*phase) *before*
    advancing on each sample's phase error.  State: (phase, freq)."""

    def __call__(self, state, x):
        lead = x.shape[:-1]
        n = x.shape[-1]
        phase0, freq0 = (s.to(torch.float32).expand(lead).reshape(-1)
                         for s in state)
        vco, phase, freq = pll_scan(
            x.to(torch.complex64).reshape(-1, n).contiguous(), phase0, freq0,
            *self._coefficients())
        return (phase.reshape(lead), freq.reshape(lead)), vco.reshape(x.shape)


class Costas(_PhaseLoop):
    """Costas loop of order 2/4/8: outputs ``x * exp(-i*phase)``; the
    error function depends on the order.  One `costas_scan` launch per
    call on a CUDA tensor, its plain loop on a CPU tensor."""

    def __init__(self, order: int, bandwidth: float, **kw):
        assert order in (2, 4, 8)
        super().__init__(bandwidth, **kw)
        self.order = order
        self.error_mode = {2: COSTAS_ORDER2, 4: COSTAS_ORDER4,
                           8: COSTAS_ORDER8}[order]

    def __call__(self, state, x):
        lead = x.shape[:-1]
        n = x.shape[-1]
        phase0, freq0 = (s.to(torch.float32).expand(lead).reshape(-1)
                         for s in state)
        y, phase, freq = costas_scan(
            x.to(torch.complex64).reshape(-1, n).contiguous(), phase0, freq0,
            *self._coefficients(), self.error_mode)
        return (phase.reshape(lead), freq.reshape(lead)), y.reshape(x.shape)


# -- block-parallel pilot trackers -------------------------------------

class NormalizedPilot(StreamOp):
    """Block-parallel pilot 'PLL': ``vco = p / |p|`` on the filtered
    pilot — the bandpass has isolated the 19 kHz tone, so its normalised
    phasor is the locked VCO.  No carry, no state."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def init_state(self):
        return ()

    def __call__(self, state, p):
        mag = p.abs()
        vco = torch.where(mag > 1e-12, p / torch.clamp(mag, min=1e-12),
                          torch.ones_like(p))
        return state, vco.to(torch.complex64)


def _unwrap(p: torch.Tensor) -> torch.Tensor:
    """``jnp.unwrap`` along the last axis (period 2pi): difference, wrap
    each step into [-pi, pi), sum the corrections."""
    pi = float(np.pi)
    dd = p[..., 1:] - p[..., :-1]
    ddmod = torch.remainder(dd + pi, 2.0 * pi) - pi
    ddmod = torch.where((ddmod == -pi) & (dd > 0), pi, ddmod)
    correct = torch.where(dd.abs() < pi, 0.0, ddmod - dd)
    if correct.is_cuda and correct.numel() == correct.shape[-1]:
        # measured on an H100: a one-row float32 cumsum of 50 000 (the
        # regression pilot's) differed from itself in 3 of 200 runs, as
        # one of two rows in none, so a replayed pilot fit was not
        # bit-equal to its eager pass; PyTorch scans a single row with a
        # device-wide scan whose sums follow the order its tiles finish
        # in (tests/test_torch_radio_graph_cuda.py holds it fixed)
        sums = torch.cumsum(torch.stack((correct, correct)), dim=-1)[0]
    else:
        sums = torch.cumsum(correct, dim=-1)
    up = p[..., 1:] + sums
    return torch.cat([p[..., :1], up], dim=-1)


def pilot_phase_fit(p: torch.Tensor, f_nominal: float,
                    fs: float) -> torch.Tensor:
    """Per-block linear phase regression on a filtered pilot tone: an
    infinitely narrow PLL over the block.  Unwraps the pilot phase
    relative to the nominal frequency, least-squares fits
    ``theta[n] = a + b*n`` and returns exp(i*theta_fit).  Every reduction
    runs over the time axis only, so batched (..., n) pilots fit
    independently per row."""
    n = p.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=p.device)
    omega = _f32(2.0 * np.pi * f_nominal / fs)
    ramp = omega * idx
    resid = p * torch.complex(torch.cos(ramp), -torch.sin(ramp))
    theta = _unwrap(torch.atan2(resid.imag, resid.real))
    nf = float(n)
    sx = torch.sum(idx)
    sxx = torch.sum(idx * idx)
    sy = torch.sum(theta, dim=-1, keepdim=True)
    sxy = torch.sum(idx * theta, dim=-1, keepdim=True)
    denom = nf * sxx - sx * sx
    b = (nf * sxy - sx * sy) / denom
    a = (sy - b * sx) / nf
    theta_fit = a + b * idx + ramp
    return torch.complex(torch.cos(theta_fit),
                         torch.sin(theta_fit)).to(torch.complex64)
