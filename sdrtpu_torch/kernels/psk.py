"""PSK demodulation chains and the Meteor M2 LRPT demodulator (PyTorch
counterpart of ``sdrtpu/kernels/psk.py``).

- `FastAgc` — ``out[i] = in[i]*gain; gain += (setPoint - |out[i]|)*rate``
  (``loop/fast_agc.h:64-85``), i.e. the linear recurrence ``gain_i =
  (1 - rate*|in_i|)*gain_{i-1} + setPoint*rate``, solved across the block
  by `first_order_recurrence`; the max-gain clamp is applied afterwards,
  as in the reference.
- `MeteorCostas` — 4th-order Costas with the optional "broken
  modulation" error for malfunctioning M2 birds (``meteor_costas.h``),
  one `costas_scan` launch per block on the card.
- `Psk` — RRC -> FastAGC -> Costas(order) -> M&M (``demod/psk.h``).
- `MeteorDemod` — RRC -> FastAGC -> MeteorCostas -> optional OQPSK
  one-sample Q delay -> M&M (``meteor_demod.h:150-167``); without the
  delay the Costas and M&M scans are one `costas_mm_scan` launch on the
  card (`clock.costas_mm_scan`), with it two; defaults from
  ``meteor_demodulator/src/main.cpp:66``: 72 ksym/s from 150 ksps, RRC 33
  taps beta 0.6, AGC rate 0.1, Costas bw 0.005, omegaGain 1e-6, muGain
  0.01.  It is also a receiver VFO's chain (``VfoConfig(mode=
  "meteor_lrpt")``): ``if_rate``, ``block_multiple``, ``out_len``, and a
  ``sdrtpu.rx.demod`` span (argument: the decoder) around each call.
- `Gfsk` — quadrature discriminator -> RRC -> M&M (float mode).

Every chain's state keeps the reference's keys, so it converts one to
one (`sdrtpu_torch.convert`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from ..metrics import span
from . import clock
from . import taps as tapsmod
from .clock import MuellerMuller
from .demod import Quadrature
from .fir import Fir
from .iir import first_order_recurrence
from .loops import BROKEN_PHASES, COSTAS_BROKEN, Costas


class FastAgc(StreamOp):
    """Multiplicative AGC with the reference's ``loop::FastAGC``
    semantics.  State: the gain before the block's first sample.  Leading
    axes are independent rows."""

    def __init__(self, set_point: float = 1.0, max_gain: float = 10e6,
                 rate: float = 0.1, init_gain: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        self.set_point = np.float32(set_point)
        self.max_gain = np.float32(max_gain)
        self.rate = np.float32(rate)
        self.init_gain = np.float32(init_gain)

    def init_state(self):
        return torch.tensor(self.init_gain, dtype=torch.float32,
                            device=self.device)

    def __call__(self, state, x):
        lead = x.shape[:-1]
        g0 = state.to(torch.float32).expand(lead)
        amps = x.abs().to(torch.float32)
        a = 1.0 - float(self.rate) * amps
        b = torch.full_like(amps, float(self.set_point * self.rate))
        gains = first_order_recurrence(a, b, g0[..., None])
        gains = torch.clamp(gains, max=float(self.max_gain))
        gains_prev = torch.cat([g0[..., None], gains[..., :-1]], dim=-1)
        return gains[..., -1], x * gains_prev


class MeteorCostas(Costas):
    """Costas(4) with the optional broken-modulation error
    (``meteor_costas.h``).  State: (phase, freq)."""

    BROKEN_PHASES = BROKEN_PHASES

    def __init__(self, bandwidth: float, broken_modulation: bool = False,
                 **kw):
        super().__init__(4, bandwidth, **kw)
        self.broken = bool(broken_modulation)
        if self.broken:
            self.error_mode = COSTAS_BROKEN


def _rrc(tap_count, beta, symbolrate, samplerate, dtype, device):
    taps = tapsmod.root_raised_cosine_rate(tap_count, beta, symbolrate,
                                           samplerate)
    return Fir(taps, dtype=dtype, device=device)


class Psk(StreamOp):
    """Generic PSK receive chain (``demod/psk.h``): returns masked
    symbols ``(syms, valid)`` of length ``max_out(n)``."""

    def __init__(self, order: int, symbolrate: float, samplerate: float,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 agc_rate: float = 0.1, costas_bandwidth: float = 0.005,
                 omega_gain: float = 1e-6, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01, device="cuda"):
        self.device = dev = resolve_device(device)
        self.rrc = _rrc(rrc_tap_count, rrc_beta, symbolrate, samplerate,
                        torch.complex64, dev)
        self.agc = FastAgc(1.0, 10e6, agc_rate, device=dev)
        self.costas = Costas(order, costas_bandwidth, device=dev)
        self.recov = MuellerMuller(samplerate / symbolrate, omega_gain,
                                   mu_gain, omega_rel_limit, device=dev)

    def max_out(self, n: int) -> int:
        return self.recov.max_out(n)

    def init_state(self):
        return {
            "rrc": self.rrc.init_state(),
            "agc": self.agc.init_state(),
            "costas": self.costas.init_state(),
            "mm": self.recov.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["rrc"], y = self.rrc(state["rrc"], x)
        st["agc"], y = self.agc(state["agc"], y)
        st["costas"], y = self.costas(state["costas"], y)
        st["mm"], (syms, valid) = self.recov(state["mm"], y)
        return st, (syms, valid)


class MeteorDemod(StreamOp):
    """Meteor M2 LRPT QPSK demodulator (``meteor_demod.h``): complex IQ
    at ``samplerate`` -> masked soft QPSK symbols ``(syms, valid)`` of
    length ``max_out(n)``."""

    decoder = "meteor_lrpt"

    def __init__(self, symbolrate: float = 72000.0,
                 samplerate: float = 150000.0, rrc_tap_count: int = 33,
                 rrc_beta: float = 0.6, agc_rate: float = 0.1,
                 costas_bandwidth: float = 0.005,
                 broken_modulation: bool = False, oqpsk: bool = False,
                 omega_gain: float = 1e-6, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01, device="cuda"):
        self.device = dev = resolve_device(device)
        self.rrc = _rrc(rrc_tap_count, rrc_beta, symbolrate, samplerate,
                        torch.complex64, dev)
        self.agc = FastAgc(1.0, 10e6, agc_rate, device=dev)
        self.costas = MeteorCostas(costas_bandwidth, broken_modulation,
                                   device=dev)
        self.oqpsk = oqpsk
        self.recov = MuellerMuller(samplerate / symbolrate, omega_gain,
                                   mu_gain, omega_rel_limit, device=dev)
        self.if_rate = float(samplerate)

    def max_out(self, n: int) -> int:
        return self.recov.max_out(n)

    out_len = max_out

    def block_multiple(self) -> int:
        return 1

    def init_state(self):
        return {
            "rrc": self.rrc.init_state(),
            "agc": self.agc.init_state(),
            "costas": self.costas.init_state(),
            "last_i": torch.zeros((), dtype=torch.float32,
                                  device=self.device),
            "mm": self.recov.init_state(),
        }

    def __call__(self, state, x):
        with span("sdrtpu.rx.demod", self.decoder):
            return self._demod(state, x)

    def _demod(self, state, x):
        st = dict(state)
        st["rrc"], y = self.rrc(state["rrc"], x)
        st["agc"], y = self.agc(state["agc"], y)
        if not self.oqpsk:
            st["costas"], st["mm"], out = self._loops(
                state["costas"], state["mm"], y)
            return st, out
        st["costas"], y = self.costas(state["costas"], y)
        # one-sample delay on Q (``meteor_demod.h:157-163``)
        im_prev = torch.cat([state["last_i"].reshape(1), y.imag[:-1]])
        st["last_i"] = y.imag[-1]
        y = torch.complex(y.real, im_prev)
        st["mm"], (syms, valid) = self.recov(state["mm"], y)
        return st, (syms, valid)

    def _loops(self, costas_state, mm_state, y):
        """``self.costas`` on ``y``, then ``self.recov`` on its output, as
        one `costas_mm_scan`: ``(costas_state, mm_state, (syms, valid))``,
        what the two calls give."""
        mm = self.recov
        lead = y.shape[:-1]
        n = y.shape[-1]
        rows = int(np.prod(lead, dtype=np.int64))

        def flat(t, dtype):
            return t.to(dtype).expand(lead).reshape(rows)

        tail = mm_state["tail"].to(mm.dtype).expand(
            lead + (mm.T - 1,)).reshape(rows, mm.T - 1)
        _, phase, freq, syms, valid, tail, leaves = clock.costas_mm_scan(
            y.to(torch.complex64).reshape(rows, n), tail,
            flat(costas_state[0], torch.float32),
            flat(costas_state[1], torch.float32),
            *self.costas._coefficients(), self.costas.error_mode, mm._bank,
            mm.max_out(n), [flat(mm_state[k], dtype) for k, dtype in
                            clock._MM_LEAVES], *mm._loop())
        n_out = syms.shape[-1]
        return ((phase.reshape(lead), freq.reshape(lead)),
                mm._new_state(tail, leaves, lead),
                (syms.reshape(lead + (n_out,)),
                 valid.reshape(lead + (n_out,))))


class Gfsk(StreamOp):
    """GFSK receive chain (``demod/gfsk.h``): quadrature discriminator ->
    RRC matched filter -> M&M (float mode).  Output: masked real symbols
    (one per baud)."""

    def __init__(self, symbolrate: float, samplerate: float,
                 deviation_hz: float, rrc_tap_count: int = 33,
                 rrc_beta: float = 0.35, omega_gain: float = 1e-6,
                 mu_gain: float = 0.01, omega_rel_limit: float = 0.01,
                 device="cuda"):
        self.device = dev = resolve_device(device)
        self.quad = Quadrature(deviation_hz, samplerate, device=dev)
        self.rrc = _rrc(rrc_tap_count, rrc_beta, symbolrate, samplerate,
                        torch.float32, dev)
        self.recov = MuellerMuller(samplerate / symbolrate, omega_gain,
                                   mu_gain, omega_rel_limit,
                                   complex_mode=False, device=dev)

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

