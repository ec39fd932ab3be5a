"""Frequency translation (PyTorch counterpart of ``sdrtpu/kernels/mixer.py``).

``y[n] = x[n] * exp(i*(phi0 + omega*n))`` in closed form.  ``omega*n``
reaches ~1e6 rad over a long block, which float32 cannot hold with a
usable phase, so the wrapped ramp is built from two exact float64 host
tables of ``omega*k mod 2pi`` — a coarse one every `_FINE` samples and a
fine one over ``0.._FINE`` — added and wrapped on the device.  The phase
advance per block, ``(omega*N) mod 2pi``, is also float64 on the host, so
the carried phase never grows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp

_TWO_PI = 2.0 * np.pi
_TWO_PI_F32 = float(np.float32(_TWO_PI))
_FINE = 1024  # fine-table length; the coarse table covers multiples of it


def _phase_tables(omega: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(coarse, fine) float32 wrapped-phase tables for a block of ``n``."""
    fine = min(_FINE, n)
    n_coarse = -(-n // fine)
    fine_t = np.mod(omega * np.arange(fine, dtype=np.float64), _TWO_PI)
    coarse_t = np.mod(omega * fine * np.arange(n_coarse, dtype=np.float64),
                      _TWO_PI)
    return coarse_t.astype(np.float32), fine_t.astype(np.float32)


def _rotate(x, coarse, fine, phase):
    """``x * exp(i*wrap(coarse[:, None] + fine[None, :] + phase))``."""
    n = x.shape[-1]
    angles = (coarse[:, None] + fine[None, :]).reshape(-1)[:n]
    # floored modulo, as jnp.mod (fmod would keep the sign of the angle)
    angles = torch.remainder(angles + phase, _TWO_PI_F32)
    return x * torch.complex(torch.cos(angles), torch.sin(angles))


class FreqXlator(StreamOp):
    """Multiply by ``exp(i*2pi*offset/fs * n)``, phase-continuous across
    blocks.  A positive ``offset_hz`` moves the spectrum up; to bring a
    channel at +f down to baseband pass ``-f``.  State: the phase."""

    def __init__(self, offset_hz: float, samplerate: float, device="cuda"):
        self.device = resolve_device(device)
        self.offset_hz = float(offset_hz)
        self.samplerate = float(samplerate)
        self._omega = _TWO_PI * (self.offset_hz / self.samplerate)
        self._ramp_cache: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def init_state(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _tables(self, n: int):
        """Device copies of the tables for block length ``n``, cached."""
        if n not in self._ramp_cache:
            coarse, fine = _phase_tables(self._omega, n)
            self._ramp_cache[n] = (
                torch.as_tensor(coarse, device=self.device),
                torch.as_tensor(fine, device=self.device))
        return self._ramp_cache[n]

    def _block_delta(self, n: int) -> float:
        return float(np.float32(np.mod(self._omega * n, _TWO_PI)))

    def __call__(self, state, x):
        n = x.shape[-1]
        coarse, fine = self._tables(n)
        y = _rotate(x, coarse, fine, state)
        new_phase = torch.remainder(state + self._block_delta(n), _TWO_PI_F32)
        return new_phase, y


class TunableXlator(StreamOp):
    """`FreqXlator` whose tables are state leaves, so the offset changes
    by a table swap (`retune_state`) while the phase runs on.  The block
    length is fixed at construction."""

    def __init__(self, offset_hz: float, samplerate: float, block_len: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.offset_hz = float(offset_hz)
        self.samplerate = float(samplerate)
        self.block_len = int(block_len)

    def _tables(self, offset_hz: float) -> dict:
        omega = _TWO_PI * (float(offset_hz) / self.samplerate)
        coarse, fine = _phase_tables(omega, self.block_len)
        delta = np.float32(np.mod(omega * self.block_len, _TWO_PI))
        return {
            "fine": torch.as_tensor(fine, device=self.device),
            "coarse": torch.as_tensor(coarse, device=self.device),
            "delta": torch.tensor(delta, dtype=torch.float32,
                                  device=self.device),
        }

    def init_state(self):
        st = self._tables(self.offset_hz)
        st["phase"] = torch.zeros((), dtype=torch.float32, device=self.device)
        return st

    def retune_state(self, state, offset_hz: float) -> dict:
        """Swap in tables for a new offset; the phase stays continuous."""
        self.offset_hz = float(offset_hz)
        st = self._tables(offset_hz)
        st["phase"] = state["phase"]
        return st

    def __call__(self, state, x):
        n = x.shape[-1]
        assert n == self.block_len, (n, self.block_len)
        y = _rotate(x, state["coarse"], state["fine"], state["phase"])
        new_phase = torch.remainder(state["phase"] + state["delta"],
                                    _TWO_PI_F32)
        return {**state, "phase": new_phase}, y
