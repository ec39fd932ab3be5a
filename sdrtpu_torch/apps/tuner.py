"""Tuning policies — ``core/src/gui/tuner.cpp`` capability (PyTorch
counterpart of ``sdrtpu/apps/tuner.py``; host code).

Decides how a requested absolute frequency maps onto (SDR center
frequency, VFO offset, view offset), with the reference's three policies:

- **center**: zero the VFO offset and retune the SDR to the frequency,
- **normal**: move the VFO within the current passband when it fits
  (keeping the hardware tuned), else retune the SDR and park the VFO near
  the edge (with the reference's viewBW/10 margin),
- **iq_only**: retune the SDR without touching VFOs.

Operates on a plain state object with callbacks, so it drives either the
local `Receiver` (retune = rebuild) or remote hardware
(rtl_tcp/SpyServer/Hermes clients).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class TunerState:
    center_freq: float            # SDR hardware tune frequency
    bandwidth: float              # SDR sample-rate span
    view_offset: float = 0.0
    view_bandwidth: float | None = None  # defaults to full bandwidth
    vfo_offsets: dict[str, float] = field(default_factory=dict)
    vfo_bandwidths: dict[str, float] = field(default_factory=dict)
    tune_hw: Callable[[float], None] = lambda f: None
    set_vfo_offset: Callable[[str, float], None] = lambda n, o: None

    def __post_init__(self):
        if self.view_bandwidth is None:
            self.view_bandwidth = self.bandwidth


def center_tuning(st: TunerState, vfo: str | None, freq: float) -> None:
    if vfo is not None and vfo in st.vfo_offsets:
        st.vfo_offsets[vfo] = 0.0
        st.set_vfo_offset(vfo, 0.0)
    st.center_freq = freq
    st.view_offset = 0.0
    st.tune_hw(freq)


def iq_tuning(st: TunerState, freq: float) -> None:
    st.center_freq = freq
    st.tune_hw(freq)


def normal_tuning(st: TunerState, vfo: str | None, freq: float) -> None:
    if vfo is None or vfo not in st.vfo_offsets:
        center_tuning(st, vfo, freq)
        return
    bw = st.bandwidth
    view_bw = st.view_bandwidth
    vfo_bw = st.vfo_bandwidths.get(vfo, 0.0)

    new_off = freq - st.center_freq
    bottom, top = -bw / 2.0, bw / 2.0
    vfo_bottom = new_off - vfo_bw / 2.0
    vfo_top = new_off + vfo_bw / 2.0

    if vfo_bottom > bottom and vfo_top < top:
        # fits in the current passband: just move the VFO
        st.vfo_offsets[vfo] = new_off
        st.set_vfo_offset(vfo, new_off)
        return
    if vfo_bottom <= bottom:
        # too low: park the VFO near the top edge and retune down
        new_vfo_off = bw / 2.0 - vfo_bw / 2.0 - view_bw / 10.0
    else:
        # too high: park near the bottom edge and retune up
        new_vfo_off = vfo_bw / 2.0 - bw / 2.0 + view_bw / 10.0
    st.vfo_offsets[vfo] = new_vfo_off
    st.set_vfo_offset(vfo, new_vfo_off)
    st.center_freq = freq - new_vfo_off
    st.tune_hw(st.center_freq)


def tune(st: TunerState, mode: str, vfo: str | None, freq: float) -> None:
    if mode == "center":
        center_tuning(st, vfo, freq)
    elif mode == "normal":
        normal_tuning(st, vfo, freq)
    elif mode == "iq_only":
        iq_tuning(st, freq)
    else:
        raise ValueError(f"unknown tuner mode {mode}")
