"""Flagship pipeline: wideband IQ -> N simultaneous WBFM stereo receivers.

PyTorch counterpart of ``sdrtpu/apps/wbfm_pipeline.py``:

    wideband (fs_in) --Channelizer--> (C, n_if) @ 250 kHz
      per channel:  BroadcastFm stereo (envelope pilot) -> (2, C, n_if)
      audio:        RationalResampler 250k->48k        -> (2, C, n_af)
                    Deemphasis 50 us                   -> audio out
      waterfall:    SpectrumAnalyzer on the wideband   -> (frames, fft_size) dB

Steady state (`scan_call`/`scan_repeat`), in sub-windows of blocks:

- the fft and pfb channelizers take any multiple of ``block_len`` as one
  window, so each sub-window runs once through the whole chain
  (`_batched`);
- the other channelizer methods ("pallas", "xla-fused", "xla") take one
  block per call, so the front end runs once per block in a Python loop
  (`_front_window`) and the IF-rate back end once per sub-window.

On the card the IF back end (demod, audio resampler, de-emphasis) is one
CUDA graph per input shape (`graph.cuda_graph.GraphedStep`), captured on
a shape's second pass and replayed from then on; its counters are
``_if_graph.captures``, ``.replays`` and ``.eager_passes``.

Spans (`metrics.span`, host ranges while ``torch.profiler`` records):
``sdrtpu.wbfm.call`` around `__call__`, ``sdrtpu.wbfm.scan_call`` around
`scan_call` and `scan_repeat`, both with the pipeline's call count as
argument; ``sdrtpu.wbfm.window`` around each sub-window; inside them
``sdrtpu.channelizer`` (`Channelizer`), ``sdrtpu.if_back_end`` (demod,
audio resampler, de-emphasis) and ``sdrtpu.waterfall``
(`SpectrumAnalyzer.transform`), which never nest in one another.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp, tree_map, tree_stack
from ..graph.cuda_graph import GraphedStep
from ..kernels.fftspec import SpectrumAnalyzer
from ..kernels.iir import Deemphasis
from ..kernels.resample import RationalResampler
from ..kernels.wfm import BroadcastFm
from ..metrics import span
from ..shard.channelizer import Channelizer


class WbfmMultiVfoPipeline(StreamOp):
    """Full multi-VFO WBFM receiver as one stream op.

    ``block_len`` is the wideband input block length (a multiple of
    `block_multiple()`).  ``sub_samples`` is the sub-window length of the
    batched steady state, in samples: 4e6 is the reference's value, chosen
    on a TPU and not measured on the card.
    """

    def __init__(self, offsets_hz, in_samplerate: float, block_len: int,
                 if_rate: float = 250000.0, audio_rate: float = 48000.0,
                 deviation: float = 75000.0, stereo: bool = True,
                 tau: float = 50e-6, channelizer_method: str = "auto",
                 sparse_fold_db: float | None = None, spectrum: bool = False,
                 fft_size: int = 65536, fft_rate: float = 20.0,
                 pilot_mode: str = "envelope", skip_rotator: bool = False,
                 sub_samples: float = 4e6, device="cuda"):
        self.device = resolve_device(device)
        dev = self.device
        self.offsets = np.asarray(offsets_hz, np.float64)
        self.n_channels = len(self.offsets)
        self.block_len = int(block_len)
        self.sub_samples = float(sub_samples)
        self.skip_rotator = bool(skip_rotator)
        self.calls = 0  # entry calls so far: the id of a call's spans
        self.channelizer = Channelizer(
            self.offsets, in_samplerate, if_rate, block_len,
            method=channelizer_method, sparse_thresh_db=sparse_fold_db,
            skip_rotator=self.skip_rotator, device=dev)
        # the 15 kHz audio lowpass is folded into the audio resampler's
        # prototype (bw/trans_bw below), as in the reference
        self.demod = BroadcastFm(
            deviation=deviation, samplerate=if_rate, stereo=stereo,
            low_pass=False, pilot_mode=pilot_mode,
            subcarrier_droop_comp=True,
            channel_derotate=self.skip_rotator, device=dev)
        self.audio_resamp = RationalResampler(
            if_rate, audio_rate, dtype=torch.float32, bw=15000.0,
            trans_bw=4000.0, device=dev)
        # scalar initial state broadcasts over the (2, C, n) audio and
        # becomes (2, C, 1) after the first block
        self.deemph = Deemphasis(tau, audio_rate, device=dev)
        self._if_graph = GraphedStep()
        n_if = self.channelizer.out_len(block_len)
        assert n_if % self.audio_resamp.block_multiple() == 0, (
            f"IF block {n_if} not a multiple of audio quantum "
            f"{self.audio_resamp.block_multiple()}")
        # optional per-window reduction of the spectrum (e.g. torch.amax
        # for a throughput probe); None = full frames
        self.spec_reduce = None
        self.spectrum = None
        if spectrum:
            self.spectrum = SpectrumAnalyzer(in_samplerate, fft_size,
                                             fft_rate, device=dev)
            assert block_len % self.spectrum.interval == 0, (
                f"block {block_len} not a multiple of FFT interval "
                f"{self.spectrum.interval}")

    @staticmethod
    def block_multiple(in_samplerate, if_rate=250000.0,
                       audio_rate=48000.0) -> int:
        front = RationalResampler(in_samplerate, if_rate, device="cpu")
        audio = RationalResampler(if_rate, audio_rate, device="cpu")
        return front.block_multiple() * audio.block_multiple()

    def _residual_rot(self) -> torch.Tensor:
        return torch.as_tensor(self.channelizer.fused.residual_omega.copy(),
                               device=self.device)

    def init_state(self):
        st = {
            "chan": self.channelizer.init_state(),
            "demod": self.demod.init_state(),
            "audio": self.audio_resamp.init_state(),
            "deemph": self.deemph.init_state(),
        }
        if self.skip_rotator:
            st["demod"]["quad"] = {"prev": st["demod"]["quad"]["prev"],
                                   "rot": self._residual_rot()}
        return st

    def out_len(self, n: int) -> int:
        return self.audio_resamp.out_len(self.channelizer.out_len(n))

    def retune_state(self, state, offsets_hz) -> dict:
        """Retune every VFO by a table swap; every carry is kept."""
        st = dict(state)
        st["chan"] = self.channelizer.retune_state(state["chan"], offsets_hz)
        self.offsets = np.asarray(offsets_hz, np.float64)
        if self.skip_rotator:
            st["demod"] = dict(st["demod"])
            st["demod"]["quad"] = {**st["demod"]["quad"],
                                   "rot": self._residual_rot()}
        return st

    def __call__(self, state, x):
        self.calls += 1
        with span("sdrtpu.wbfm.call", self.calls):
            st = dict(state)
            st["chan"], y = self.channelizer(state["chan"], x)  # (C, n_if)
            a = self._if_back_end(st, state, y)
            if self.spectrum is not None:
                _, spec = self.spectrum((), x)  # (frames, fft_size) dB
                return st, (a, spec)
            return st, a

    def _if_back_end(self, st, state, y):
        """Demod, audio resampler and de-emphasis of the IF ``y`` (C, n),
        their states into ``st``: the audio (2, C, n_af).  On the card,
        from a key's second pass on, one CUDA graph replay (`GraphedStep`)."""
        with span("sdrtpu.if_back_end", self.calls):
            (st["demod"], st["audio"], st["deemph"]), a = self._if_graph(
                self._if_chain,
                (state["demod"], state["audio"], state["deemph"]), y)
        return a

    def _if_chain(self, states, y):
        """The IF back end's eager body: ``(demod, audio, deemph)``
        states and the IF -> their new states and the audio."""
        demod, audio, deemph = states
        demod, (stereo, _) = self.demod(demod, y)
        audio, a = self.audio_resamp(audio, stereo)
        deemph, a = self.deemph(deemph, a)
        return (demod, audio, deemph), a

    # -- batched steady state ------------------------------------------------

    def _back_end(self, st, state, y, segs, K: int):
        """IF-rate tail on the (C, K*n_if) window, reframed per block:
        audio (K, 2, C, n_af) and spectra (K, frames, fft_size)."""
        a = self._if_back_end(st, state, y)
        a = a.reshape(a.shape[0], a.shape[1], K, -1).movedim(2, 0)
        if self.spectrum is not None:
            spec = self.spectrum.transform(segs)
            if self.spec_reduce is not None:
                return st, (a, self.spec_reduce(spec))
            return st, (a, spec.reshape(K, -1, spec.shape[-1]))
        return st, a

    def _batched(self, state, x_cat, K: int):
        """One pass of the whole chain over a K-block window."""
        with span("sdrtpu.wbfm.window", self.calls):
            st = dict(state)
            st["chan"], y = self.channelizer(state["chan"], x_cat)
            segs = (self.spectrum.extract(x_cat)
                    if self.spectrum is not None else ())
            return self._back_end(st, state, y, segs, K)

    def _front_body(self, chan_state, xb):
        """One block through the channelizer, plus its waterfall segments."""
        chan_state, y = self.channelizer(chan_state, xb)
        segs = self.spectrum.extract(xb) if self.spectrum is not None else ()
        return chan_state, (y, segs)

    def _back_batch(self, state, chan_state, ys, segs, K: int):
        """Per-block IF ``ys`` (K of (C, n_if)) and segments -> outputs."""
        st = {"chan": chan_state}
        y = torch.cat(ys, dim=-1)  # (C, K*n_if)
        if self.spectrum is not None:
            segs = torch.cat(segs)  # (K*frames, nz)
        return self._back_end(st, state, y, segs, K)

    def _front_window(self, state, blocks, K: int):
        """Per-block front end over the K ``blocks`` of one sub-window,
        then the shared back end once: the path of the channelizer
        methods that take one block per call."""
        with span("sdrtpu.wbfm.window", self.calls):
            chan_state, ys, segs = state["chan"], [], []
            for xb in blocks:
                chan_state, (y, seg) = self._front_body(chan_state, xb)
                ys.append(y)
                segs.append(seg)
            return self._back_batch(state, chan_state, ys, segs, K)

    def _subk(self, K: int) -> int:
        """Blocks per sub-window: floor(sub_samples / block_len), at
        least 1, lowered until it divides K."""
        sub = min(K, max(1, int(self.sub_samples // self.block_len)))
        while K % sub:
            sub -= 1
        return sub

    @staticmethod
    def _unstack(outs, K: int, n_sub: int, sub: int):
        """Stacked per-sub-window outputs (n_sub, sub, ...) -> (K, ...)."""
        stacked = tree_stack(outs)
        return tree_map(
            lambda a: (a.reshape((K,) + a.shape[2:])
                       if a.ndim >= 2 and a.shape[:2] == (n_sub, sub) else a),
            stacked)

    def _whole_windows(self) -> bool:
        """Whether the channelizer takes a whole sub-window per call."""
        return self.channelizer.method in ("fft", "pfb")

    def scan_call(self, state, xs):
        """K stacked wideband blocks ``(K, block_len)`` -> K blocks of output
        (audio ``(K, 2, C, n_af)``, spectra ``(K, frames, fft_size)``)."""
        self.calls += 1
        with span("sdrtpu.wbfm.scan_call", self.calls):
            K = xs.shape[0]
            sub = self._subk(K)
            if self._whole_windows():
                windows = xs.reshape(K // sub, sub * xs.shape[-1])

                def run(state, xw):
                    return self._batched(state, xw, sub)
            else:
                windows = xs.reshape(K // sub, sub, xs.shape[-1])

                def run(state, xw):
                    return self._front_window(state, xw, sub)
            return self._windows(state, run, windows, K, sub)

    def scan_repeat(self, state, x, K: int):
        """Like `scan_call` on K copies of ONE device-resident block (the
        benchmark steady state)."""
        self.calls += 1
        with span("sdrtpu.wbfm.scan_call", self.calls):
            n = x.shape[-1]
            sub = self._subk(K)
            if self._whole_windows():
                x_sub = x[None, :].expand(sub, n).reshape(-1)

                def run(state, _):
                    return self._batched(state, x_sub, sub)
            else:
                def run(state, _):
                    return self._front_window(state, [x] * sub, sub)
            return self._windows(state, run, [None] * (K // sub), K, sub)

    def _windows(self, state, run, windows, K: int, sub: int):
        """``run`` over the sub-windows in order, outputs as (K, ...)."""
        if sub == K:
            return run(state, windows[0])
        outs = []
        for xw in windows:
            state, out = run(state, xw)
            outs.append(out)
        return state, self._unstack(outs, K, K // sub, sub)
