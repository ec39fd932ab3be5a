"""Receiver orchestration: source -> frontend -> VFOs -> demods -> sinks
(PyTorch counterpart of ``sdrtpu/apps/receiver.py``).

- `IQFrontend`: optional decimation and DC block, the spectrum branch,
  N named VFOs.  VFOs that share an IF rate are fused into one
  `Channelizer` once `bind()` fixes the block length.  A VFO whose mode
  names a digital decoder (`DECODERS`: ``"meteor_lrpt"``, SDR++'s
  meteor_demodulator) runs that demodulator where a radio VFO runs its
  `RadioChain`, and yields soft symbols where a radio VFO yields audio.
- `Receiver`: frames host IQ into fixed blocks, runs the frontend on the
  device under ``torch.inference_mode()``, hands audio and spectra to
  sinks, and each decoder VFO's symbols to its deframer, whose frames go
  to the VFO's frame sink.
- `BlockFramer`: accumulates reads of any size into the block quantum.

Spans (`metrics.span`, host ranges while ``torch.profiler`` records):
``sdrtpu.rx.frontend`` around `IQFrontend.__call__`; inside it
``sdrtpu.waterfall``, ``sdrtpu.channelizer`` (one a fused group),
``sdrtpu.rx.ddc`` around each unfused VFO's mixer and resampler,
``sdrtpu.rx.radio`` around each `RadioChain` call (argument: its mode)
and ``sdrtpu.rx.demod`` around each decoder VFO's demodulator (argument:
the decoder).  The deframers run outside the frontend (``sdrtpu.deframe``,
`decoders.ccsds`).

A step is the frontend call.  Each VFO's radio chain replays one
captured CUDA graph per input key on the card (`RadioChain`, its own
`graph.cuda_graph.GraphedStep`); the waterfall, the channelizers and the
per-VFO DDCs around them run eagerly.  Retuning swaps state tables;
switching a demodulator swaps one `Vfo` object and its state subtree,
and the new chain captures its own graph.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..convert import state_from_jax, state_to_numpy
from ..decoders.ccsds import QpskAmbiguityResolver
from ..graph.block import StreamOp
from ..kernels.fftspec import SpectrumAnalyzer
from ..kernels.iir import DcBlocker
from ..kernels.mixer import FreqXlator, TunableXlator
from ..kernels.psk import MeteorDemod
from ..kernels.resample import IntegerDecimator, RationalResampler
from ..metrics import span
from ..shard.channelizer import Channelizer
from .radio import RadioChain


# VFO modes that carry a digital decoder: mode -> (demodulator, deframer),
# each built as ``cls(device=...)`` with the decoder's SDR++ defaults
DECODERS = {"meteor_lrpt": (MeteorDemod, QpskAmbiguityResolver)}


@dataclass
class VfoConfig:
    offset_hz: float
    mode: str = "wfm"
    bandwidth: float | None = None
    squelch_db: float | None = None
    stereo: bool = True
    ctcss_tone: int | None = None


class BlockFramer:
    """Accumulate arbitrary-size host reads into fixed-size blocks."""

    def __init__(self, block_len: int, dtype=np.complex64):
        self.block_len = int(block_len)
        self._buf = np.zeros(0, dtype)

    def push(self, samples: np.ndarray):
        self.append(samples)
        while True:
            out = self.pop_block()
            if out is None:
                return
            yield out

    def append(self, samples: np.ndarray) -> None:
        self._buf = np.concatenate([self._buf, samples])

    def pop_block(self) -> np.ndarray | None:
        if len(self._buf) < self.block_len:
            return None
        out = self._buf[: self.block_len]
        self._buf = self._buf[self.block_len:]
        return out

    @property
    def pending(self) -> int:
        return len(self._buf)


class Vfo(StreamOp):
    """Single-VFO DDC and radio chain: xlate -> resample to IF ->
    RadioChain.  ``emit_iq=True`` also returns the IF-rate IQ ahead of
    the demodulator.  A decoder mode (`DECODERS`) puts its demodulator in
    the chain's place (``radio``), at its own rate, and the VFO's output
    is ``(symbols (max_out,) complex64, count)``: the first ``count``
    symbols are valid."""

    def __init__(self, cfg: VfoConfig, in_samplerate: float,
                 audio_rate: float, emit_iq: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.emit_iq = emit_iq
        self.in_samplerate = float(in_samplerate)
        self.audio_rate = float(audio_rate)
        self.xlator = FreqXlator(-cfg.offset_hz, in_samplerate,
                                 device=self.device)
        self.decoder = cfg.mode in DECODERS
        if self.decoder:
            self.radio = DECODERS[cfg.mode][0](device=self.device)
        else:
            self.radio = RadioChain(
                cfg.mode, audio_rate=audio_rate, bandwidth=cfg.bandwidth,
                squelch_db=cfg.squelch_db, stereo=cfg.stereo,
                ctcss_tone=cfg.ctcss_tone, device=self.device)
        # the DDC targets the chain's actual IF rate (raw mode runs at
        # the audio rate)
        self.ddc = RationalResampler(in_samplerate, self.radio.if_rate,
                                     device=self.device)

    def block_multiple(self) -> int:
        return self.ddc.block_multiple() * self.radio.block_multiple()

    def bind(self, block_len: int) -> None:
        """Fix the input block length: switch the mixer to the
        state-table `TunableXlator`, so `retune_state` can move the VFO."""
        if not isinstance(self.xlator, TunableXlator):
            self.xlator = TunableXlator(-self.cfg.offset_hz,
                                        self.in_samplerate, block_len,
                                        device=self.device)

    def retune_state(self, state, offset_hz: float) -> dict:
        """Move this VFO's offset by a state-table swap (bound VFOs)."""
        if not isinstance(self.xlator, TunableXlator):
            raise NotImplementedError(
                "retune_state needs a bound VFO (Receiver binds at build)")
        st = dict(state)
        st["xl"] = self.xlator.retune_state(state["xl"], -float(offset_hz))
        self.cfg.offset_hz = float(offset_hz)
        return st

    def init_state(self):
        return {"xl": self.xlator.init_state(),
                "ddc": self.ddc.init_state(),
                "radio": self.radio.init_state()}

    def out_len(self, n: int) -> int:
        return self.radio.out_len(self.ddc.out_len(n))

    def chain(self, state, y):
        """The radio chain (or decoder) on the IF ``y``."""
        st, out = self.radio(state, y)
        if self.decoder:
            syms, valid = out
            out = (syms, torch.count_nonzero(valid))
        return st, out

    def __call__(self, state, x):
        st = dict(state)
        with span("sdrtpu.rx.ddc"):
            st["xl"], y = self.xlator(state["xl"], x)
            st["ddc"], y = self.ddc(state["ddc"], y)
        st["radio"], audio = self.chain(state["radio"], y)
        if self.emit_iq:
            return st, (audio, y)
        return st, audio


class IQFrontend(StreamOp):
    """DC block, spectrum branch and N named VFOs as one stream op.

    VFOs sharing an IF rate are fused into one `Channelizer` front end
    (method "auto") once `bind()` fixes the block length — `Receiver`
    does this; a lone VFO of a rate keeps its own xlate + resample path.
    ``fuse=False`` disables grouping.
    """

    def __init__(self, samplerate: float, vfos: dict[str, VfoConfig],
                 audio_rate: float = 48000.0, dc_block: bool = False,
                 decimation: int = 1, fft_size: int = 65536,
                 fft_rate: float = 20.0, spectrum: bool = True,
                 fuse: bool = True, device="cuda"):
        self.device = resolve_device(device)
        dev = self.device
        self.samplerate = float(samplerate)
        self.decimation = int(decimation)
        self.predecim = (IntegerDecimator(samplerate, self.decimation,
                                          device=dev)
                         if self.decimation > 1 else None)
        eff = self.samplerate / self.decimation
        self.effective_samplerate = eff
        self.dc = DcBlocker(50.0 / eff, device=dev) if dc_block else None
        self.spectrum = (SpectrumAnalyzer(eff, fft_size, fft_rate, device=dev)
                         if spectrum else None)
        self.vfos = {name: Vfo(cfg, eff, audio_rate, device=dev)
                     for name, cfg in vfos.items()}
        self._fuse = fuse
        self._groups: dict[float, tuple[list[str], Channelizer]] = {}
        self._bound_len: int | None = None

    def block_multiple(self) -> int:
        m = 1
        for v in self.vfos.values():
            m = np.lcm(m, v.block_multiple())
        if self.spectrum:
            m = np.lcm(m, self.spectrum.interval)
        return int(m) * self.decimation

    def bind(self, block_len: int) -> None:
        """Fix the input block length; fuse same-IF-rate VFO groups.

        The fused `Channelizer` needs a fixed block length for its chunk
        plan and mixer tables, so grouping happens here and not in
        ``__init__``.  Idempotent per length.
        """
        if self._bound_len == block_len:
            return
        if self._bound_len is not None:
            # the channelizers and any live Receiver state belong to one
            # block length
            raise ValueError(
                f"IQFrontend already bound to block_len={self._bound_len}; "
                "create a separate IQFrontend per Receiver")
        inner = block_len // self.decimation
        if self._fuse:
            by_rate: dict[float, list[str]] = {}
            for name, vfo in self.vfos.items():
                by_rate.setdefault(vfo.radio.if_rate, []).append(name)
            self._groups = {}
            for if_rate, names in by_rate.items():
                if len(names) < 2:
                    continue
                offsets = [self.vfos[n].cfg.offset_hz for n in names]
                try:
                    chan = Channelizer(offsets, self.effective_samplerate,
                                       if_rate, inner, device=self.device)
                except (AssertionError, ValueError):
                    continue  # no valid plan for this length: stay per-VFO
                self._groups[if_rate] = (names, chan)
        grouped = self._grouped_names()
        for name, vfo in self.vfos.items():
            if name not in grouped:
                vfo.bind(inner)
        self._bound_len = block_len

    def _grouped_names(self) -> set:
        out = set()
        for names, _ in self._groups.values():
            out.update(names)
        return out

    def _group_of(self, name: str):
        """(state key, names, channelizer) of ``name``'s fused group, or
        None for a per-VFO path."""
        for if_rate, (names, chan) in self._groups.items():
            if name in names:
                return f"{if_rate:.0f}", names, chan
        return None

    def retune(self, state, name: str, offset_hz: float):
        """Move one VFO by a table swap; returns the updated state.
        Grouped VFOs swap the whole group's offset tables, per-VFO paths
        their mixer tables."""
        if name not in self.vfos:
            raise KeyError(name)
        st = dict(state)
        hit = self._group_of(name)
        if hit is not None:
            key, names, chan = hit
            offsets = [offset_hz if n == name else self.vfos[n].cfg.offset_hz
                       for n in names]
            new_chan = dict(st["chan"])
            new_chan[key] = chan.retune_state(st["chan"][key], offsets)
            st["chan"] = new_chan
            self.vfos[name].cfg.offset_hz = float(offset_hz)
            return st
        new_vfos = dict(st["vfos"])
        new_vfos[name] = self.vfos[name].retune_state(st["vfos"][name],
                                                      offset_hz)
        st["vfos"] = new_vfos
        return st

    def init_state(self):
        grouped = self._grouped_names()
        st = {
            "pre": self.predecim.init_state() if self.predecim else (),
            "dc": self.dc.init_state() if self.dc else (),
            "vfos": {n: ({"radio": v.radio.init_state()} if n in grouped
                         else v.init_state())
                     for n, v in self.vfos.items()},
        }
        if self._groups:
            st["chan"] = {f"{if_rate:.0f}": chan.init_state()
                          for if_rate, (_, chan) in self._groups.items()}
        return st

    def __call__(self, state, x):
        with span("sdrtpu.rx.frontend"):
            st = {"pre": state["pre"], "dc": state["dc"], "vfos": {}}
            if self.predecim:
                st["pre"], x = self.predecim(state["pre"], x)
            if self.dc:
                st["dc"], x = self.dc(state["dc"], x)
            spec = None
            if self.spectrum:
                _, spec = self.spectrum((), x)
            audios = {}
            grouped = self._grouped_names()
            if self._groups:
                st["chan"] = {}
                for if_rate, (names, chan) in self._groups.items():
                    key = f"{if_rate:.0f}"
                    st["chan"][key], rows = chan(state["chan"][key], x)
                    for i, name in enumerate(names):
                        rst, audios[name] = self.vfos[name].chain(
                            state["vfos"][name]["radio"], rows[i])
                        st["vfos"][name] = {"radio": rst}
            for name, vfo in self.vfos.items():
                if name in grouped:
                    continue
                st["vfos"][name], audios[name] = vfo(state["vfos"][name], x)
            return st, (audios, spec)


def _to_host(t):
    if isinstance(t, tuple):  # a decoder VFO's (symbols, count)
        return tuple(_to_host(v) for v in t)
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Receiver:
    """Host side of the receiver: framing, dispatch to the device, sink fan-out.

    ``audio_sinks``: name -> callable(audio (2, n) float32 numpy).
    ``frame_sinks``: decoder VFO name -> callable(frame), fed each frame
    its deframer (``deframers[name]``, one a decoder VFO) finds in the
    VFO's symbols: for ``"meteor_lrpt"`` a (892,) uint8 CVCDU.
    ``spectrum_sink``: callable(db (frames, fft) float32 numpy).
    ``baseband_sinks``: callables fed every whole input block.
    ``scan_batch`` > 1 hands that many blocks to the frontend's
    ``scan_call`` per dispatch.  It brings no gain here: only the radio
    chains replay captured (CUDA-graph) steps, so a batch is a Python
    loop of the same calls plus a host stack of the blocks and of the
    outputs, and it measured no faster than ``scan_batch=1`` on an H100
    (with every launch eager).  It is kept for parity of the signature
    and of the batched = single results; leave it at 1.
    ``async_fetch``: number of worker threads that copy results to the
    host while `push` goes on dispatching (one emitter thread delivers
    them to the sinks in order); ``"auto"`` sizes the pool at `warmup`
    from the measured time of a step with its whole payload fetched;
    0 is synchronous.  `close` (or leaving a ``with`` block) ends the
    threads; `flush` and `run_file` end them too, and a later push starts
    them again.
    ``metrics``: a `metrics.MetricsRegistry` that records, as the
    reference's does, the input throughput (``receiver.input``, at the
    front end's sample rate, on every `push`) and each audio sink's RMS
    (gauge ``audio.<sink>.rms``, from the audio already on the host).
    """

    MODE_CACHE_SIZE = 8  # built Vfo objects kept for switching back
    # pool size when "auto" finds no payload to time a fetch with
    AUTO_WORKERS_NOTHING_TO_FETCH = 4

    def __init__(self, frontend: IQFrontend, block_len: int | None = None,
                 audio_sinks: dict[str, Callable] | None = None,
                 spectrum_sink: Callable | None = None,
                 baseband_sinks: list[Callable] | None = None,
                 scan_batch: int = 1, metrics=None,
                 async_fetch: int | str = 0,
                 frame_sinks: dict[str, Callable] | None = None):
        self.frontend = frontend
        self.device = frontend.device
        m = frontend.block_multiple()
        if block_len is None:
            block_len = max(1, 250000 // m) * m
        assert block_len % m == 0, f"block_len must be a multiple of {m}"
        self.block_len = block_len
        frontend.bind(block_len)  # fuse same-IF-rate VFO groups
        self.framer = BlockFramer(block_len)
        self.audio_sinks = audio_sinks or {}
        self.frame_sinks = frame_sinks or {}
        self.deframers: dict = {}
        self._sync_deframers()
        self.spectrum_sink = spectrum_sink
        self.baseband_sinks = baseband_sinks or []
        self.scan_batch = int(scan_batch)
        self._pending: list[np.ndarray] = []
        # guards _state AND the framer/pending host buffers: retune() and
        # save_checkpoint() may come from another thread while push() is
        # framing and dispatching.  Every dispatch path computes under
        # the lock and emits to the sinks after releasing it.
        self._state_lock = threading.RLock()
        self.metrics = metrics
        self._thr = (metrics.throughput("receiver.input", frontend.samplerate)
                     if metrics is not None else None)
        self.async_fetch = async_fetch
        self._emit_error = None
        self._fetch_pool = None
        self._emit_q = None
        self._emitter = None
        # (vfo name, mode, bandwidth) -> built Vfo, least recently used
        # first; bounded, so a control surface that sweeps bandwidths
        # cannot grow it
        self._mode_programs: collections.OrderedDict = (
            collections.OrderedDict())
        self._state = frontend.init_state()
        self._warmed = False

    # -- lifetime -------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """End the fetch pool and the emitter thread (idempotent).
        Results already dispatched reach their sinks first."""
        q, emitter, pool = self._emit_q, self._emitter, self._fetch_pool
        self._emit_q = self._emitter = self._fetch_pool = None
        if q is not None:
            q.put(None)
            emitter.join()
            pool.shutdown(wait=True)

    def _start_async(self, workers: int) -> None:
        self.async_fetch = int(workers)
        self._fetch_pool = ThreadPoolExecutor(max_workers=self.async_fetch)
        # bounded: push() backpressures instead of racing ahead of the
        # fetches; 4x the workers of slack
        self._emit_q = queue.Queue(maxsize=4 * self.async_fetch)
        self._emitter = threading.Thread(target=self._emit_loop, daemon=True)
        self._emitter.start()

    # -- the step -------------------------------------------------------

    def _sync_deframers(self) -> None:
        """One deframer a decoder VFO, kept while its mode stays."""
        old, self.deframers = self.deframers, {}
        for name, vfo in self.frontend.vfos.items():
            if vfo.decoder:
                self.deframers[name] = old.get(name) or DECODERS[
                    vfo.cfg.mode][1](device=self.device)

    def _step(self, state, block: np.ndarray):
        """One frontend call on the device; functional in ``state``."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(block)).to(self.device)
            return self.frontend(state, x)

    def _step_scan(self, state, blocks: np.ndarray):
        with torch.inference_mode():
            xs = torch.from_numpy(np.ascontiguousarray(blocks)).to(self.device)
            return self.frontend.scan_call(state, xs)

    def set_mode(self, name: str, mode: str,
                 bandwidth: float | None = None) -> float:
        """Switch a VFO's demodulator live; returns the switch latency (s).

        Builds (or takes from the cache) the VFO chain of the new mode
        and re-initialises that VFO's DSP state; ``bandwidth=None`` keeps
        the VFO's configured bandwidth.
        """
        t0 = time.perf_counter()
        fe = self.frontend
        if name not in fe.vfos:
            raise KeyError(name)
        with self._state_lock:
            if name in fe._grouped_names():
                raise NotImplementedError(
                    "demod switch on a fused-group VFO: rebuild the "
                    "Receiver (group plans are mode-rate-specific)")
            old = fe.vfos[name]
            offset = old.cfg.offset_hz
            new_bw = bandwidth if bandwidth is not None else old.cfg.bandwidth
            cache = self._mode_programs
            # remember the outgoing chain so switching back is cheap
            cache[(name, old.cfg.mode, old.cfg.bandwidth)] = old
            want = (name, mode, new_bw)
            new = cache.get(want)
            inner = self.block_len // fe.decimation
            if new is None:
                cfg = dataclasses.replace(old.cfg, mode=mode,
                                          bandwidth=new_bw)
                new = Vfo(cfg, fe.effective_samplerate, old.audio_rate,
                          emit_iq=old.emit_iq, device=self.device)
                assert inner % new.block_multiple() == 0, (
                    f"block_len {self.block_len} incompatible with mode "
                    f"{mode} (quantum {new.block_multiple()})")
                new.bind(inner)
                cache[want] = new
            cache.move_to_end(want)
            while len(cache) > self.MODE_CACHE_SIZE:
                cache.popitem(last=False)
            fe.vfos[name] = new
            if new.decoder or old.decoder:
                # a new stream: the deframer starts afresh
                self.deframers.pop(name, None)
                self._sync_deframers()
            vst = new.init_state()
            if abs(new.cfg.offset_hz - offset) > 1e-9:
                vst = new.retune_state(vst, offset)
            st = dict(self._state)
            st["vfos"] = {**st["vfos"], name: vst}
            self._state = st
            self._warmed = False
            # run the new VFO twice on zeros now (tables and FFT plans on
            # the first pass; on the card its chain's graph is captured
            # on the second), so the next push does not stall.  The
            # passes are functional and their results dropped; they hold
            # the lock, as a push does, since a push replays the same
            # graphs of the cached chains
            zeros = torch.zeros(inner, dtype=torch.complex64,
                                device=self.device)
            with torch.inference_mode():
                warm, _ = new(vst, zeros)
                new(warm, zeros)
        return time.perf_counter() - t0

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the full DSP state mid-stream: loop carries, filter
        tails and mixer phases, plus the framer remainder and any
        batch-queued blocks.  Resume is bit-exact for ``scan_batch=1``."""
        from ..graph.checkpoint import save_state

        with self._state_lock:
            # framed but undispatched batch blocks are unconsumed input:
            # they go back in FRONT of the framer remainder
            buf = (np.concatenate([*self._pending, self.framer._buf])
                   if self._pending else self.framer._buf)
            save_state(path, {"state": state_to_numpy(self._state),
                              "framer_buf": buf})

    def load_checkpoint(self, path: str) -> None:
        """Restore a `save_checkpoint` snapshot into this receiver."""
        from ..graph.checkpoint import load_state

        with self._state_lock:
            like = {"state": self._state, "framer_buf": self.framer._buf}
            data = load_state(path, like)
            self._state = state_from_jax(data["state"], self.device)
            buf = np.asarray(data["framer_buf"], np.complex64)
            # whole blocks in the snapshot (saved pending) go back to the
            # pending queue; push()/drain() dispatch them before new input
            nb = len(buf) // self.block_len
            self._pending = [buf[i * self.block_len:(i + 1) * self.block_len]
                             for i in range(nb)]
            self.framer._buf = buf[nb * self.block_len:]
            self._warmed = False

    def retune(self, name: str, offset_hz: float) -> None:
        """Live-retune one VFO by a state-table swap.  Thread-safe
        against concurrent dispatches."""
        with self._state_lock:
            self._state = self.frontend.retune(self._state, name, offset_hz)

    # -- result delivery ------------------------------------------------

    def _materialize(self, payload):
        baseband, audios, spec, batched, vf = payload
        audios = {k: _to_host(v) for k, v in audios.items()}
        spec = _to_host(spec) if spec is not None else None
        return baseband, audios, spec, batched, vf

    def _emit_loop(self) -> None:
        q = self._emit_q
        while True:
            fut = q.get()
            if fut is None:
                q.task_done()
                return
            try:
                self._emit(*fut.result())
            except Exception as e:  # noqa: BLE001
                # a failing sink must not kill the emitter, or the bounded
                # queue fills and push()/sync() block for ever; the first
                # error is kept and sync() raises it
                if self._emit_error is None:
                    self._emit_error = e
            finally:
                q.task_done()

    def _dispatch_emit(self, payload) -> None:
        if isinstance(self.async_fetch, int) and self.async_fetch > 0:
            if self._fetch_pool is None:
                self._start_async(self.async_fetch)
            self._emit_q.put(
                self._fetch_pool.submit(self._materialize, payload))
            return
        self._emit(*payload)

    def sync(self) -> None:
        """Block until every dispatched result has reached its sinks;
        raises the first sink or fetch error the emitter thread kept."""
        if self._emit_q is not None:
            self._emit_q.join()
        if self._emit_error is not None:
            err, self._emit_error = self._emit_error, None
            raise err

    def warmup(self) -> None:
        """Run the step ahead of live data and put the state back, so
        tables, FFT plans and kernels exist before the first `push`.

        Two steps: on the card each radio chain runs eagerly on the
        first and captures its graph on the second.  With
        ``async_fetch="auto"`` it then times a step with its whole
        payload (every audio leaf and the spectrum) fetched, median of 3,
        and sizes the pool as ``ceil(time / block interval) + 1`` within
        [2, 16]; with nothing to fetch it takes
        `AUTO_WORKERS_NOTHING_TO_FETCH`.
        """
        zeros = np.zeros(self.block_len, np.complex64)
        state0 = self._state
        st, _ = self._step(state0, zeros)
        self._step(st, zeros)
        if self.scan_batch > 1:
            self._step_scan(st, np.zeros((self.scan_batch, self.block_len),
                                         np.complex64))
        if self.async_fetch == "auto":
            laps = []
            fetched = 0
            st2 = st
            for _ in range(3):
                t0 = time.perf_counter()
                st2, (audios, spec) = self._step(st2, zeros)
                _, audios, spec, _, _ = self._materialize(
                    ([], audios, spec, False, 1.0))
                laps.append(time.perf_counter() - t0)
                fetched = len(audios) + (spec is not None)
            if fetched:
                interval = self.block_len / self.frontend.samplerate
                lap = sorted(laps)[len(laps) // 2]
                workers = min(16, max(2, int(np.ceil(lap / interval)) + 1))
            else:
                workers = self.AUTO_WORKERS_NOTHING_TO_FETCH
            self.async_fetch = workers
        self._state = state0

    # -- input ----------------------------------------------------------

    def push(self, iq: np.ndarray) -> None:
        """Feed host IQ samples; dispatches as blocks or batches fill.

        The state lock is held per BLOCK (frame-pop and step as one unit;
        sink emission outside), so control threads wait at most one
        dispatch even when a whole file arrives in one push()."""
        if self._thr is not None:
            self._thr.add(len(iq))
        restored = []
        with self._state_lock:
            self.framer.append(np.asarray(iq, np.complex64))
            if self.scan_batch <= 1 and self._pending:
                # checkpoint-restored blocks precede new input
                restored = self._drain_compute()
        for payload in restored:
            self._dispatch_emit(payload)
        while True:
            payload = None
            with self._state_lock:
                block = self.framer.pop_block()
                if block is None:
                    break
                if self.scan_batch <= 1:
                    payload = self._compute(block)
                else:
                    self._pending.append(block)
                    if not self._warmed:
                        # the first block goes through the single step,
                        # so the state takes its steady shapes before a
                        # batch (as the reference)
                        payload = self._compute(self._pending.pop(0))
                        self._warmed = True
                    elif len(self._pending) >= self.scan_batch:
                        batch = self._pending[: self.scan_batch]
                        self._pending = self._pending[self.scan_batch:]
                        payload = self._compute_batch(batch)
            if payload is not None:
                self._dispatch_emit(payload)

    def _drain_compute(self) -> list:
        """Step through all pending blocks (caller holds the lock);
        returns the `_emit` payloads so sinks run OUTSIDE it."""
        payloads = [self._compute(block) for block in self._pending]
        self._pending = []
        return payloads

    def drain(self) -> None:
        """Dispatch any buffered whole blocks (before flush/shutdown)."""
        with self._state_lock:
            payloads = self._drain_compute()
        for payload in payloads:
            self._dispatch_emit(payload)

    def _emit(self, baseband, audios, spec, batched: bool,
              valid_fraction: float = 1.0) -> None:
        # sinks run here, OUTSIDE the state lock: a blocked sink must
        # never freeze retune/save_checkpoint
        for sink in self.baseband_sinks:
            for b in baseband:
                sink(b)
        for name, deframer in self.deframers.items():
            if name in audios:
                self._deframe(name, deframer, audios[name], batched,
                              valid_fraction)
        for name, sink in self.audio_sinks.items():
            if name in audios:
                a = _to_host(audios[name])
                if batched:  # (K, ...) -> concatenate along time
                    a = np.concatenate(list(a), axis=-1)
                if valid_fraction < 1.0:
                    a = a[..., : int(round(a.shape[-1] * valid_fraction))]
                if self.metrics is not None:
                    self.metrics.gauge(f"audio.{name}.rms").set(
                        float(np.sqrt(np.mean(np.square(a)))))
                sink(a)
        if self.spectrum_sink is not None and spec is not None:
            s = _to_host(spec)
            if batched:
                s = s.reshape(-1, s.shape[-1])
            if valid_fraction < 1.0:
                s = s[: int(round(s.shape[0] * valid_fraction))]
            self.spectrum_sink(s)

    def _deframe(self, name, deframer, out, batched: bool,
                 valid_fraction: float) -> None:
        """A decoder VFO's valid symbols (each row's, in order) through its
        deframer, the frames to its sink."""
        syms, count = out
        rows = zip(syms, count) if batched else [(syms, count)]
        sink = self.frame_sinks.get(name)
        for s, n in rows:
            n = int(n)
            if valid_fraction < 1.0:
                n = int(round(n * valid_fraction))
            for frame in deframer.process(s[:n]):
                if sink is not None:
                    sink(frame)

    def _compute(self, block: np.ndarray, valid_fraction: float = 1.0):
        """One step (caller holds the state lock); returns the `_emit`
        payload so ALL sink fan-out runs outside the lock."""
        bb = (block if valid_fraction >= 1.0
              else block[: int(round(len(block) * valid_fraction))])
        self._state, (audios, spec) = self._step(self._state, block)
        return [bb], audios, spec, False, valid_fraction

    def _compute_batch(self, blocks: list[np.ndarray]):
        self._state, (audios, spec) = self._step_scan(self._state,
                                                      np.stack(blocks))
        return list(blocks), audios, spec, True, 1.0

    def flush(self) -> None:
        """Dispatch any pending partial block (stream tail), wait for the
        sinks and end the fetch threads.

        The tail block is zero-padded up to the block length, and sink
        output is trimmed back to the true input length."""
        payloads = []
        with self._state_lock:
            payloads += self._drain_compute()
            if self.framer.pending:
                frac = self.framer.pending / self.block_len
                pad = self.block_len - self.framer.pending
                for block in self.framer.push(np.zeros(pad, np.complex64)):
                    payloads.append(self._compute(block, valid_fraction=frac))
        for payload in payloads:
            self._dispatch_emit(payload)
        try:
            self.sync()
        finally:
            self.close()

    def run_file(self, path: str) -> None:
        """Process a whole IQ WAV recording."""
        from ..io import wav

        info, iq = wav.read_iq_wav(path)
        if abs(info.samplerate - self.frontend.samplerate) > 1:
            raise ValueError(f"file rate {info.samplerate} != receiver rate "
                             f"{self.frontend.samplerate}")
        self.push(iq)
        self.flush()
