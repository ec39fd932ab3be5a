"""Structured runtime metrics (host copy of ``sdrtpu/metrics.py``).

The registry is plain Python; `apps.receiver.Receiver` feeds it as the
reference does.

The reference has no metrics beyond the ``flog`` text log and visual
widgets (SNR meter ``waterfall.cpp:922-932``, volume/peak meters,
``SpeedTester``).  Here observability is first-class and structured:
counters (samples/blocks per stage), gauges (SNR, lock state, audio
level), and throughput trackers (Msamples/s + real-time factor against a
declared sample rate), all snapshottable as one JSON-friendly dict.

Typical wiring::

    m = MetricsRegistry()
    thr = m.throughput("frontend", samplerate=10e6)
    ...
    thr.add(block_len)                    # per dispatched block
    m.gauge("vfo0.snr_db").set(snr)
    print(m.to_json())

`span` marks a layer of the program as a host range on the profiler's
clock, for a trace taken with ``torch.profiler``; with no profiler
recording it costs one flag check.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

from torch.autograd import profiler as _autograd_profiler


@dataclass
class Counter:
    value: int = 0

    def add(self, n: int = 1) -> None:
        self.value += int(n)


@dataclass
class Gauge:
    value: float = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclass
class Throughput:
    """Samples/s over the registry's lifetime plus a recent-window rate.

    The first ``add``'s samples arrived over an unknown interval that
    precedes the first timestamp, so the lifetime average excludes them
    (counting them would overestimate the rate — 2x after two adds).
    ``window_rate`` is the rate over the last COMPLETED window (~2 s):
    it recovers after pauses where the blended lifetime average would
    stay stale forever.
    """

    samplerate: float | None = None
    clock: callable = time.monotonic
    total: int = 0
    _t0: float | None = None
    _t_last: float | None = None
    _first_n: int = 0
    _win_samples: int = 0
    _win_t0: float | None = None
    _win_rate: float | None = None
    window: float = 2.0

    def add(self, n: int) -> None:
        now = self.clock()
        if self._t0 is None:
            self._t0 = self._win_t0 = now
            self._first_n = int(n)
        self.total += int(n)
        self._win_samples += int(n)
        self._t_last = now
        if now - self._win_t0 > self.window:
            self._win_rate = self._win_samples / (now - self._win_t0)
            self._win_samples = 0
            self._win_t0 = now

    @property
    def rate(self) -> float:
        """Average samples/s since the first add (its samples excluded)."""
        if self._t0 is None or self._t_last is None or self._t_last == self._t0:
            return 0.0
        return (self.total - self._first_n) / (self._t_last - self._t0)

    @property
    def window_rate(self) -> float | None:
        """Rate over the last completed ~`window`-second span, or None."""
        return self._win_rate

    @property
    def realtime_factor(self) -> float | None:
        """rate / declared samplerate (>1 means faster than real time).

        Uses the recent window when one has completed (recovers after
        stream pauses); ``None`` when no samplerate was declared."""
        if not self.samplerate:
            return None
        r = self._win_rate if self._win_rate is not None else self.rate
        return r / self.samplerate if r else 0.0

    def snapshot(self) -> dict:
        return {
            "total_samples": self.total,
            "rate_sps": self.rate,
            "window_rate_sps": self._win_rate,
            "realtime_factor": self.realtime_factor,
        }


@dataclass
class MetricsRegistry:
    counters: dict[str, Counter] = field(default_factory=dict)
    gauges: dict[str, Gauge] = field(default_factory=dict)
    throughputs: dict[str, Throughput] = field(default_factory=dict)

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def throughput(self, name: str, samplerate: float | None = None,
                   clock=time.monotonic) -> Throughput:
        t = self.throughputs.get(name)
        if t is None:
            t = self.throughputs[name] = Throughput(samplerate, clock)
        elif samplerate is not None:
            t.samplerate = samplerate
        return t

    def snapshot(self) -> dict:
        def finite(v):
            # unset gauges are NaN; JSON has no NaN token (RFC 8259) —
            # emit null so non-Python consumers can parse the snapshot
            return None if isinstance(v, float) and v != v else v

        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: finite(g.value) for k, g in self.gauges.items()},
            "throughput": {k: t.snapshot() for k, t in self.throughputs.items()},
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), allow_nan=False)


_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A host range ``name`` around the ``with`` block while a
    ``torch.profiler`` profile records (``record_function``; ``args``,
    made a string, is its argument, such as the id of the call that the
    spans share), nested by time in the range around it on its thread.
    Otherwise one shared no-op: no allocation and no dispatcher call,
    since ``record_function`` costs several microseconds a use even with
    no profiler recording."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _autograd_profiler.record_function(
        name, None if args is None else str(args))
