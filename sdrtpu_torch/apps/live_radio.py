"""Live end-to-end radio: network IQ -> receiver on the card -> speakers
(the port's counterpart of ``examples/live_radio.py``).

    TCP IQ ingest (`io.net.NetworkSource`: the native C++ pump + ring)
      -> `apps.receiver.Receiver` (the front end and the VFO chains on
         the device)
        -> `io.audio_sink.AudioSink` (512-frame packets to sounddevice,
           ALSA, or the real-time-paced headless backend), each sink
           played out on its own thread (`PlayoutSink`)

Run against any i16 IQ stream:

    python -m sdrtpu_torch.apps.live_radio --port 5000 --rate 1000000 \\
        --offset 250000 --mode wfm

With ``--selftest N`` it feeds itself a synthesized WFM station (one
second of it, replayed) for N seconds from a transmitter process, paced
to real time over a loopback socket, and reports the sustained
real-time factor, the send-to-audio latency and the audio pacing.
``--device cpu`` runs the same port on the CPU.  The pieces
(`Transmitter`, `PlayoutSink`, `stream`) are what a test or a larger
deployment composes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing as mp
import queue
import socket
import sys
import threading
import time
from typing import Callable

import numpy as np

from ..io.audio_sink import AudioSink
from ..io.net import IqExporter, NetworkSource, iq_to_bytes, sample_bytes
from .receiver import IQFrontend, Receiver, VfoConfig


def make_station(fs: float, offset: float, n: int) -> np.ndarray:
    """A synthesized stereo WFM station at ``offset`` Hz (pilot + L-R:
    440 Hz left, 1200 Hz right).  Every tone is a whole number of Hz, so
    one second of it (at a whole-Hz ``offset``) replays without a seam."""
    t = np.arange(n) / fs
    left = np.sin(2 * np.pi * 440.0 * t)
    right = np.sin(2 * np.pi * 1200.0 * t)
    mpx = (0.45 * (left + right) / 2 + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * ((left - right) / 2) * np.sin(2 * np.pi * 38000.0 * t))
    phase = np.cumsum(2 * np.pi * 75000.0 * mpx / fs)
    return (0.6 * np.exp(1j * (2 * np.pi * offset * t + phase))).astype(
        np.complex64)


def _transmit(wire, chunk_bytes, n_chunks, fs, chunk_samples, window,
              connect, header, consumed, port, ready, done, log_q):
    """`Transmitter`'s process: connect (or serve one connection), then
    send the chunks and put the send log on ``log_q``."""
    if connect is not None:
        exp = IqExporter("tcp-client", *connect)
        send = exp.send_bytes
    else:
        lsock = socket.create_server(("127.0.0.1", 0))
        lsock.settimeout(60.0)
        port.value = lsock.getsockname()[1]
        ready.set()
        conn, _ = lsock.accept()
        lsock.close()
        conn.settimeout(60.0)
        conn.sendall(header)
        send = conn.sendall
    view = memoryview(wire)
    per_wire = len(wire) // chunk_bytes
    log, sent = [], 0
    start = time.monotonic()
    for k in range(n_chunks):
        if window is None:
            wait = start + sent / fs - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        else:
            while sent - consumed.value > window:
                time.sleep(0.0005)
        j = k % per_wire
        send(view[j * chunk_bytes:(j + 1) * chunk_bytes])
        sent += chunk_samples
        log.append((sent, time.monotonic()))
    if connect is not None:
        exp.close()
    else:
        # the client's commands are read before the close, so the close
        # is not a reset that could cost the client unread samples
        conn.setblocking(False)
        with contextlib.suppress(BlockingIOError):
            while conn.recv(4096):
                pass
        conn.close()
    done.set()
    log_q.put(log)


class Transmitter:
    """The loopback transmitter, in a process of its own as a network
    source is (a pacing thread in the receiver's interpreter waits for
    its lock, then sends its backlog in a burst the pump's ring may not
    hold).  It replays ``wire`` (interleaved ``fmt`` IQ, a whole number
    of chunks) in ``n_chunks`` chunks of ``chunk_samples`` samples,
    paced to real time at ``fs``; with ``window``, as fast as the
    receiver takes them instead: at most ``window`` samples ahead of
    ``consumed.value``, which the receiving side advances.

    ``connect=(host, port)`` sends through `IqExporter("tcp-client")`;
    ``connect=None`` serves one connection on a loopback ``port`` (known
    once `start` returns), sending ``header`` first, as an rtl_tcp
    server does.  ``done`` is set after the last chunk.  After `join`,
    ``log`` holds ``(samples sent so far, time.monotonic() after the
    send)`` per chunk: the host's monotonic clock is common to its
    processes.
    """

    def __init__(self, wire: bytes, chunk_samples: int, n_chunks: int,
                 fs: float, fmt: str = "i16",
                 connect: tuple[str, int] | None = None,
                 header: bytes = b"", window: int | None = None):
        ctx = mp.get_context("spawn")
        self.chunk_samples, self.n_chunks = int(chunk_samples), int(n_chunks)
        chunk_bytes = self.chunk_samples * sample_bytes(fmt)
        if not wire or len(wire) % chunk_bytes:
            raise ValueError("wire must hold a whole number of chunks")
        self.consumed = ctx.Value("q", 0)
        self.done = ctx.Event()
        self.log: list[tuple[int, float]] = []
        self._port = ctx.Value("i", 0)
        self._ready = ctx.Event()
        self._serve = connect is None
        self._q = ctx.Queue()
        self._proc = ctx.Process(target=_transmit, daemon=True, args=(
            wire, chunk_bytes, self.n_chunks, float(fs), self.chunk_samples,
            window, connect, header, self.consumed, self._port, self._ready,
            self.done, self._q))

    @property
    def total_samples(self) -> int:
        return self.chunk_samples * self.n_chunks

    @property
    def port(self) -> int:
        return self._port.value

    def start(self, timeout: float = 60.0) -> "Transmitter":
        self._proc.start()
        if self._serve and not self._ready.wait(timeout):
            self._proc.terminate()
            raise TimeoutError("the transmitter did not start serving")
        return self

    def join(self, timeout: float) -> None:
        # the queue is read before the join: a process that put on a
        # queue ends only once it is drained
        try:
            self.log = self._q.get(timeout=timeout)
        finally:
            self._proc.join(timeout)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(5.0)
        if self._proc.exitcode != 0:
            raise RuntimeError(f"transmitter exited {self._proc.exitcode}")

    def sent_time(self, sample: int) -> float:
        """Host time the chunk holding stream sample ``sample`` was sent."""
        k = min(sample // self.chunk_samples, len(self.log) - 1)
        return self.log[k][1]


class PlayoutSink:
    """An audio sink played out on a thread of its own, as each sound
    card's callback thread plays its stream: the receiver's call only
    queues the block, so one paced sink never holds up another sink or
    the receiver.  ``arrivals`` holds the `time.monotonic` of each call;
    `close` plays what is queued, closes the sink and ends the thread."""

    def __init__(self, sink: AudioSink):
        self.sink = sink
        self.arrivals: list[float] = []
        self.error: BaseException | None = None
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def __call__(self, audio: np.ndarray) -> None:
        self.arrivals.append(time.monotonic())
        self._q.put(audio)

    def _run(self):
        while True:
            audio = self._q.get()
            if audio is None:
                return
            try:
                self.sink(audio)
            except Exception as e:  # noqa: BLE001 - reported by close()
                if self.error is None:
                    self.error = e

    def close(self, timeout: float = 30.0) -> None:
        self._q.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("the playout thread did not finish")
        self.sink.close()
        if self.error is not None:
            raise self.error


def stream(src: NetworkSource, rx: Receiver, total_samples: int,
           timeout_s: float,
           on_push: Callable[[int], None] | None = None) -> dict:
    """Read ``src`` and push into ``rx`` until ``total_samples`` have been
    pushed or ``timeout_s`` passed since the first sample (or, while none
    came, since the call); then flush.

    ``on_push(pushed)`` runs after every push.  Returns ``pushed``, the
    `time.monotonic` of the first read (``t_first``) and of the end of
    the flush (``t_end``), and ``push_s``, the time spent inside `push`.
    """
    pushed, push_s = 0, 0.0
    t_first = None
    t_call = time.monotonic()
    while pushed < total_samples:
        if time.monotonic() - (t_first or t_call) > timeout_s:
            break
        iq = src.read(timeout=0.5)
        if iq is None:
            continue
        if t_first is None:
            t_first = time.monotonic()
        t0 = time.monotonic()
        rx.push(iq)
        push_s += time.monotonic() - t0
        pushed += len(iq)
        if on_push is not None:
            on_push(pushed)
    rx.flush()
    return {"pushed": pushed, "t_first": t_first, "t_end": time.monotonic(),
            "push_s": push_s}


def latencies(sender: Transmitter, arrivals: list[float],
              block_len: int) -> np.ndarray:
    """Send-to-audio latency of each block (s): the arrival of its audio
    at the sink less the send of the chunk holding its last sample."""
    return np.array([t - sender.sent_time((k + 1) * block_len - 1)
                     for k, t in enumerate(arrivals)
                     if (k + 1) * block_len <= sender.total_samples])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrtpu_torch.apps.live_radio",
                                 description=__doc__)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--rate", type=float, default=1_000_000.0)
    ap.add_argument("--offset", type=float, default=250_000.0)
    ap.add_argument("--mode", default="wfm")
    ap.add_argument("--squelch", type=float, default=None)
    ap.add_argument("--selftest", type=float, default=0.0,
                    help="feed a synthetic station for N seconds")
    ap.add_argument("--block-ms", type=float, default=0.0,
                    help="the dispatch block (ms of signal); 0 = the "
                         "Receiver's default (~250k samples)")
    ap.add_argument("--json", default=None,
                    help="write the session record to this path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    src = NetworkSource("tcp", "127.0.0.1" if args.selftest else "0.0.0.0",
                        args.port)
    print(f"listening for i16 IQ on tcp port {src.port}", flush=True)
    fe = IQFrontend(args.rate,
                    {"v0": VfoConfig(args.offset, args.mode,
                                     squelch_db=args.squelch, stereo=True)},
                    spectrum=False, device=args.device)
    block_len = None
    if args.block_ms:
        m = fe.block_multiple()
        block_len = max(1, round(args.rate * args.block_ms / 1e3 / m)) * m
    sink = PlayoutSink(AudioSink(48000.0, latency_packets=4))
    rx = Receiver(fe, block_len=block_len, audio_sinks={"v0": sink})
    t0 = time.monotonic()
    rx.warmup()
    print(f"receiver warmed up in {time.monotonic() - t0:.1f} s (block "
          f"{rx.block_len} = {rx.block_len / args.rate * 1e3:.1f} ms)",
          flush=True)

    sender = None
    if args.selftest:
        chunk = int(args.rate / 50)  # 20 ms sends
        wire = iq_to_bytes(make_station(args.rate, args.offset, 50 * chunk))
        sender = Transmitter(wire, chunk, int(np.ceil(args.selftest * 50)),
                             args.rate, connect=("127.0.0.1", src.port)
                             ).start()
        total = sender.total_samples
        timeout = args.selftest + 30.0
    else:
        total, timeout = float("inf"), float("inf")
    try:
        run = stream(src, rx, total, timeout)
    except KeyboardInterrupt:
        rx.flush()
        run = None
    sink.close()
    src.close()
    if sender is not None:
        sender.join(10.0)
    if run is None or run["t_first"] is None:
        return 0
    elapsed = run["t_end"] - run["t_first"]
    rtf = run["pushed"] / args.rate / max(elapsed, 1e-9)
    be = sink.sink.backend
    rec = {"rate": args.rate, "block_len": rx.block_len,
           "samples": run["pushed"], "wall_s": elapsed,
           "rtf_sustained": rtf, "push_busy_share": run["push_s"] / elapsed,
           "audio_packets": sink.sink.packets,
           "underruns": getattr(be, "underruns", None),
           "readers": src.readers, "dropped_bytes": src.dropped_bytes}
    if sender is not None:
        lat = latencies(sender, sink.arrivals, rx.block_len)
        rec["latency_s_median"] = float(np.median(lat))
        rec["latency_s_p95"] = float(np.percentile(lat, 95))
    print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    if args.selftest:
        max_under = max(2, int(0.005 * max(sink.sink.packets, 1)))
        ok = (rtf > 0.95 and rec["underruns"] <= max_under
              and run["pushed"] == sender.total_samples
              and src.readers == ["native"] and rec["dropped_bytes"] == 0)
        print("SELFTEST", "OK" if ok else "FAILED", flush=True)
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
