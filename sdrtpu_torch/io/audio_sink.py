"""Real-time audio playout sink (PyTorch counterpart of
``sdrtpu/io/audio_sink.py``; ``sink_modules/audio_sink`` capability; host
code: it takes the host audio that `apps.receiver.Receiver` hands its
sinks, or a tensor on any device).

The reference's primary output path is an RtAudio callback fed by a
``Packer(512)`` (``sink_modules/audio_sink/src/main.cpp:25-250``: 48 kHz
stereo f32, 512-frame packets).  This is the host-side equivalent:

- `Packer` — accumulate arbitrary (2, n) audio blocks into fixed
  512-frame packets, carrying the remainder (``dsp/buffer/packer.h``).
- `AudioSink` — a push sink (`Receiver` audio_sinks-compatible callable)
  that packs and hands packets to a pluggable backend:

  * `SounddeviceBackend` — PortAudio via the ``sounddevice`` module when
    installed (the reference's RtAudio analog); opened with
    blocksize=512.
  * `AlsaBackend` — direct libasound via ctypes when the shared library
    exists (no extra Python deps).
  * `PacedNullBackend` — no hardware: consumes packets at exactly the
    sample-rate pace (monotonic-clock budget, no cumulative drift) and
    counts late packets; keeps live pipelines honestly real-time in
    headless/CI environments and is the soak-test backend.

Backend selection is automatic (`best_backend`); everything degrades
gracefully — importing this module never requires an audio stack.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import time

import numpy as np

from ..convert import to_numpy

PACKET_FRAMES = 512  # the reference's packer size (audio_sink main.cpp:31)


class Packer:
    """Fixed-size packet accumulator (``dsp/buffer/packer.h``)."""

    def __init__(self, frames: int = PACKET_FRAMES, channels: int = 2):
        self.frames = int(frames)
        self.channels = int(channels)
        self._buf = np.zeros((channels, 0), np.float32)

    def push(self, block: np.ndarray):
        """block: (channels, n) or (n,) mono -> yields (channels, frames)."""
        block = np.asarray(to_numpy(block), np.float32)
        if block.ndim == 1:
            block = np.broadcast_to(block, (self.channels, block.shape[0]))
        self._buf = np.concatenate([self._buf, block], axis=1)
        while self._buf.shape[1] >= self.frames:
            out = self._buf[:, : self.frames]
            self._buf = self._buf[:, self.frames:]
            yield out

    @property
    def pending(self) -> int:
        return self._buf.shape[1]

    def flush(self) -> np.ndarray | None:
        """Zero-pad and return the final partial packet (or None)."""
        n = self._buf.shape[1]
        if n == 0:
            return None
        out = np.zeros((self.channels, self.frames), np.float32)
        out[:, :n] = self._buf
        self._buf = np.zeros((self.channels, 0), np.float32)
        return out


class SounddeviceBackend:
    """PortAudio playout via the ``sounddevice`` package."""

    def __init__(self, samplerate: float, channels: int = 2,
                 device=None):
        import sounddevice as sd  # raises ImportError when unavailable

        self._stream = sd.OutputStream(
            samplerate=samplerate, channels=channels, dtype="float32",
            blocksize=PACKET_FRAMES, device=device,
        )
        self._stream.start()

    def write(self, packet: np.ndarray) -> None:
        self._stream.write(np.ascontiguousarray(packet.T))

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()


class AlsaBackend:
    """Direct ALSA PCM playout through libasound (ctypes, no deps)."""

    def __init__(self, samplerate: float, channels: int = 2,
                 device: str = "default"):
        name = ctypes.util.find_library("asound")
        if not name:
            raise OSError("libasound not found")
        a = ctypes.CDLL(name)
        self._a = a
        self._pcm = ctypes.c_void_p()
        # stream=0 (SND_PCM_STREAM_PLAYBACK), mode=0 (blocking)
        if a.snd_pcm_open(ctypes.byref(self._pcm), device.encode(), 0, 0) < 0:
            raise OSError(f"snd_pcm_open({device}) failed")
        # SND_PCM_FORMAT_FLOAT_LE=14, SND_PCM_ACCESS_RW_INTERLEAVED=3
        rc = a.snd_pcm_set_params(
            self._pcm, 14, 3, channels, int(samplerate), 1,
            int(1e6 * 4 * PACKET_FRAMES / samplerate),
        )
        if rc < 0:
            a.snd_pcm_close(self._pcm)
            raise OSError("snd_pcm_set_params failed")
        self.channels = channels

    def write(self, packet: np.ndarray) -> None:
        data = np.ascontiguousarray(packet.T, np.float32)  # interleaved
        frames = data.shape[0]
        rc = self._a.snd_pcm_writei(
            self._pcm, data.ctypes.data_as(ctypes.c_void_p), frames
        )
        if rc < 0:
            self._a.snd_pcm_recover(self._pcm, rc, 1)
            self._a.snd_pcm_writei(
                self._pcm, data.ctypes.data_as(ctypes.c_void_p), frames
            )

    def close(self) -> None:
        self._a.snd_pcm_drain(self._pcm)
        self._a.snd_pcm_close(self._pcm)


class PacedNullBackend:
    """Headless playout: real-time pacing against a monotonic budget.

    ``write`` sleeps until the packet's scheduled play time (start +
    frames_written/rate), so a producer faster than real time is held to
    the audio clock exactly like a hardware sink, with zero cumulative
    drift.  Packets arriving late (producer slower than real time) are
    counted as underruns.  ``clock``/``sleep`` are injectable for soak
    tests on a virtual clock.
    """

    def __init__(self, samplerate: float, channels: int = 2,
                 clock=time.monotonic, sleep=time.sleep,
                 latency_packets: int = 4):
        self.samplerate = float(samplerate)
        self.channels = channels
        self._clock = clock
        self._sleep = sleep
        self._start = None
        self.frames_written = 0
        self.underruns = 0
        # playout buffer model: hardware sinks absorb this much producer
        # jitter (the reference's RtAudio stream buffers likewise); a
        # packet is an underrun only when it misses due time by more
        self.latency = latency_packets * PACKET_FRAMES / self.samplerate

    def write(self, packet: np.ndarray) -> None:
        now = self._clock()
        if self._start is None:
            self._start = now
        due = self._start + self.frames_written / self.samplerate
        if due > now:
            self._sleep(due - now)
        elif now - due > self.latency:
            # one underrun event per stall: a hardware sink would play
            # silence for the gap and resume — re-anchor the playout
            # timeline so a single hiccup doesn't mark every subsequent
            # packet late forever
            self.underruns += 1
            self._start += now - due
        self.frames_written += packet.shape[1]

    def close(self) -> None:
        pass


def best_backend(samplerate: float, channels: int = 2, prefer: str | None = None):
    """Pick the best available playout backend (sounddevice > ALSA > paced).

    ``prefer``: force "sounddevice" | "alsa" | "null" (raises if that
    backend is unavailable).
    """
    order = [prefer] if prefer else ["sounddevice", "alsa", "null"]
    last_err = None
    for kind in order:
        try:
            if kind == "sounddevice":
                return SounddeviceBackend(samplerate, channels)
            if kind == "alsa":
                return AlsaBackend(samplerate, channels)
            if kind == "null":
                return PacedNullBackend(samplerate, channels)
        except Exception as e:  # noqa: BLE001 - fall through the chain
            last_err = e
    raise OSError(f"no audio backend available: {last_err}")


class AudioSink:
    """Push-style live audio sink: pack to 512-frame packets -> backend.

    Usable directly as a `Receiver` audio sink::

        sink = AudioSink(48000)
        rx = Receiver(fe, audio_sinks={"v0": sink})
        ...
        sink.close()
    """

    def __init__(self, samplerate: float, channels: int = 2,
                 backend=None, volume: float = 1.0,
                 latency_packets: int | None = None):
        self.packer = Packer(PACKET_FRAMES, channels)
        self.backend = backend if backend is not None else best_backend(
            samplerate, channels
        )
        # jitter-buffer depth: remote-tunneled devices deliver audio
        # ~2x RTT late with multi-ms jitter — size the playout buffer to
        # the transport (live_radio sets ~150 ms for tunnel sessions)
        if latency_packets is not None and hasattr(self.backend, "latency"):
            self.backend.latency = latency_packets * PACKET_FRAMES / float(samplerate)
        self.volume = float(volume)
        self.packets = 0

    def __call__(self, audio: np.ndarray) -> None:
        for packet in self.packer.push(audio):
            if self.volume != 1.0:
                packet = packet * np.float32(self.volume)
            self.backend.write(packet)
            self.packets += 1

    def close(self) -> None:
        tail = self.packer.flush()
        if tail is not None:
            if self.volume != 1.0:  # same scaling as the full packets
                tail = tail * np.float32(self.volume)
            self.backend.write(tail)
            self.packets += 1
        self.backend.close()
