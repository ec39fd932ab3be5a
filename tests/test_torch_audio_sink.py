"""sdrtpu_torch's audio sink against sdrtpu's (a host copy): the same
packets from the same audio (numpy or a tensor), the same pacing and
underrun counts on a virtual clock (tests/test_audio_sink.py:14's), and
a one-hour simulated soak of 0.1 s Receiver-style blocks with no drift
and no underrun."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.io import audio_sink as ja  # noqa: E402
from sdrtpu_torch.io import audio_sink as ta  # noqa: E402


class VirtualClock:
    """Injectable clock: sleep() advances time instantly."""

    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, dt):
        assert dt >= 0
        self.t += dt

    def advance(self, dt):
        self.t += dt


def test_packer_packets_equal():
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((2, n)).astype(np.float32)
              for n in (1300, 77, 512, 2000)] + [np.ones(700, np.float32)]
    jp, tp = ja.Packer(), ta.Packer()
    for b in blocks:
        want = list(jp.push(b))
        got = list(tp.push(torch.as_tensor(b)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert tp.pending == jp.pending
    np.testing.assert_array_equal(tp.flush(), jp.flush())
    assert tp.flush() is None and jp.flush() is None


def _drive(mod, arrivals, latency_packets=4):
    """Packets written at the virtual times ``arrivals`` (None: as fast
    as the backend takes them); returns the backend's counters."""
    vc = VirtualClock()
    be = mod.PacedNullBackend(48000.0, clock=vc.clock, sleep=vc.sleep,
                              latency_packets=latency_packets)
    pkt = np.zeros((2, ta.PACKET_FRAMES), np.float32)
    for t in arrivals:
        if t is not None and t > vc.t:
            vc.t = t
        be.write(pkt)
    return vc.t, be.frames_written, be.underruns


def test_pacing_and_underruns_equal():
    dt = ta.PACKET_FRAMES / 48000.0
    rng = np.random.default_rng(1)
    cases = [[None] * 200,                       # fast producer
             [k * 2 * dt for k in range(40)],    # 2x slower than real time
             list(np.cumsum(rng.uniform(0, 3 * dt, 300)))]  # jittery
    for arrivals in cases:
        assert _drive(ta, arrivals) == _drive(ja, arrivals)
    assert _drive(ta, cases[0])[2] == 0
    assert _drive(ta, cases[1])[2] > 0


def test_one_hour_simulated_soak():
    vc = VirtualClock()
    fs = 48000.0
    be = ta.PacedNullBackend(fs, clock=vc.clock, sleep=vc.sleep)
    sink = ta.AudioSink(fs, backend=be, volume=0.5, latency_packets=6)
    assert be.latency == 6 * ta.PACKET_FRAMES / fs
    block = np.zeros((2, 4800), np.float32)  # 0.1 s a push
    n_blocks = 36000  # one hour
    for _ in range(n_blocks):
        sink(block)
    total = n_blocks * 4800
    assert be.frames_written == (total // ta.PACKET_FRAMES) * ta.PACKET_FRAMES
    assert abs(vc.t - (be.frames_written - ta.PACKET_FRAMES) / fs) < 1e-6
    assert be.underruns == 0
    sink.close()
    assert be.frames_written == -(-total // ta.PACKET_FRAMES) * ta.PACKET_FRAMES
    assert sink.packets == -(-total // ta.PACKET_FRAMES)


def test_best_backend_and_volume():
    be = ta.best_backend(48000.0, prefer="null")
    assert isinstance(be, ta.PacedNullBackend)
    got = []

    class Capture:
        def write(self, p):
            got.append(p)

        def close(self):
            pass

    sink = ta.AudioSink(48000.0, backend=Capture(), volume=0.5)
    sink(np.ones((2, 600), np.float32))
    sink.close()
    assert len(got) == 2 and np.all(got[0] == 0.5)
    assert np.all(got[1][:, :88] == 0.5) and not got[1][:, 88:].any()
