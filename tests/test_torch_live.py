"""The live path as a whole on the CPU, at a small rate: the port's
live_radio loopback (a `Transmitter` process's `IqExporter` ->
`NetworkSource` through the native pump -> `Receiver` -> an `AudioSink`
on its own playout thread), 1 Msps, one stereo WFM VFO, 1 s paced to
real time.

Every sample sent is received, by the native reader, with nothing
dropped; the port's audio equals the JAX package's `Receiver` run on
the same received samples within 2e-4 of the peak (at least of 1.0;
tests/test_torch_receiver.py's tolerance); the sink got every block.
Every socket, read and join has its own timeout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import receiver as jrx  # noqa: E402
from sdrtpu_torch import native as tn  # noqa: E402
from sdrtpu_torch.apps import live_radio as live  # noqa: E402
from sdrtpu_torch.apps import receiver as trx  # noqa: E402
from sdrtpu_torch.io.audio_sink import AudioSink, PacedNullBackend  # noqa: E402
from sdrtpu_torch.io.net import NetworkSource, iq_to_bytes  # noqa: E402

FS = 1_000_000.0
OFFSET = 250_000.0
SECONDS = 1.0
REL = 2e-4


def test_loopback_receiver_against_the_reference():
    if tn.get_lib() is None:
        pytest.skip("no C++ toolchain here for the native pump")
    src = NetworkSource("tcp", "127.0.0.1", 0)
    fe = trx.IQFrontend(FS, {"v0": trx.VfoConfig(OFFSET, "wfm")},
                        spectrum=False, device="cpu")
    sink = live.PlayoutSink(AudioSink(48000.0,
                                      backend=PacedNullBackend(48000.0)))
    audio, blocks = [], []

    def on_audio(a):
        audio.append(a)
        sink(a)

    rx = trx.Receiver(fe, audio_sinks={"v0": on_audio},
                      baseband_sinks=[lambda b: blocks.append(np.array(b))])
    rx.warmup()
    chunk = int(FS / 50)
    wire = iq_to_bytes(live.make_station(FS, OFFSET, int(SECONDS * 50) * chunk))
    sender = live.Transmitter(wire, chunk, int(SECONDS * 50), FS,
                              connect=("127.0.0.1", src.port)).start()
    run = live.stream(src, rx, sender.total_samples, timeout_s=60.0)
    sender.join(30.0)
    sink.close(timeout=30.0)
    src.close(timeout=5.0)
    assert not src._thread.is_alive()
    assert run["pushed"] == sender.total_samples
    assert src.readers == ["native"] and src.dropped_bytes == 0
    assert len(audio) == len(sink.arrivals) == -(-run["pushed"]
                                                // rx.block_len)
    assert len(live.latencies(sender, sink.arrivals, rx.block_len)) == (
        run["pushed"] // rx.block_len)

    # the JAX package's receiver on the samples the port received
    received = np.concatenate(blocks)[:run["pushed"]]
    jfe = jrx.IQFrontend(FS, {"v0": jrx.VfoConfig(OFFSET, "wfm")},
                         spectrum=False)
    jaudio = []
    jr = jrx.Receiver(jfe, block_len=rx.block_len,
                      audio_sinks={"v0": jaudio.append})
    jr.push(received)
    jr.flush()
    got = np.concatenate(audio, axis=-1)
    want = np.concatenate(jaudio, axis=-1)
    assert got.shape == want.shape
    tol = REL * max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol
    # the station's left tone came through
    left = got[0, got.shape[-1] // 2:]
    spec = np.abs(np.fft.rfft(left * np.hanning(len(left))))
    peak = np.fft.rfftfreq(len(left), 1 / 48000.0)[np.argmax(spec)]
    assert abs(peak - 440.0) < 10.0
