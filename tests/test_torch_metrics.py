"""sdrtpu_torch's metrics (a host copy of ``sdrtpu/metrics.py``) and
their wiring into `Receiver(metrics=)`, against the reference's.

Tolerances: the registry's own numbers (counters, gauges, throughput on a
stepped clock) are equal; the receiver's input count is equal; each
sink's RMS gauge within 2e-4 of the reference's, relative (the audio's
own tolerance in `tests/test_torch_receiver.py`).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu import metrics as jm  # noqa: E402
from sdrtpu.apps import receiver as jrx  # noqa: E402
from sdrtpu_torch import metrics as tm  # noqa: E402
from sdrtpu_torch.apps import receiver as trx  # noqa: E402


class _Clock:
    def __init__(self, steps):
        self.t = iter(steps)

    def __call__(self):
        return next(self.t)


@pytest.mark.parametrize("times,adds", [
    ([0.0, 0.5, 1.0, 3.5], [100, 200, 300, 400]),
    ([10.0, 10.0], [5, 5]),
    ([0.0, 1.0, 2.5, 2.6, 5.0, 7.5], [1000] * 6),
])
def test_registry_matches_reference(times, adds):
    snaps = []
    for mod in (jm, tm):
        reg = mod.MetricsRegistry()
        thr = reg.throughput("frontend", samplerate=1000.0,
                             clock=_Clock(times))
        for n in adds:
            thr.add(n)
        reg.counter("blocks").add(len(adds))
        reg.gauge("snr_db").set(12.5)
        reg.gauge("unset")
        snaps.append(reg.to_json())
    assert snaps[0] == snaps[1]
    assert json.loads(snaps[1])["gauges"]["unset"] is None


def _capture(fs, n):
    rng = np.random.default_rng(4)
    t = np.arange(n) / fs
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = x + 0.1 * np.exp(1j * np.cumsum(
        2 * np.pi * 2500.0 * np.sin(2 * np.pi * 700.0 * t) / fs)
        + 2j * np.pi * 50e3 * t)
    x = x + 0.05 * (1 + 0.5 * np.sin(2 * np.pi * 400.0 * t)) * np.exp(
        -2j * np.pi * 120e3 * t)
    return x.astype(np.complex64)


def test_receiver_records_throughput_and_rms_gauges():
    fs = 1_000_000.0
    spec = {"n": (50e3, "nfm"), "a": (-120e3, "am")}
    regs, audio = {}, {}
    for name, mod, kw in (("ref", jrx, {}), ("port", trx, {"device": "cpu"})):
        cfgs = {k: mod.VfoConfig(o, m) for k, (o, m) in spec.items()}
        fe = mod.IQFrontend(fs, cfgs, **kw)
        reg = (jm if mod is jrx else tm).MetricsRegistry()
        bufs = {k: [] for k in spec}
        rx = mod.Receiver(fe, block_len=fe.block_multiple() * 2,
                          audio_sinks={k: bufs[k].append for k in spec},
                          metrics=reg)
        x = _capture(fs, 5 * fe.block_multiple() + 1000)
        rx.push(x[:3 * fe.block_multiple()])
        rx.push(x[3 * fe.block_multiple():])
        rx.flush()
        regs[name], audio[name] = reg, bufs
    ref, port = regs["ref"].snapshot(), regs["port"].snapshot()
    assert set(port["throughput"]) == set(ref["throughput"]) == {
        "receiver.input"}
    tp, tr = port["throughput"]["receiver.input"], ref["throughput"][
        "receiver.input"]
    assert tp["total_samples"] == tr["total_samples"] > 0
    assert (regs["port"].throughputs["receiver.input"].samplerate
            == regs["ref"].throughputs["receiver.input"].samplerate == fs)
    assert set(port["gauges"]) == set(ref["gauges"]) == {
        "audio.n.rms", "audio.a.rms"}
    for k, v in ref["gauges"].items():
        assert v > 0
        assert port["gauges"][k] == pytest.approx(v, rel=2e-4), k
    # the gauge is the RMS of the last block the sink received
    for k in spec:
        last = audio["port"][k][-1]
        assert port["gauges"][f"audio.{k}.rms"] == pytest.approx(
            float(np.sqrt(np.mean(np.square(last)))), rel=1e-6)


def test_receiver_without_metrics_records_nothing():
    fe = trx.IQFrontend(1e6, {"n": trx.VfoConfig(50e3, "nfm")},
                        device="cpu")
    rx = trx.Receiver(fe, block_len=fe.block_multiple())
    rx.push(_capture(1e6, fe.block_multiple()))
    rx.flush()
    assert rx.metrics is None and rx._thr is None
