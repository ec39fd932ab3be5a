"""sdrtpu_torch's scanner and recorder against sdrtpu's (host copies):
the same spectra give the same tune calls and states, and the same
audio and baseband blocks give byte-equal WAV files; tensors are taken
at the boundary."""

import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import recorder as jr  # noqa: E402
from sdrtpu.apps import scanner as js  # noqa: E402
from sdrtpu_torch.apps import recorder as tr  # noqa: E402
from sdrtpu_torch.apps import scanner as ts  # noqa: E402


def _line(n, wf_bw, freqs, level=-30.0):
    line = np.full(n, -80.0, np.float32)
    for f in freqs:
        idx = int((f + wf_bw / 2) / wf_bw * n)
        if 0 <= idx < n:
            line[max(0, idx - 2):idx + 3] = level
    return line


@pytest.mark.parametrize("scan_up", [True, False])
def test_same_spectra_same_tunes(scan_up):
    wf_bw = 1e6
    # a station at +200 kHz, gone, then one at -300 kHz, then quiet
    seq = ([_line(4096, wf_bw, [200e3])] * 12 + [_line(4096, wf_bw, [])] * 8
           + [_line(4096, wf_bw, [-300e3])] * 12
           + [_line(4096, wf_bw, [])] * 30)
    jt, tt = [], []
    kw = dict(interval=50e3, vfo_bandwidth=20e3, level_db=-50.0,
              linger_time=0.3, tuning_time=0.15, scan_up=scan_up)
    jsc = js.Scanner(-400e3, 400e3, tune_callback=jt.append, **kw)
    tsc = ts.Scanner(-400e3, 400e3, tune_callback=tt.append, **kw)
    for k, line in enumerate(seq):
        jsc.push_spectrum(line, 0.0, wf_bw, dt=0.1)
        tsc.push_spectrum(torch.as_tensor(line) if k % 2 else line, 0.0,
                          wf_bw, dt=0.1)
        assert (tsc.current, tsc.receiving) == (jsc.current, jsc.receiving)
    assert tt == jt
    assert any(abs(f - 200e3) < 25e3 for f in tt)
    assert any(abs(f + 300e3) < 25e3 for f in tt)


def test_template_equal():
    now = datetime.datetime(2026, 8, 17, 12, 34, 56)
    tpl = "$TYPE/$YEAR$MONTH$DAY-$HOUR$MIN$SEC_$FREQ.wav"
    assert tr.expand_template(tpl, 98.5e6, now) == jr.expand_template(
        tpl, 98.5e6, now)


@pytest.mark.parametrize("kw", [
    {"mode": "audio"},
    {"mode": "audio", "ignore_silence": True, "silence_threshold": 0.01},
    {"mode": "audio", "sample_type": "float32"},
    {"mode": "baseband"},
])
def test_wav_bytes_equal(tmp_path, kw):
    rng = np.random.default_rng(2)
    if kw["mode"] == "audio":
        blocks = [rng.uniform(-1, 1, (2, 4800)).astype(np.float32),
                  np.zeros((2, 4800), np.float32),
                  rng.uniform(-0.5, 0.5, (2, 1000)).astype(np.float32)]
    else:
        blocks = [(rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
                   ).astype(np.complex64) * 0.3 for _ in range(2)]
    paths = []
    for mod, conv in ((jr, np.asarray), (tr, torch.as_tensor)):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.wav")
        rec = mod.Recorder(path, 48000, **kw)
        for b in blocks:
            rec.push(conv(b))
        assert rec.close() == path
        paths.append((path, rec.peak, rec.recorded_samples))
    (jp, jpk, jn), (tp, tpk, tn) = paths
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert (tpk, tn) == (jpk, jn)


def test_empty_recording_equal(tmp_path):
    jp, tp = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    jr.Recorder(jp, 48000).close()
    tr.Recorder(tp, 48000).close()
    assert open(tp, "rb").read() == open(jp, "rb").read()
