"""sdrtpu_torch's web spectrum view (`apps/webview.py`) over a port
`Receiver` on the CPU, against sdrtpu's over the reference's `Receiver`
fed the same blocks.

``/spectrum.json``: the same view metadata, and every bin within 80 dB
of the line's peak within 0.02 dB of the reference's (PERF.md §2's
waterfall tolerance; the JSON rounds to 0.01 dB).  ``/status.json`` and
``/tune`` equal.  Each request has its own 10 s timeout.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import receiver as jrx  # noqa: E402
from sdrtpu.apps import waterfall as jwf  # noqa: E402
from sdrtpu.apps import webview as jweb  # noqa: E402
from sdrtpu_torch.apps import receiver as trx  # noqa: E402
from sdrtpu_torch.apps import waterfall as twf  # noqa: E402
from sdrtpu_torch.apps import webview as tweb  # noqa: E402

FS = 400_000.0
SPEC_DB_ATOL = 0.02


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _rx(mod, view, **kw):
    fe = mod.IQFrontend(FS, {"v0": mod.VfoConfig(100_000.0, "nfm")},
                        spectrum=True, fft_size=1024, fft_rate=FS / 4096,
                        **kw)
    return mod.Receiver(fe, block_len=fe.block_multiple(),
                        spectrum_sink=view.push)


def test_endpoints_equal_and_live_tune():
    t_view = twf.WaterfallView(fft_size=1024, height=64, view_width=256)
    j_view = jwf.WaterfallView(fft_size=1024, height=64, view_width=256)
    t_rx = _rx(trx, t_view, device="cpu")
    j_rx = _rx(jrx, j_view)
    t = np.arange(4 * t_rx.block_len) / FS
    rng = np.random.default_rng(8)
    iq = (0.5 * np.exp(2j * np.pi * 100_000.0 * t)
          + 0.2 * np.exp(2j * np.pi * -60_000.0 * t)
          + 1e-3 * (rng.standard_normal(t.size)
                    + 1j * rng.standard_normal(t.size))).astype(np.complex64)
    t_rx.push(iq)
    j_rx.push(iq)
    t_srv = tweb.SpectrumWebServer(t_view, receiver=t_rx)
    j_srv = jweb.SpectrumWebServer(j_view, receiver=j_rx)
    try:
        code, body = get(t_srv.port, "/")
        assert code == 200 and body == get(j_srv.port, "/")[1]

        code, body = get(t_srv.port, "/spectrum.json")
        assert code == 200
        ts, js = json.loads(body), json.loads(get(j_srv.port,
                                                  "/spectrum.json")[1])
        assert {k: v for k, v in ts.items() if k != "db"} == {
            k: v for k, v in js.items() if k != "db"}
        td, jd = np.array(ts["db"]), np.array(js["db"])
        assert td.shape == (256,)
        live = jd > jd.max() - 80.0
        assert np.abs(td - jd)[live].max() <= SPEC_DB_ATOL
        # the 100 kHz tone lights its bin: 256-wide view of 1024 bins
        freqs = np.fft.fftshift(np.fft.fftfreq(1024, 1 / FS))
        assert abs(freqs[int(np.argmax(td)) * 4 + 2] - 100_000.0) < 5000.0

        code, body = get(t_srv.port, "/status.json")
        assert code == 200 and json.loads(body) == json.loads(
            get(j_srv.port, "/status.json")[1])
        for srv in (t_srv, j_srv):
            code, body = get(srv.port, "/tune?vfo=v0&offset=-50000")
            assert code == 200 and json.loads(body)["ok"]
        st = json.loads(get(t_srv.port, "/status.json")[1])
        assert st == json.loads(get(j_srv.port, "/status.json")[1])
        assert st["vfos"]["v0"] == {"offset": -50000.0, "mode": "nfm"}
        assert st["samplerate"] == FS
        assert get(t_srv.port, "/nope")[0] == 404
        assert get(t_srv.port, "/tune?vfo=zz&offset=1")[0] == 500
    finally:
        t_srv.close()
        j_srv.close()
    # the retune took effect in the port's audio path state
    assert t_rx.frontend.vfos["v0"].cfg.offset_hz == -50000.0


def test_waterfall_png_and_tensor_views():
    pytest.importorskip("PIL")
    view = twf.WaterfallView(fft_size=64, height=8, view_width=16)
    view.push(np.linspace(-90.0, 0.0, 64, dtype=np.float32)[None])
    srv = tweb.SpectrumWebServer(view)
    try:
        code, body = get(srv.port, "/waterfall.png")
        assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        numpy_json = get(srv.port, "/spectrum.json")[1]
        # the view's arrays as tensors (a producer on the card): the same
        view.latest = torch.from_numpy(view.latest.copy())
        view.fb = torch.from_numpy(view.fb.copy())
        assert get(srv.port, "/spectrum.json")[1] == numpy_json
        assert get(srv.port, "/waterfall.png")[1] == body
        assert json.loads(get(srv.port, "/status.json")[1]) == {
            "samplerate": 0.0, "vfos": {}}
        assert get(srv.port, "/tune?vfo=v0&offset=1")[0] == 500
    finally:
        srv.close()
