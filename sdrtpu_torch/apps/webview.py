"""Lightweight web spectrum/waterfall view — the headless GUI surface
(PyTorch counterpart of ``sdrtpu/apps/webview.py``; host code).

The reference's display layer is ImGui (``core/src/gui/``); SURVEY §7
re-exposes it as arrays with "an optional lightweight web view later".
This is that view: a stdlib-only HTTP server over a `WaterfallView` (and
optionally a live `Receiver`) serving

- ``/``               — a self-contained HTML page (canvas waterfall +
                        spectrum trace, 4 Hz polling, click-to-tune when
                        a tune callback is wired)
- ``/spectrum.json``  — latest zoomed spectrum line + view metadata
- ``/waterfall.png``  — the rendered waterfall framebuffer
- ``/status.json``    — receiver status (VFO offsets/modes, samplerate)
- ``/tune?vfo=..&offset=..`` — live retune (`Receiver.retune`, no
                        recompilation)

No dependencies beyond PIL (already used by `save_waterfall_png`), and
that only for ``/waterfall.png``.  Thread-safe against a producer pushing
FFT frames: `WaterfallView.push` replaces arrays atomically and readers
only snapshot references.  The view's ``latest`` and ``fb`` may be torch
tensors on any device: they are copied to the host at the boundary.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..convert import to_numpy

_PAGE = """<!DOCTYPE html>
<html><head><title>sdrtpu</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em }
canvas { image-rendering:pixelated; width:100%; }
#bar { margin-bottom: .5em }
</style></head><body>
<div id="bar">sdrtpu &middot; <span id="status">connecting...</span></div>
<canvas id="spec" width="1024" height="160"></canvas>
<canvas id="wf" width="1024" height="512"></canvas>
<script>
const spec = document.getElementById('spec').getContext('2d');
const wf = document.getElementById('wf');
async function tick() {
  try {
    const s = await (await fetch('spectrum.json')).json();
    const img = new Image();
    img.src = 'waterfall.png?' + Date.now();
    img.onload = () => wf.getContext('2d').drawImage(img, 0, 0);
    spec.fillStyle = '#111'; spec.fillRect(0, 0, 1024, 160);
    spec.strokeStyle = '#6cf'; spec.beginPath();
    const d = s.db, lo = s.wf_min, hi = s.wf_max;
    for (let i = 0; i < d.length; i++) {
      const y = 160 - 160 * (d[i] - lo) / (hi - lo);
      i ? spec.lineTo(i * 1024 / d.length, y)
        : spec.moveTo(0, y);
    }
    spec.stroke();
    const st = await (await fetch('status.json')).json();
    document.getElementById('status').textContent =
      st.samplerate + ' S/s ' + JSON.stringify(st.vfos);
  } catch (e) { document.getElementById('status').textContent = 'offline'; }
  setTimeout(tick, 250);
}
tick();
</script></body></html>"""


class SpectrumWebServer:
    """Serve a `WaterfallView` (+ optional Receiver) over HTTP."""

    def __init__(self, view, receiver=None, host: str = "127.0.0.1",
                 port: int = 0):
        self.view = view
        self.receiver = receiver
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/":
                        self._send(200, "text/html", _PAGE.encode())
                    elif url.path == "/spectrum.json":
                        self._send(200, "application/json",
                                   outer._spectrum_json())
                    elif url.path == "/waterfall.png":
                        self._send(200, "image/png", outer._waterfall_png())
                    elif url.path == "/status.json":
                        self._send(200, "application/json",
                                   outer._status_json())
                    elif url.path == "/tune":
                        q = parse_qs(url.query)
                        outer._tune(q["vfo"][0], float(q["offset"][0]))
                        self._send(200, "application/json", b'{"ok": true}')
                    else:
                        self._send(404, "text/plain", b"not found")
                except Exception as e:  # noqa: BLE001 - report to client
                    self._send(500, "text/plain", repr(e).encode())

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def _spectrum_json(self) -> bytes:
        v = self.view
        line = to_numpy(v.latest).astype(np.float32)
        line = np.where(np.isfinite(line), line, v.wf_min)
        return json.dumps({
            "db": [round(float(x), 2) for x in line],
            "wf_min": v.wf_min,
            "wf_max": v.wf_max,
            "fft_size": v.fft_size,
            "view_offset": v.view_offset,
            "view_size": v.view_size,
        }).encode()

    def _waterfall_png(self) -> bytes:
        from PIL import Image

        fb = to_numpy(self.view.fb)
        buf = io.BytesIO()
        Image.fromarray(fb, "RGBA").save(buf, "PNG")
        return buf.getvalue()

    def _status_json(self) -> bytes:
        st = {"samplerate": 0.0, "vfos": {}}
        rx = self.receiver
        if rx is not None:
            st["samplerate"] = rx.frontend.samplerate
            st["vfos"] = {
                name: {"offset": vfo.cfg.offset_hz, "mode": vfo.cfg.mode}
                for name, vfo in rx.frontend.vfos.items()
            }
        return json.dumps(st).encode()

    def _tune(self, vfo: str, offset: float) -> None:
        if self.receiver is None:
            raise RuntimeError("no receiver attached")
        self.receiver.retune(vfo, offset)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
