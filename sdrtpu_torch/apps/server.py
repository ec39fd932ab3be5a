"""Headless baseband server — ``sdrpp --server`` parity
(``core/src/server.cpp``) (PyTorch counterpart of
``sdrtpu/apps/server.py``; host code).

Serves an IQ source over the SDR++ server protocol: clients (including an
actual SDR++ ``sdrpp_server_source``) connect, set sample type/compression,
START/STOP the stream and tune; baseband flows out PCM-scale-compressed.

    python -m sdrtpu_torch.apps.server --input capture.wav --port 5259
    python -m sdrtpu_torch.apps.server --source network --listen-port 4950

(installed as the ``sdrtpu-torch-server`` console script).  The server
relays samples and runs nothing on a device: a client moves what it
receives to the card.  The network source is the port's `NetworkSource`
(the native pump).

The file source loops its capture at real-time rate (like file_source):
unlike the reference's loop, which skips the capture's last partial
block at every wrap and sleeps one block's time after each send, it
serves the capture as one seamless loop (a block that crosses the end
takes its rest from the start) and paces against the clock from the
first block, so no sample is lost or repeated and the rate holds.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io import smgui, wav
from ..io.net import NetworkSource
from ..io.server_protocol import SdrppServer


class ServerMenu:
    """Remote source menu (``server.cpp drawMenu`` + file/network menus).

    Rendered over the SmGui draw-list protocol so a real SDR++
    ``sdrpp_server_source`` client shows a working source panel: source
    combo (force-synced, disabled while running), file path input, and
    network ingest settings.
    """

    SOURCES = ["File", "Network"]

    def __init__(self, state: dict):
        self.state = state  # keys: source_id, path, listen_port, format, running

    def draw(self, gui: smgui.SmGui) -> None:
        st = self.state
        if st.get("running"):
            gui.begin_disabled()
        gui.fill_width()
        gui.force_sync()
        changed, st["source_id"] = gui.combo(
            "##sdrtpu_server_src_sel", st.get("source_id", 0), self.SOURCES
        )
        if st.get("source_id", 0) == 0:
            gui.left_label("File")
            gui.fill_width()
            _, st["path"] = gui.input_text("##sdrtpu_file_path", st.get("path", ""))
        else:
            gui.left_label("Port")
            gui.fill_width()
            _, st["listen_port"] = gui.input_int(
                "##sdrtpu_net_port", st.get("listen_port", 4950), 0, 0
            )
            gui.left_label("Sample type")
            gui.fill_width()
            formats = ["u8", "i16", "f32"]
            fmt_id = formats.index(st.get("format", "i16"))
            _, fmt_id = gui.combo("##sdrtpu_net_fmt", fmt_id, formats)
            st["format"] = formats[fmt_id]
        if st.get("running"):
            gui.end_disabled()
        gui.text(f"Samplerate: {st.get('samplerate', 0):.0f} S/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrtpu-torch-server",
                                 description=__doc__)
    ap.add_argument("--input", help="IQ WAV file to serve (file source)")
    ap.add_argument("--source", default="file", choices=["file", "network"])
    ap.add_argument("--listen-port", type=int, default=4950,
                    help="raw IQ ingest port for --source network")
    ap.add_argument("--format", default="i16", choices=["u8", "i16", "f32"])
    ap.add_argument("--addr", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5259)
    ap.add_argument("--samplerate", type=float, default=None)
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="exit after this long (tests/automation)")
    args = ap.parse_args(argv)

    if args.source == "file":
        if not args.input:
            ap.error("--input required for the file source")
        info, iq = wav.read_iq_wav(args.input)
        fs = args.samplerate or info.samplerate
        print(f"serving {args.input}: {fs} S/s, {len(iq)} samples (looped)",
              file=sys.stderr, flush=True)
        net_src = None
    else:
        fs = args.samplerate or 1_000_000.0
        net_src = NetworkSource("tcp", "0.0.0.0", args.listen_port, args.format)
        iq = None
        print(f"ingesting raw IQ on :{net_src.port}", file=sys.stderr, flush=True)

    tuned = {"freq": 0.0}
    menu_state = {
        "source_id": 0 if args.source == "file" else 1,
        "path": args.input or "",
        "listen_port": args.listen_port,
        "format": args.format,
        "samplerate": fs,
        "running": False,
    }
    # Shared module-menu surface (apps/menus.py): the baseband server
    # registers its source panel; receiver-hosting apps register
    # scanner/recorder/radio panels into the same registry.
    from .menus import MenuRegistry

    registry = MenuRegistry()
    registry.register("Source", ServerMenu(menu_state).draw)
    menu = registry.remote()
    server = SdrppServer(
        args.addr, args.port, samplerate=fs,
        tune_callback=lambda f: tuned.update(freq=f),
        start_callback=lambda: menu_state.update(running=True),
        stop_callback=lambda: menu_state.update(running=False),
        menu=menu,
    )
    print(f"listening on {args.addr}:{server.port}", file=sys.stderr, flush=True)

    if iq is not None and len(iq) == 0:
        print("empty capture", file=sys.stderr)
        server.close()
        return 1
    t_start = time.time()
    pos = 0          # next sample of the looped capture
    sent = 0         # samples sent since the stream (re)started
    t0 = None        # when the stream (re)started, time.monotonic()
    try:
        while True:
            if args.max_seconds and time.time() - t_start > args.max_seconds:
                break
            if not server.running:
                t0 = None
                time.sleep(0.05)
                continue
            if iq is not None:
                # the capture looped without a seam: a block crossing its
                # end takes the rest from its start
                idx = (pos + np.arange(args.block)) % len(iq)
                block = iq[idx]
                pos = (pos + args.block) % len(iq)
                if t0 is None:
                    t0, sent = time.monotonic(), 0
                server.send_baseband(block)
                sent += args.block
                # real-time pacing against the clock, not per send
                wait = t0 + sent / fs - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
            else:
                chunk = net_src.read(timeout=0.25)
                if chunk is not None and len(chunk):
                    server.send_baseband(chunk)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        if net_src:
            net_src.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
