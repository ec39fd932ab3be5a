"""Rich-presence / now-listening status publisher (PyTorch counterpart
of ``sdrtpu/apps/presence.py``; host code).

Parity target: ``misc_modules/discord_integration`` — which formats a
"Frequency: X / Mode: Y" status and pushes it to Discord's local RPC
socket every ~1 s via the vendored discord-rpc SDK (19.8 kLoC).  The
capability is the *status feed*; the transport here is pluggable
(callback, file, or any writer) since this framework is headless and the
Discord daemon socket is an external service.  The default line format
matches the reference's presence details ("frequency - mode").
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable


def format_frequency(freq_hz: float) -> str:
    """Human-readable frequency (reference utils/utils.cpp style)."""
    if freq_hz >= 1e9:
        return f"{freq_hz / 1e9:g}GHz"
    if freq_hz >= 1e6:
        return f"{freq_hz / 1e6:g}MHz"
    if freq_hz >= 1e3:
        return f"{freq_hz / 1e3:g}kHz"
    return f"{freq_hz:g}Hz"


@dataclass
class PresencePublisher:
    """Publishes the tuned-state line whenever it changes.

    ``sinks``: callables receiving the status dict; throttled to at most
    one update per ``min_interval`` seconds (the reference updates at
    1 Hz — ``discord_integration/main.cpp`` presence loop).
    """

    app_name: str = "sdrtpu"
    min_interval: float = 1.0
    sinks: list[Callable[[dict], None]] = field(default_factory=list)
    _last: dict | None = None
    _last_time: float = 0.0

    def status(self, freq_hz: float, mode: str | None = None) -> dict:
        details = format_frequency(freq_hz)
        if mode:
            details += f" - {mode}"
        return {"app": self.app_name, "details": details, "freq": freq_hz,
                "mode": mode}

    def update(self, freq_hz: float, mode: str | None = None,
               now: float | None = None) -> bool:
        """Returns True if the status was published."""
        now = time.monotonic() if now is None else now
        st = self.status(freq_hz, mode)
        unchanged = self._last is not None and st == self._last
        if unchanged or (now - self._last_time) < self.min_interval and self._last:
            return False
        self._last, self._last_time = st, now
        for s in self.sinks:
            s(st)
        return True


def file_sink(path: str) -> Callable[[dict], None]:
    """Write the status as one JSON line (for external presence bridges)."""

    def sink(st: dict):
        with open(path, "w") as f:
            json.dump(st, f)
            f.write("\n")

    return sink


class DiscordIpc:
    """Discord local-IPC rich-presence transport (no SDK needed).

    Speaks the daemon's actual wire protocol — the same one the
    reference's vendored discord-rpc SDK implements
    (``misc_modules/discord_integration``): a unix socket at
    ``$XDG_RUNTIME_DIR/discord-ipc-N`` carrying little-endian
    ``(opcode u32, length u32)``-framed JSON.  Opcode 0 = HANDSHAKE
    ({"v": 1, "client_id": ...}), 1 = FRAME (SET_ACTIVITY command),
    2 = CLOSE.

    Usable directly as a `PresencePublisher` sink::

        ipc = DiscordIpc(client_id="834590435708108840")
        pub = PresencePublisher(sinks=[ipc])
    """

    OP_HANDSHAKE, OP_FRAME, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 3, 4

    def __init__(self, client_id: str, socket_path: str | None = None):
        import os
        import socket as _socket
        import struct as _struct
        import uuid

        self._struct = _struct
        self._uuid = uuid
        self.client_id = str(client_id)
        self._sock = None
        paths = [socket_path] if socket_path else [
            os.path.join(
                os.environ.get("XDG_RUNTIME_DIR", "/tmp"),
                f"discord-ipc-{i}",
            )
            for i in range(10)
        ]
        last = None
        for p in paths:
            try:
                s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
                s.settimeout(2.0)
                s.connect(p)
                self._sock = s
                break
            except OSError as e:
                last = e
        if self._sock is None:
            raise OSError(f"no Discord IPC socket reachable: {last}")
        self._rxbuf = b""
        self._send(self.OP_HANDSHAKE, {"v": 1, "client_id": self.client_id})
        self._recv()  # READY dispatch

    def _send(self, op: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self._sock.sendall(self._struct.pack("<II", op, len(data)) + data)

    def _recv(self) -> tuple[int, dict]:
        hdr = b""
        while len(hdr) < 8:
            chunk = self._sock.recv(8 - len(hdr))
            if not chunk:
                raise OSError("IPC socket closed")
            hdr += chunk
        op, length = self._struct.unpack("<II", hdr)
        body = b""
        while len(body) < length:
            chunk = self._sock.recv(length - len(body))
            if not chunk:
                raise OSError("IPC socket closed")
            body += chunk
        return op, json.loads(body or b"{}")

    def _drain_replies(self) -> None:
        """Discard queued daemon reply frames (one per command).

        The daemon acks every SET_ACTIVITY; without consuming the acks a
        long-running presence session fills the socket receive buffer
        until the daemon's writes stall and it drops the connection.
        PING frames are answered with PONG (echoed payload) — an
        unanswered ping also gets the client disconnected.
        Non-blocking; partial frames stay buffered across calls.
        """
        self._sock.setblocking(False)
        try:
            while True:
                try:
                    chunk = self._sock.recv(65536)
                except (BlockingIOError, InterruptedError):
                    break
                if not chunk:
                    raise OSError("IPC socket closed")
                self._rxbuf += chunk
        finally:
            self._sock.settimeout(2.0)
        while len(self._rxbuf) >= 8:
            op, length = self._struct.unpack("<II", self._rxbuf[:8])
            if len(self._rxbuf) < 8 + length:
                break
            body = self._rxbuf[8:8 + length]
            self._rxbuf = self._rxbuf[8 + length:]
            if op == self.OP_PING:
                payload = json.loads(body or b"{}")
                self._send(self.OP_PONG, payload)

    def set_activity(self, details: str, state: str = "",
                     start: float | None = None) -> None:
        import os

        self._drain_replies()
        activity = {"details": details}
        if state:
            activity["state"] = state
        if start is not None:
            activity["timestamps"] = {"start": int(start)}
        self._send(self.OP_FRAME, {
            "cmd": "SET_ACTIVITY",
            "nonce": str(self._uuid.uuid4()),
            "args": {"pid": os.getpid(), "activity": activity},
        })

    def __call__(self, st: dict) -> None:
        """PresencePublisher sink: push the status as an activity."""
        self.set_activity(st.get("details", ""), st.get("app", ""))

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._send(self.OP_CLOSE, {})
            except OSError:
                pass
            self._sock.close()
            self._sock = None
