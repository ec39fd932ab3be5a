"""SDR++ server protocol: headless baseband server + client (PyTorch
counterpart of ``sdrtpu/io/server_protocol.py``; host code).

Wire format parity with ``core/src/server_protocol.h:9-52`` and the server
loop in ``core/src/server.cpp``:

    PacketHeader  { u32 type; u32 size; }   (size includes the header)
    CommandHeader { u32 cmd; }

Packet types and commands mirror the reference enums, so this server can
feed an actual SDR++ ``sdrpp_server_source`` client with baseband AND a
live remote UI: pass a :class:`~sdrtpu_torch.io.smgui.RemoteMenu` and GET_UI /
UI_ACTION round-trip real SmGui draw lists (``server.cpp:249-300``).

The server streams PCM-scale-compressed baseband (``compression.py``)
optionally wrapped in zstd, exactly like ``server.cpp:232-246``.

Differences from the reference: ``send_baseband`` also takes a torch
tensor on any device; a SET_COMPRESSION request that cannot be met (no
zstd on this host) is answered with ``PKT_ERROR`` (`ERR_NO_COMPRESSION`)
and logged, not acknowledged and ignored, and the client's
`SdrppClient.set_compression` raises before asking for what it could
not decode.  The client's `SdrppClient.recv_baseband` returns numpy
complex64, as the reference's does: the caller moves it to the card.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading

import numpy as np

from . import compression, smgui

# PacketType (server_protocol.h)
PKT_COMMAND = 0
PKT_COMMAND_ACK = 1
PKT_BASEBAND = 2
PKT_BASEBAND_COMPRESSED = 3
PKT_VFO = 4
PKT_FFT = 5
PKT_ERROR = 6

# Command
CMD_GET_UI = 0x00
CMD_UI_ACTION = 0x01
CMD_START = 0x02
CMD_STOP = 0x03
CMD_SET_FREQUENCY = 0x04
CMD_GET_SAMPLERATE = 0x05
CMD_SET_SAMPLE_TYPE = 0x06
CMD_SET_COMPRESSION = 0x07
CMD_SET_SAMPLERATE = 0x80
CMD_DISCONNECT = 0x81

# PKT_ERROR codes: 1 bad packet, 2 unknown command (as the reference);
# 3 compression asked for where no zstd is available (the port's)
ERR_BAD_PACKET = 1
ERR_UNKNOWN_COMMAND = 2
ERR_NO_COMPRESSION = 3

_HDR = struct.Struct("<II")
log = logging.getLogger(__name__)


def write_packet(sock: socket.socket, ptype: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(ptype, _HDR.size + len(payload)) + payload)


def read_packet(sock: socket.socket) -> tuple[int, bytes] | None:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    ptype, size = _HDR.unpack(hdr)
    payload = _recv_exact(sock, size - _HDR.size)
    if payload is None:
        return None
    return ptype, payload


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    # into one preallocated buffer: a baseband packet is hundreds of KB
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except OSError:
            return None
        if not k:
            return None
        got += k
    return bytes(buf)


class SdrppServer:
    """Single-client baseband server (``server::main`` behavior).

    ``tune_callback(freq)`` and ``start/stop_callback()`` hook the radio
    control plane; call ``send_baseband(iq)`` from the streaming loop while
    running.
    """

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 5259,
        samplerate: float = 1_000_000.0,
        tune_callback=None,
        start_callback=None,
        stop_callback=None,
        menu: "smgui.RemoteMenu | None" = None,
    ):
        self.samplerate = samplerate
        self.tune_callback = tune_callback
        self.start_callback = start_callback
        self.stop_callback = stop_callback
        self.menu = menu
        self.running = False
        self.sample_type = compression.PCM_TYPE_I16
        self.use_compression = False
        self._client: socket.socket | None = None
        self._lock = threading.Lock()
        self._wlock = threading.Lock()  # serializes writes to the client
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self._alive = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def _accept_loop(self):
        while self._alive:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self._client is not None:
                    # reject second client (server.cpp:165-186)
                    conn.close()
                    continue
                self._client = conn
            # per-connect settings reset + samplerate announce
            # (server.cpp:191-196): stop the source, PCM i16, compression
            # off, then PUSH the rate as a COMMAND — the reference client
            # only learns the samplerate from this packet (it never sends
            # GET_SAMPLERATE)
            self.running = False
            if self.stop_callback:
                self.stop_callback()
            self.sample_type = compression.PCM_TYPE_I16
            self.use_compression = False
            try:
                self._send(conn, PKT_COMMAND,
                           struct.pack("<Id", CMD_SET_SAMPLERATE,
                                       self.samplerate))
            except OSError:
                pass
            t = threading.Thread(target=self._client_loop, args=(conn,), daemon=True)
            t.start()

    def _send(self, conn, ptype: int, payload: bytes = b"") -> None:
        """All writes to the client socket serialize through one lock:
        the streaming thread (send_baseband) and the command thread
        (ACK/UI replies) share the connection, and interleaved sendall
        calls would corrupt the packet framing."""
        with self._wlock:
            write_packet(conn, ptype, payload)

    def _client_loop(self, conn: socket.socket):
        while self._alive:
            pkt = read_packet(conn)
            if pkt is None:
                break
            ptype, payload = pkt
            try:
                if ptype != PKT_COMMAND or len(payload) < 4:
                    self._send(conn, PKT_ERROR,
                               struct.pack("<I", ERR_BAD_PACKET))
                    continue
                (cmd,) = struct.unpack("<I", payload[:4])
                self._handle_command(conn, cmd, payload[4:])
            except OSError:  # the client went away before a reply
                break
        with self._lock:
            if self._client is conn:
                self._client = None
        conn.close()

    def _handle_command(self, conn, cmd, args):
        if cmd == CMD_GET_UI:
            ui = self.menu.render() if self.menu else b""
            self._send(conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_GET_UI) + ui)
        elif cmd == CMD_UI_ACTION and len(args) >= 3:
            # u8 sendback + diffId item + diffValue item (server.cpp:252-279)
            sendback = bool(args[0])
            try:
                diff_id, off = smgui.load_item(args, 1)
                diff_value, _ = smgui.load_item(args, off)
            except (ValueError, IndexError, struct.error):
                self._send(conn, PKT_ERROR, struct.pack("<I", ERR_BAD_PACKET))
                return
            if diff_id.type != smgui.ELEM_STRING:
                self._send(conn, PKT_ERROR, struct.pack("<I", ERR_BAD_PACKET))
                return
            if self.menu is None:
                if sendback:
                    self._send(
                        conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_UI_ACTION)
                    )
                return
            ui = self.menu.render(diff_id.s, diff_value)
            if sendback:
                self._send(
                    conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_UI_ACTION) + ui
                )
        elif cmd == CMD_START:
            self.running = True
            if self.start_callback:
                self.start_callback()
            self._send(conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_START))
        elif cmd == CMD_STOP:
            self.running = False
            if self.stop_callback:
                self.stop_callback()
            self._send(conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_STOP))
        elif cmd == CMD_SET_FREQUENCY and len(args) >= 8:
            (freq,) = struct.unpack("<d", args[:8])
            if self.tune_callback:
                self.tune_callback(freq)
            self._send(conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_SET_FREQUENCY))
        elif cmd == CMD_GET_SAMPLERATE:
            # replied as a COMMAND (sendSampleRate, server.cpp:361-369) —
            # the reference client only parses SET_SAMPLERATE from
            # PKT_COMMAND packets
            self._send(
                conn,
                PKT_COMMAND,
                struct.pack("<Id", CMD_SET_SAMPLERATE, self.samplerate),
            )
        elif cmd == CMD_SET_SAMPLE_TYPE and len(args) >= 1:
            # u8 on the wire (server.cpp:294 requires len==1); reading
            # byte 0 also tolerates a 4-byte little-endian encoding
            self.sample_type = args[0]
            self._send(conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_SET_SAMPLE_TYPE))
        elif cmd == CMD_SET_COMPRESSION and len(args) >= 1:
            if bool(args[0]) and not compression.HAVE_ZSTD:
                # refused, not silently ignored: the client asked for it
                log.warning("a client asked for zstd compression; neither "
                            "the zstandard module nor libzstd is available")
                self.use_compression = False
                self._send(conn, PKT_ERROR,
                           struct.pack("<I", ERR_NO_COMPRESSION))
                return
            self.use_compression = bool(args[0])
            self._send(conn, PKT_COMMAND_ACK, struct.pack("<I", CMD_SET_COMPRESSION))
        else:
            self._send(conn, PKT_ERROR, struct.pack("<I", ERR_UNKNOWN_COMMAND))

    def send_baseband(self, iq) -> None:
        """Send one block (numpy complex64, or a tensor on any device) to
        the running client; a no-op while no client runs."""
        with self._lock:
            conn = self._client
        if conn is None or not self.running:
            return
        payload = compression.compress(iq, self.sample_type)
        if self.use_compression:
            payload = compression.zstd_compress(payload, 1)
            ptype = PKT_BASEBAND_COMPRESSED
        else:
            ptype = PKT_BASEBAND
        try:
            self._send(conn, ptype, payload)
        except OSError:
            with self._lock:
                if self._client is conn:  # don't clobber a reconnect
                    self._client = None

    def close(self):
        self._alive = False
        self._listener.close()
        with self._lock:
            if self._client:
                self._client.close()


class SdrppClient:
    """Client of the server protocol (``sdrpp_server_source`` parity).

    ``samplerate`` updates whenever the server pushes SET_SAMPLERATE (on
    connect and on rate changes) — the reference client learns the rate
    the same way (``sdrpp_server_client.cpp:182``).  Baseband packets
    arriving while a command waits for its ACK are buffered, not
    dropped.
    """

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self.samplerate: float | None = None
        self._pending_bb: list[np.ndarray] = []

    def _command(self, cmd: int, args: bytes = b"") -> None:
        write_packet(self._sock, PKT_COMMAND, struct.pack("<I", cmd) + args)

    def start(self):
        self._command(CMD_START)

    def stop(self):
        self._command(CMD_STOP)

    def set_frequency(self, freq: float):
        self._command(CMD_SET_FREQUENCY, struct.pack("<d", freq))

    def set_sample_type(self, pcm_type: int):
        # u8 on the wire — the reference server requires len==1
        # (``server.cpp:294``)
        self._command(CMD_SET_SAMPLE_TYPE, bytes([pcm_type]))

    def set_compression(self, enabled: bool):
        if enabled and not compression.HAVE_ZSTD:
            raise RuntimeError("zstd compression needs the zstandard module "
                               "or libzstd, and neither is available")
        self._command(CMD_SET_COMPRESSION, bytes([int(enabled)]))

    def _absorb(self, ptype: int, payload: bytes) -> None:
        """Handle stream packets seen while waiting for something else:
        baseband is BUFFERED (dropping it would gap recordings on every
        UI round trip), samplerate pushes update ``self.samplerate``."""
        if ptype == PKT_BASEBAND:
            self._pending_bb.append(compression.decompress(payload))
        elif ptype == PKT_BASEBAND_COMPRESSED:
            self._pending_bb.append(
                compression.decompress(compression.zstd_decompress(payload))
            )
        elif ptype == PKT_COMMAND and len(payload) >= 12:
            (cmd,) = struct.unpack("<I", payload[:4])
            if cmd == CMD_SET_SAMPLERATE:
                (self.samplerate,) = struct.unpack("<d", payload[4:12])
        elif (ptype == PKT_ERROR and len(payload) >= 4
              and struct.unpack("<I", payload[:4])[0] == ERR_NO_COMPRESSION):
            raise RuntimeError("the server refused zstd compression: it has "
                               "no zstd")

    def _await_ack(self, cmd: int, timeout: float = 5.0) -> bytes:
        self._sock.settimeout(timeout)
        try:
            while True:
                pkt = read_packet(self._sock)
                if pkt is None:
                    raise ConnectionError("server closed")
                ptype, payload = pkt
                if ptype == PKT_COMMAND_ACK and len(payload) >= 4:
                    (acked,) = struct.unpack("<I", payload[:4])
                    if acked == cmd:
                        return payload[4:]
                else:
                    self._absorb(ptype, payload)
        finally:
            self._sock.settimeout(None)

    def get_ui(self) -> "list[smgui.Widget]":
        """Fetch and parse the server's remote menu (GET_UI round trip)."""
        self._command(CMD_GET_UI)
        return smgui.parse_widgets(self._await_ack(CMD_GET_UI))

    def ui_action(
        self, widget_label: str, value: "smgui.Elem", sendback: bool = True
    ) -> "list[smgui.Widget] | None":
        """Send a widget interaction diff; returns the re-rendered menu.

        Mirrors ``sdrpp_server_client`` action packets: ``u8 sendback`` +
        serialized (label, value) draw-list items.
        """
        payload = (
            bytes([int(sendback)])
            + smgui.store_item(smgui.Elem.string(widget_label))
            + smgui.store_item(value)
        )
        self._command(CMD_UI_ACTION, payload)
        if not sendback:
            return None
        return smgui.parse_widgets(self._await_ack(CMD_UI_ACTION))

    def get_samplerate(self) -> float:
        self._command(CMD_GET_SAMPLERATE)
        while True:
            pkt = read_packet(self._sock)
            if pkt is None:
                raise ConnectionError("server closed")
            ptype, payload = pkt
            # the rate arrives as a COMMAND (sendSampleRate); accept the
            # legacy ACK-typed reply too
            if ptype in (PKT_COMMAND, PKT_COMMAND_ACK) and len(payload) >= 12:
                cmd, value = struct.unpack("<Id", payload[:12])
                if cmd == CMD_SET_SAMPLERATE:
                    self.samplerate = value
                    return value
            self._absorb(ptype, payload)

    def recv(self) -> tuple[int, bytes] | None:
        return read_packet(self._sock)

    def recv_baseband(self, timeout: float = 5.0) -> np.ndarray | None:
        if self._pending_bb:
            return self._pending_bb.pop(0)
        self._sock.settimeout(timeout)
        try:
            while True:
                pkt = read_packet(self._sock)
                if pkt is None:
                    return None
                ptype, payload = pkt
                if ptype == PKT_BASEBAND:
                    return compression.decompress(payload)
                if ptype == PKT_BASEBAND_COMPRESSED:
                    return compression.decompress(
                        compression.zstd_decompress(payload)
                    )
                self._absorb(ptype, payload)
        finally:
            self._sock.settimeout(None)

    def close(self):
        self._sock.close()
