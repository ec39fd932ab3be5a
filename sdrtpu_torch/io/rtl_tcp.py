"""rtl_tcp client (PyTorch counterpart of ``sdrtpu/io/rtl_tcp.py``;
``source_modules/rtl_tcp_source`` capability; host code).

Speaks the rtl_tcp protocol: on connect the server sends a 12-byte header
("RTL0", tuner type, gain count); the client sends 5-byte commands
(u8 opcode + u32 big-endian argument) and receives an endless u8
interleaved IQ stream, converted by the port's `io.net.bytes_to_iq`.
The receive thread wakes every ``POLL_S`` seconds, so `close` ends it.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque

import numpy as np

from .net import POLL_S, bytes_to_iq

CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08
CMD_SET_DIRECT_SAMPLING = 0x09
CMD_SET_OFFSET_TUNING = 0x0A
CMD_SET_BIAS_TEE = 0x0E


class RtlTcpClient:
    def __init__(self, host: str, port: int = 1234,
                 connect_timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        hdr = self._recv_exact(12)
        self._sock.settimeout(POLL_S)
        if hdr is None or hdr[:4] != b"RTL0":
            raise ConnectionError("not an rtl_tcp server")
        self.tuner_type, self.tuner_gain_count = struct.unpack(">II", hdr[4:])
        self._chunks: deque[np.ndarray] = deque()
        self._cv = threading.Condition()
        self._running = True
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _command(self, cmd: int, arg: int) -> None:
        self._sock.sendall(struct.pack(">BI", cmd, arg & 0xFFFFFFFF))

    def set_frequency(self, hz: float):
        self._command(CMD_SET_FREQ, int(hz))

    def set_sample_rate(self, sps: float):
        self._command(CMD_SET_SAMPLE_RATE, int(sps))

    def set_gain_mode(self, manual: bool):
        self._command(CMD_SET_GAIN_MODE, int(manual))

    def set_gain(self, tenths_db: int):
        self._command(CMD_SET_GAIN, tenths_db)

    def set_agc_mode(self, on: bool):
        self._command(CMD_SET_AGC_MODE, int(on))

    def set_bias_tee(self, on: bool):
        self._command(CMD_SET_BIAS_TEE, int(on))

    def _rx_loop(self):
        buf = b""
        while self._running:
            try:
                data = self._sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            buf += data
            usable = (len(buf) // 2) * 2
            if usable:
                iq = bytes_to_iq(buf[:usable], "u8")
                buf = buf[usable:]
                with self._cv:
                    self._chunks.append(iq)
                    self._cv.notify()

    def read(self, timeout: float = 1.0) -> np.ndarray | None:
        with self._cv:
            if not self._chunks:
                self._cv.wait(timeout)
            if not self._chunks:
                return None
            out = np.concatenate(list(self._chunks))
            self._chunks.clear()
            return out

    def close(self, timeout: float = 5.0):
        """Stop receiving and end the receive thread (waits up to
        ``timeout`` seconds for it)."""
        self._running = False
        self._thread.join(timeout)
        try:
            self._sock.close()
        except OSError:
            pass
