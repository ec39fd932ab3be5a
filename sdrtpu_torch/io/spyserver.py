"""SpyServer protocol client — ``source_modules/spyserver_source``
parity (PyTorch counterpart of ``sdrtpu/io/spyserver.py``; host code).

Implements the SpyServer wire protocol (protocol version 2.0.1700, per the
structures in ``spyserver_source/src/spyserver_protocol.h``): HELLO
handshake with client name, SET_SETTING commands (streaming mode/format,
IQ frequency/decimation/gain), and the framed message stream carrying
device info, client sync, and u8/i16/f32 IQ payloads.

`decode_iq` is the client's decoding of one IQ message body, as a
function of the bytes (the reference does it inline in ``_handle``).
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np

PROTOCOL_VERSION = (2 << 24) | (0 << 16) | 1700

CMD_HELLO = 0
CMD_SET_SETTING = 2
CMD_PING = 3

SETTING_STREAMING_MODE = 0
SETTING_STREAMING_ENABLED = 1
SETTING_GAIN = 2
SETTING_IQ_FORMAT = 100
SETTING_IQ_FREQUENCY = 101
SETTING_IQ_DECIMATION = 102
SETTING_IQ_DIGITAL_GAIN = 103

STREAM_TYPE_IQ = 1
STREAM_MODE_IQ_ONLY = STREAM_TYPE_IQ

FORMAT_UINT8 = 1
FORMAT_INT16 = 2
FORMAT_FLOAT = 4

MSG_DEVICE_INFO = 0
MSG_CLIENT_SYNC = 1
MSG_PONG = 2
MSG_UINT8_IQ = 100
MSG_INT16_IQ = 101
MSG_FLOAT_IQ = 103

_MSG_HDR = struct.Struct("<IIIII")
_CMD_HDR = struct.Struct("<II")


@dataclass
class DeviceInfo:
    device_type: int = 0
    serial: int = 0
    max_sample_rate: int = 0
    max_bandwidth: int = 0
    decimation_stages: int = 0
    gain_stages: int = 0
    max_gain_index: int = 0
    min_frequency: int = 0
    max_frequency: int = 0
    resolution: int = 0
    min_iq_decimation: int = 0
    forced_iq_format: int = 0


def decode_iq(mtype: int, body: bytes, mflags: int = 0) -> np.ndarray:
    """One IQ message body -> complex64 samples.

    The server reports its applied digital gain in ``mflags``; the
    reference DIVIDES the integer formats by it (scale = 1/(gain *
    full_scale), spyserver_client.cpp:136-151) but MULTIPLIES the float
    format by it (spyserver_client.cpp:156-160) — both matched verbatim.
    """
    gain = np.float32(10.0 ** (mflags / 20.0))
    if mtype == MSG_UINT8_IQ:
        x = np.frombuffer(body, np.uint8).astype(np.float32)
        x = (x - 128.0) * (1.0 / (gain * 128.0))
    elif mtype == MSG_INT16_IQ:
        x = np.frombuffer(body, np.int16).astype(np.float32) * (
            1.0 / (gain * 32768.0)
        )
    elif mtype == MSG_FLOAT_IQ:
        x = np.frombuffer(body, np.float32) * gain
    else:
        raise ValueError(f"not an IQ message type: {mtype}")
    n = (len(x) // 2) * 2
    return (x[0:n:2] + 1j * x[1:n:2]).astype(np.complex64)


class SpyServerClient:
    def __init__(self, host: str, port: int = 5555, name: str = "sdrtpu"):
        self._sock = socket.create_connection((host, port))
        self.device_info: DeviceInfo | None = None
        self.client_sync: dict | None = None
        self._chunks: deque[np.ndarray] = deque()
        self._cv = threading.Condition()
        self._running = True
        self._info_event = threading.Event()
        # HELLO: version + client name
        body = struct.pack("<I", PROTOCOL_VERSION) + name.encode()
        self._command(CMD_HELLO, body)
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()

    def _command(self, ctype: int, body: bytes) -> None:
        self._sock.sendall(_CMD_HDR.pack(ctype, len(body)) + body)

    def set_setting(self, setting: int, value: int) -> None:
        self._command(CMD_SET_SETTING, struct.pack("<II", setting, value))

    # -- convenience ------------------------------------------------------
    def start_stream(self, fmt: int = FORMAT_INT16) -> None:
        self.set_setting(SETTING_IQ_FORMAT, fmt)
        self.set_setting(SETTING_STREAMING_MODE, STREAM_MODE_IQ_ONLY)
        self.set_setting(SETTING_STREAMING_ENABLED, 1)

    def stop_stream(self) -> None:
        self.set_setting(SETTING_STREAMING_ENABLED, 0)

    def set_frequency(self, hz: float) -> None:
        self.set_setting(SETTING_IQ_FREQUENCY, int(hz))

    def set_decimation(self, stage: int) -> None:
        self.set_setting(SETTING_IQ_DECIMATION, stage)

    def set_gain(self, index: int) -> None:
        self.set_setting(SETTING_GAIN, index)

    def wait_device_info(self, timeout: float = 3.0) -> DeviceInfo | None:
        self._info_event.wait(timeout)
        return self.device_info

    # -- receive path -----------------------------------------------------
    def _recv_exact(self, n: int) -> bytes | None:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            try:
                k = self._sock.recv_into(view[got:], n - got)
            except OSError:
                return None
            if not k:
                return None
            got += k
        return bytes(buf)

    def _rx_loop(self):
        while self._running:
            hdr = self._recv_exact(_MSG_HDR.size)
            if hdr is None:
                return
            proto, mtype, stype, seq, size = _MSG_HDR.unpack(hdr)
            body = self._recv_exact(size)
            if body is None:
                return
            # MessageType carries the applied digital gain in its upper
            # 16 bits (spyserver_client.cpp:124-125); comparing the raw
            # field would drop every message once the server reports a
            # nonzero gain
            self._handle(mtype & 0xFFFF, body, mflags=mtype >> 16)

    def _handle(self, mtype: int, body: bytes, mflags: int = 0):
        if mtype == MSG_DEVICE_INFO and len(body) >= 48:
            self.device_info = DeviceInfo(*struct.unpack("<12I", body[:48]))
            self._info_event.set()
        elif mtype == MSG_CLIENT_SYNC and len(body) >= 36:
            keys = ("can_control", "gain", "device_center_frequency",
                    "iq_center_frequency", "fft_center_frequency",
                    "min_iq_center_frequency", "max_iq_center_frequency",
                    "min_fft_center_frequency", "max_fft_center_frequency")
            self.client_sync = dict(zip(keys, struct.unpack("<9I", body[:36])))
        elif mtype in (MSG_UINT8_IQ, MSG_INT16_IQ, MSG_FLOAT_IQ):
            iq = decode_iq(mtype, body, mflags)
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

    def close(self):
        self._running = False
        try:
            # a shutdown ends the receive thread's recv, and the server
            # sees the close (a bare close would wait for that thread)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
