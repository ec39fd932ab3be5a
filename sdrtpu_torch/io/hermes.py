"""Hermes-Lite 2 / Metis (openHPSDR protocol 1) source (PyTorch
counterpart of ``sdrtpu/io/hermes.py``; host code).

Parity with ``source_modules/hermes_source``: UDP discovery (signature
0xEFFE type 0x02), stream start/stop control packets (type 0x04), USB
packets (type 0x01, endpoint 6) carrying two 512-byte HPSDR frames — each
with a 0x7F,0x7F,0x7F sync, C0-addressed control registers, and 63 IQ
samples of 24-bit big-endian I and Q (plus 16-bit mic).  Writable
registers (RX NCO frequency, sample rate, LNA gain) are sent on the C0/C1-4
control bytes of outgoing USB frames.

`build_usb_packet` packs with numpy (the reference loops over samples in
Python); its bytes are the reference's for the same samples.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np

METIS_SIGNATURE = 0xEFFE
PKT_USB = 0x01
PKT_DISCOVER = 0x02
PKT_CONTROL = 0x04
CTRL_IQ = 1 << 0
CTRL_NO_WD = 1 << 7  # disable the gateware watchdog (hermes.h:28)
SAMPLES_PER_FRAME = 63
SYNC = b"\x7f\x7f\x7f"

HL_REG_RX1_NCO_FREQ = 0x02
SAMP_RATE_CODES = {48000: 0, 96000: 1, 192000: 2, 384000: 3}


@dataclass
class DiscoveredDevice:
    addr: tuple[str, int]
    mac: bytes
    gateware_major: int
    gateware_minor: int
    board_id: int


def discover(broadcast: str = "255.255.255.255", port: int = 1024,
             timeout: float = 1.0) -> list[DiscoveredDevice]:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    s.settimeout(timeout)
    pkt = struct.pack(">HB", METIS_SIGNATURE, PKT_DISCOVER) + bytes(60)
    s.sendto(pkt, (broadcast, port))
    found = []
    try:
        while True:
            data, addr = s.recvfrom(1024)
            if len(data) >= 11 and data[:2] == b"\xEF\xFE":
                found.append(DiscoveredDevice(
                    addr=addr,
                    mac=data[3:9],
                    # byte offsets per the reference parse
                    # (hermes.cpp:264-265: major at 0x09, minor at 0x15)
                    # and the Metis discovery layout (board id at 0x0A)
                    gateware_major=data[0x09],
                    gateware_minor=data[0x15] if len(data) > 0x15 else 0,
                    board_id=data[0x0A] if len(data) > 0x0A else 0,
                ))
    except socket.timeout:
        pass
    finally:
        s.close()
    return found


def parse_usb_packet(data: bytes) -> np.ndarray:
    """Metis USB packet -> complex64 IQ samples (both frames)."""
    if len(data) < 8 + 1024 or data[:2] != b"\xEF\xFE" or data[2] != PKT_USB:
        return np.zeros(0, np.complex64)
    out = []
    for f in range(2):
        frame = data[8 + f * 512 : 8 + (f + 1) * 512]
        if frame[:3] != SYNC:
            continue
        body = frame[8:]
        n = min(SAMPLES_PER_FRAME, len(body) // 8)
        arr = np.frombuffer(body[: n * 8], np.uint8).reshape(n, 8)
        def s24(b0, b1, b2):
            v = (b0.astype(np.int32) << 16) | (b1.astype(np.int32) << 8) | b2
            return np.where(v >= (1 << 23), v - (1 << 24), v)
        i = s24(arr[:, 0], arr[:, 1], arr[:, 2]).astype(np.float32) / (1 << 23)
        q = s24(arr[:, 3], arr[:, 4], arr[:, 5]).astype(np.float32) / (1 << 23)
        out.append((i + 1j * q).astype(np.complex64))
    return np.concatenate(out) if out else np.zeros(0, np.complex64)


def _s24(v: np.ndarray) -> np.ndarray:
    """float samples -> (n, 3) big-endian 24-bit two's complement bytes,
    rounded half to even as Python's ``round``."""
    q = np.clip(np.rint(v.astype(np.float64) * (1 << 23)),
                -(1 << 23), (1 << 23) - 1).astype(np.int64) & 0xFFFFFF
    return np.stack([(q >> 16) & 0xFF, (q >> 8) & 0xFF, q & 0xFF],
                    axis=-1).astype(np.uint8)


def build_usb_packet(iq_frames: np.ndarray, seq: int = 0) -> bytes:
    """complex IQ (126 samples) -> a Metis USB packet (tests/fake device)."""
    hdr = struct.pack(">HBBI", METIS_SIGNATURE, PKT_USB, 6, seq)
    frames = b""
    x = np.asarray(iq_frames, np.complex64)
    for f in range(2):
        seg = x[f * SAMPLES_PER_FRAME : (f + 1) * SAMPLES_PER_FRAME]
        body = np.zeros((len(seg), 8), np.uint8)  # I, Q, then a 0 mic word
        body[:, 0:3] = _s24(seg.real)
        body[:, 3:6] = _s24(seg.imag)
        frame = SYNC + bytes(5) + body.tobytes()
        frames += frame.ljust(512, b"\x00")[:512]
    return hdr + frames


class HermesClient:
    """Minimal streaming client: start/stop, tune, receive IQ."""

    def __init__(self, addr: tuple[str, int]):
        self.addr = addr
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("0.0.0.0", 0))
        self._chunks: deque[np.ndarray] = deque()
        self._cv = threading.Condition()
        self._running = False
        self._seq = 0
        self._freq = 0
        self._rate_code = 0
        self._thread = None

    def start(self):
        self._running = True
        # IQ | NO_WD: without the watchdog-disable bit the gateware halts
        # the stream ~1-2 s after the last EP2 frame (we only send EP2 on
        # start/retune) — the reference always sets it (hermes.cpp:31)
        pkt = struct.pack(">HBB", METIS_SIGNATURE, PKT_CONTROL,
                          CTRL_IQ | CTRL_NO_WD) + bytes(60)
        self._sock.sendto(pkt, self.addr)
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()
        self._send_control()

    def stop(self):
        self._running = False
        pkt = struct.pack(">HBB", METIS_SIGNATURE, PKT_CONTROL, 0) + bytes(60)
        try:
            self._sock.sendto(pkt, self.addr)
        except OSError:
            pass

    def set_frequency(self, hz: float):
        self._freq = int(hz)
        self._send_control(c0=HL_REG_RX1_NCO_FREQ << 1,
                           c=self._freq.to_bytes(4, "big"))

    def set_samplerate(self, sps: int):
        self._rate_code = SAMP_RATE_CODES[sps]
        self._send_control()

    def _send_control(self, c0: int = 0, c: bytes = None):
        if c is None:
            c = bytes([self._rate_code, 0, 0, 0])
        frame = SYNC + bytes([c0]) + c
        frame = frame.ljust(512, b"\x00")
        hdr = struct.pack(">HBBI", METIS_SIGNATURE, PKT_USB, 2, self._seq)
        self._seq += 1
        self._sock.sendto(hdr + frame + frame, self.addr)

    def _rx_loop(self):
        self._sock.settimeout(0.5)
        while self._running:
            try:
                data, _ = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            iq = parse_usb_packet(data)
            if len(iq):
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
        self.stop()
        self._sock.close()
