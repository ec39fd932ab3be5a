"""Hamlib rigctl TCP client + panadapter sync (PyTorch counterpart of
``sdrtpu/apps/rigctl_client.py``; host code).

Parity targets:
- ``core/src/utils/proto/rigctl.{h,cpp}`` — the NET-rigctl text protocol
  client (``F <hz>`` / ``f`` with ``RPRT <n>`` acknowledgements).
- ``misc_modules/rigctl_client`` — panadapter mode: the SDR hardware is
  parked on a transceiver's fixed IF output while every app retune is
  forwarded to the rig over rigctl (``rigctl_client/src/main.cpp:75-108``,
  retune forwarding at ``main.cpp:162-168``).
"""

from __future__ import annotations

import socket
import threading
from typing import Callable


class RigctlProtocolClient:
    """Blocking line-oriented rigctl protocol client."""

    def __init__(self, host: str, port: int = 4532, timeout: float = 5.0):
        self._sock = socket.create_connection((host, int(port)), timeout=timeout)
        self._file = self._sock.makefile("rwb")
        self._lock = threading.Lock()

    def _cmd(self, line: str) -> str:
        with self._lock:
            self._file.write(line.encode() + b"\n")
            self._file.flush()
            resp = self._file.readline()
        if not resp:
            raise ConnectionError("rigctl server closed connection")
        return resp.decode().strip()

    def set_freq(self, freq: float) -> int:
        """Returns the RPRT code (0 = ok), like ``rigctl.cpp`` setFreq."""
        resp = self._cmd(f"F {freq:.0f}")
        return int(resp.split(" ")[1]) if resp.startswith("RPRT") else -1

    def get_freq(self) -> float:
        resp = self._cmd("f")
        return float(resp)

    @property
    def is_open(self) -> bool:
        return self._sock.fileno() >= 0

    def close(self):
        try:
            self._file.close()
        finally:
            self._sock.close()


class RigctlClient:
    """Panadapter-mode rig sync (``misc_modules/rigctl_client``).

    While running, the SDR front end is pinned to ``if_freq`` (the rig's
    IF tap) via ``tune_hw`` and every ``tune(freq)`` request is forwarded
    to the transceiver instead.  ``stop()`` restores normal tuning.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 4532,
        if_freq: float = 8_830_000.0,  # main.cpp:179 default
        tune_hw: Callable[[float], None] | None = None,
    ):
        self.host, self.port = host, int(port)
        self.if_freq = float(if_freq)
        self.tune_hw = tune_hw or (lambda f: None)
        self.client: RigctlProtocolClient | None = None
        self.running = False

    def start(self):
        if self.running:
            return
        self.client = RigctlProtocolClient(self.host, self.port)
        self.tune_hw(self.if_freq)  # setPanadapterIF (main.cpp:89-90)
        self.running = True

    def stop(self):
        if not self.running:
            return
        self.running = False
        if self.client:
            self.client.close()
            self.client = None

    def set_if_freq(self, if_freq: float):
        self.if_freq = float(if_freq)
        if self.running:
            self.tune_hw(self.if_freq)

    def tune(self, freq: float) -> int:
        """Forward a retune to the rig; SDR stays on the IF (main.cpp:162-168)."""
        if not (self.running and self.client):
            return -1
        return self.client.set_freq(freq)
