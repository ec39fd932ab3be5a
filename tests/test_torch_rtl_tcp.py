"""sdrtpu_torch's rtl_tcp client against sdrtpu's, each against a fake
rtl_tcp server (tests/test_io_extras.py:16's): the header, the 5-byte
commands and the u8 IQ stream, converted equal to the reference's
`bytes_to_iq`.  Every socket, read and join has its own timeout."""

import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.io import net as jnet  # noqa: E402
from sdrtpu.io.rtl_tcp import RtlTcpClient as JClient  # noqa: E402
from sdrtpu_torch.io.rtl_tcp import RtlTcpClient as TClient  # noqa: E402

TIMEOUT = 5.0


class FakeRtlTcpServer:
    """Sends the header and ``data`` (u8 IQ) in uneven pieces, then
    records the commands it receives until the client goes away."""

    def __init__(self, data: bytes):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.sock.settimeout(TIMEOUT)
        self.port = self.sock.getsockname()[1]
        self.data = data
        self.commands = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        conn.settimeout(TIMEOUT)
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))  # R820T, 29 gains
        for i in range(0, len(self.data), 4099):
            conn.sendall(self.data[i:i + 4099])
        # the commands follow at once; a client that closes without
        # ending its receive thread first is seen only by this timeout
        conn.settimeout(1.0)
        try:
            while True:
                cmd = conn.recv(5)
                if len(cmd) < 5:
                    break
                self.commands.append(struct.unpack(">BI", cmd))
        except OSError:
            pass
        conn.close()
        self.sock.close()


def _receive(cls, data):
    srv = FakeRtlTcpServer(data)
    cli = cls("127.0.0.1", srv.port)
    header = (cli.tuner_type, cli.tuner_gain_count)
    cli.set_frequency(100e6)
    cli.set_sample_rate(2.4e6)
    cli.set_gain_mode(True)
    cli.set_gain(297)
    cli.set_agc_mode(False)
    cli.set_bias_tee(True)
    got = []
    deadline = time.monotonic() + TIMEOUT
    while sum(len(g) for g in got) < len(data) // 2 and (
            time.monotonic() < deadline):
        chunk = cli.read(0.2)
        if chunk is not None:
            got.append(chunk)
    deadline = time.monotonic() + TIMEOUT
    while len(srv.commands) < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    cli.close()
    srv.thread.join(TIMEOUT)
    assert not srv.thread.is_alive()
    return header, np.concatenate(got), srv.commands, cli


def test_client_equals_the_reference():
    data = np.random.default_rng(12).integers(0, 256, 60_002,
                                              dtype=np.uint8).tobytes()
    th, tiq, tcmd, tcli = _receive(TClient, data)
    jh, jiq, jcmd, _ = _receive(JClient, data)
    assert th == jh == (5, 29)
    np.testing.assert_array_equal(tiq, jiq)
    np.testing.assert_array_equal(tiq, jnet.bytes_to_iq(data, "u8"))
    assert tcmd == jcmd == [(0x01, 100_000_000), (0x02, 2_400_000),
                            (0x03, 1), (0x04, 297), (0x08, 0), (0x0E, 1)]
    assert not tcli._thread.is_alive()  # close() ended the receive thread


def test_refuses_a_non_rtl_tcp_server():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(TIMEOUT)

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"HTTP/1.0 200")
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with pytest.raises(ConnectionError):
        TClient("127.0.0.1", srv.getsockname()[1])
    t.join(TIMEOUT)
    srv.close()
