"""sdrtpu_torch's network IQ ingest and egress against sdrtpu's.

The wire conversions equal the reference's `iq_to_bytes` / `bytes_to_iq`
bit for bit, tensor input included; exporter -> source over loopback,
through the native pump and through the Python reader, delivers every
sample equal to the reference's `bytes_to_iq` of the bytes sent, and
the source records which reader served each connection and what the
pump dropped.  Every socket, read and join here has its own timeout.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.io import net as jnet  # noqa: E402
from sdrtpu_torch import native as tn  # noqa: E402
from sdrtpu_torch.io import net as tnet  # noqa: E402

TIMEOUT = 5.0


def _iq(n, seed=77, peak=1.1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-peak, peak, n) + 1j * rng.uniform(-peak, peak, n)
            ).astype(np.complex64)


@pytest.mark.parametrize("fmt", ["u8", "i8", "i16", "i32", "f32"])
def test_formats_equal(fmt):
    # past full scale the integer formats clip; i32's bound does not fit
    # float32, so its samples stay inside it
    iq = _iq(1000, peak=0.99 if fmt == "i32" else 1.1)
    wire = tnet.iq_to_bytes(iq, fmt)
    assert wire == jnet.iq_to_bytes(iq, fmt)
    assert tnet.iq_to_bytes(torch.as_tensor(iq), fmt) == wire
    np.testing.assert_array_equal(tnet.bytes_to_iq(wire, fmt),
                                  jnet.bytes_to_iq(wire, fmt))


def _collect(src, n):
    got = []
    deadline = time.monotonic() + TIMEOUT
    while sum(len(g) for g in got) < n and time.monotonic() < deadline:
        chunk = src.read(timeout=0.2)
        if chunk is not None:
            got.append(chunk)
    return np.concatenate(got) if got else np.zeros(0, np.complex64)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("fmt", ["i16", "u8", "f32"])
def test_exporter_to_source(native, fmt):
    if native and tn.get_lib() is None:
        pytest.skip("no C++ toolchain here for the native pump")
    src = tnet.NetworkSource("tcp", "127.0.0.1", 0, fmt=fmt, native=native)
    exp = tnet.IqExporter("tcp-client", "127.0.0.1", src.port, fmt=fmt)
    iq = _iq(50_000, seed=5)
    wire = jnet.iq_to_bytes(iq, fmt)
    for i in range(0, len(iq), 7001):  # uneven sends
        exp.send(iq[i:i + 7001])
    back = _collect(src, len(iq))
    exp.close()
    np.testing.assert_array_equal(back, jnet.bytes_to_iq(wire, fmt))
    deadline = time.monotonic() + TIMEOUT
    while src.backlog_samples and time.monotonic() < deadline:
        time.sleep(0.01)
    assert src.readers == ["native" if native else "python"]
    assert src.dropped_bytes == 0 and src.backlog_samples == 0
    src.close(timeout=TIMEOUT)
    assert not src._thread.is_alive()


def test_reconnect_and_udp():
    """A second connection is served too (and recorded); UDP datagrams
    are trimmed to whole samples."""
    src = tnet.NetworkSource("tcp", "127.0.0.1", 0)
    for k in range(2):
        exp = tnet.IqExporter("tcp-client", "127.0.0.1", src.port)
        iq = _iq(3000, seed=k)
        exp.send(iq)
        np.testing.assert_array_equal(
            _collect(src, len(iq)),
            jnet.bytes_to_iq(jnet.iq_to_bytes(iq, "i16"), "i16"))
        exp.close()
        deadline = time.monotonic() + TIMEOUT
        while len(src.readers) <= k and time.monotonic() < deadline:
            time.sleep(0.01)
    assert len(src.readers) == 2
    src.close(timeout=TIMEOUT)

    usrc = tnet.NetworkSource("udp", "127.0.0.1", 0)
    uexp = tnet.IqExporter("udp", "127.0.0.1", usrc.port)
    iq = _iq(256, seed=9)  # 1024 bytes: one datagram
    uexp.send(iq)
    np.testing.assert_array_equal(
        _collect(usrc, len(iq)),
        jnet.bytes_to_iq(jnet.iq_to_bytes(iq, "i16"), "i16"))
    uexp.close()
    usrc.close(timeout=TIMEOUT)
    assert not usrc._thread.is_alive()


def test_server_exporter():
    """``tcp-server`` mode: a client connecting in gets what is sent
    after it connected."""
    import socket

    exp = tnet.IqExporter("tcp-server", "127.0.0.1", 0)
    cli = socket.create_connection(("127.0.0.1", exp.port), timeout=TIMEOUT)
    deadline = time.monotonic() + TIMEOUT
    while exp._conn is None and time.monotonic() < deadline:
        time.sleep(0.01)
    iq = _iq(500, seed=3)
    exp.send(iq)
    want = jnet.iq_to_bytes(iq, "i16")
    got = b""
    while len(got) < len(want):
        got += cli.recv(65536)
    assert got == want
    cli.close()
    exp.close(timeout=TIMEOUT)
    assert not exp._accept_thread.is_alive()
