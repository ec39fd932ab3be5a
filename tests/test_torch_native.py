"""sdrtpu_torch's native IO library (its own copy of the C++ sources,
built with g++ into build/) against sdrtpu's.

Every wire format converts bit-equal to the reference's conversion
(its native library where it builds, else its NumPy fallback: both
compute the same float32 products), both ways; the ring and the TCP
pump over loopback as the reference's tests hold them.  Every socket
and wait here has its own timeout.
"""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu import native as jn  # noqa: E402
from sdrtpu_torch import native as tn  # noqa: E402

TIMEOUT = 5.0


@pytest.fixture(scope="module")
def lib():
    lib = tn.get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain here: the port's native library "
                    "cannot be built")
    return lib


def test_built_from_the_ports_sources(lib):
    path = tn.lib_path()
    assert path.exists() and path.parent.name == "sdrtpu_torch"
    assert path.parent.parent.name == "build"
    assert tn._SRC.parent.name == "native"
    assert tn._SRC.parent.parent.name == "sdrtpu_torch"


@pytest.mark.parametrize("fmt", ["u8", "i8", "i16", "i32", "f32"])
def test_to_planar_equals_the_reference(lib, fmt):
    rng = np.random.default_rng(88)
    dtype = tn._DTYPES[fmt][0]
    if fmt == "f32":
        raw = rng.standard_normal(4002).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max, 4002, dtype=dtype,
                           endpoint=True)
    for data in (raw.tobytes(), raw):
        re_t, im_t = tn.convert_to_planar(data, fmt)
        re_j, im_j = jn.convert_to_planar(data, fmt)
        np.testing.assert_array_equal(re_t, re_j)
        np.testing.assert_array_equal(im_t, im_j)


@pytest.mark.parametrize("fmt", ["i8", "i16", "f32"])
def test_from_planar_equals_the_reference(lib, fmt):
    rng = np.random.default_rng(89)
    re = rng.uniform(-1.2, 1.2, 1024).astype(np.float32)  # clips too
    im = rng.uniform(-1.2, 1.2, 1024).astype(np.float32)
    np.testing.assert_array_equal(tn.convert_from_planar(re, im, fmt),
                                  jn.convert_from_planar(re, im, fmt))


def test_ring(lib):
    rng = np.random.default_rng(90)
    ring = tn.SpscRing(1024)
    assert ring.native
    for _ in range(50):  # wraps many times
        data = bytes(rng.integers(0, 256, 700, dtype=np.uint8))
        assert ring.write(data) == 700
        assert ring.readable == 700
        assert ring.read(700) == data
    assert ring.write(bytes(2048)) == 1024  # capacity limit
    ring.close()


def test_ring_threaded_stream(lib):
    rng = np.random.default_rng(91)
    ring = tn.SpscRing(1 << 16)
    src = bytes(rng.integers(0, 256, 1 << 21, dtype=np.uint8))
    got = bytearray()

    def producer():
        off = 0
        while off < len(src):
            off += ring.write(src[off:off + 4096])

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while len(got) < len(src) and time.monotonic() < deadline:
        got += ring.read(8192)
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert bytes(got) == src
    ring.close()


def _pair():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(TIMEOUT)
    cli = socket.create_connection(srv.getsockname(), timeout=TIMEOUT)
    conn, _ = srv.accept()
    srv.close()
    return cli, conn


def _wait(cond):
    deadline = time.monotonic() + TIMEOUT
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_pump_end_to_end(lib):
    cli, conn = _pair()
    rng = np.random.default_rng(0)
    iq = rng.integers(-30000, 30000, 4096 * 2, dtype=np.int16)
    pump = tn.NativeTcpPump(conn, fmt="i16", ring_bytes=1 << 20)
    raw = iq.tobytes()
    for i in range(0, len(raw), 777):  # recv boundaries inside samples
        cli.sendall(raw[i:i + 777])
    assert _wait(lambda: pump.available_samples == 4096)
    re, im = pump.read_planar(4096)
    want_re, want_im = jn.convert_to_planar(raw, "i16")
    np.testing.assert_array_equal(re, want_re)
    np.testing.assert_array_equal(im, want_im)
    assert pump.total_bytes == iq.nbytes and pump.dropped_bytes == 0
    assert pump.state == "running"
    cli.close()
    assert _wait(lambda: pump.state == "eof")
    pump.close()


def test_pump_overrun_drops_whole_samples(lib):
    cli, conn = _pair()
    pump = tn.NativeTcpPump(conn, fmt="i16", ring_bytes=8192)
    k = np.arange(1, 40001, dtype=np.int16)  # I = +k, Q = -k
    wire = np.empty(2 * len(k), np.int16)
    wire[0::2] = k
    wire[1::2] = -k
    raw = wire.tobytes()
    for i in range(0, len(raw), 7777):
        cli.sendall(raw[i:i + 7777])
    assert _wait(lambda: pump.total_bytes == len(raw))
    assert pump.dropped_bytes > 0 and pump.dropped_bytes % 4 == 0
    re, im = pump.read_planar(100000)
    assert len(re) > 0
    np.testing.assert_array_equal(im, -re)  # the I/Q framing survived
    pump.close()
    cli.close()


def test_no_toolchain_is_visible(monkeypatch):
    """Without the library the conversions fall back to NumPy (equal
    results) and the pump refuses; nothing falls back silently there."""
    monkeypatch.setattr(tn, "get_lib", lambda: None)
    raw = np.arange(-50, 50, dtype=np.int16)
    re, im = tn.convert_to_planar(raw.tobytes(), "i16")
    np.testing.assert_array_equal(re, raw[0::2] / np.float32(32768.0))
    assert not tn.SpscRing(64).native
    cli, conn = _pair()
    with pytest.raises(RuntimeError, match="unavailable"):
        tn.NativeTcpPump(conn)
    conn.close()
    cli.close()
