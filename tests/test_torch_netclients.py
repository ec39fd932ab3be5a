"""sdrtpu_torch's SpyServer, Hermes and Spectran HTTP clients against
sdrtpu's (host copies): the same fake server feeds both packages'
clients, and the IQ, device info and control traffic are equal.  Each
socket has its own timeout."""

import json
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.io import hermes as jh  # noqa: E402
from sdrtpu.io import spectran_http as jsh  # noqa: E402
from sdrtpu.io import spyserver as jss  # noqa: E402
from sdrtpu_torch.io import hermes as th  # noqa: E402
from sdrtpu_torch.io import spectran_http as tsh  # noqa: E402
from sdrtpu_torch.io import spyserver as tss  # noqa: E402

TIMEOUT = 3.0


def _listener(kind=socket.SOCK_STREAM):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    s.settimeout(TIMEOUT)
    if kind == socket.SOCK_STREAM:
        s.listen(2)
    return s


# -- SpyServer ---------------------------------------------------------------

def _spy_messages():
    """(message type with the gain flags in its upper 16 bits, body)."""
    rng = np.random.default_rng(11)
    i16 = rng.integers(-32768, 32767, 1024, dtype=np.int16)
    u8 = rng.integers(0, 256, 512, dtype=np.uint8)
    f32 = rng.standard_normal(600).astype(np.float32)
    return [
        (tss.MSG_DEVICE_INFO, struct.pack(
            "<12I", 2, 1234, 2500000, 2000000, 4, 1, 21, 0, 1800000000, 12,
            0, 0)),
        (tss.MSG_CLIENT_SYNC, struct.pack(
            "<9I", 1, 10, 100000000, 100000000, 0, 0, 2**31, 0, 0)),
        (tss.MSG_INT16_IQ, i16.tobytes()),
        (tss.MSG_INT16_IQ | (20 << 16), i16.tobytes()),  # 20 dB digital gain
        (tss.MSG_UINT8_IQ | (6 << 16), u8.tobytes()),
        (tss.MSG_FLOAT_IQ | (3 << 16), f32.tobytes()),
        (tss.MSG_FLOAT_IQ, f32[:-1].tobytes()),  # an odd component count
    ]


# the IQ messages' samples: 2 x 512 i16, 256 u8, 300 and 299 f32
SPY_SAMPLES = 512 + 512 + 256 + 300 + 299


def _spy_serve(sock, sessions, clients):
    for _ in range(clients):
        conn, _ = sock.accept()
        conn.settimeout(TIMEOUT)
        rec = {"hello": None, "settings": []}
        sessions.append(rec)
        ctype, size = struct.unpack("<II", conn.recv(8))
        rec["hello"] = (ctype, conn.recv(size))
        for mtype, body in _spy_messages():
            conn.sendall(struct.pack("<IIIII", tss.PROTOCOL_VERSION, mtype, 0,
                                     0, len(body)) + body)
        try:
            while True:
                hdr = conn.recv(8)
                if len(hdr) < 8:
                    break
                ctype, size = struct.unpack("<II", hdr)
                body = conn.recv(size)
                if ctype == tss.CMD_SET_SETTING:
                    rec["settings"].append(struct.unpack("<II", body))
        except (socket.timeout, OSError):
            pass
        conn.close()


def _spy_session(mod, port):
    cli = mod.SpyServerClient("127.0.0.1", port)
    info = cli.wait_device_info(TIMEOUT)
    cli.set_frequency(98.5e6)
    cli.set_decimation(2)
    cli.set_gain(7)
    cli.start_stream(mod.FORMAT_INT16)
    got, deadline = [], time.time() + TIMEOUT
    while sum(len(a) for a in got) < SPY_SAMPLES and time.time() < deadline:
        x = cli.read(timeout=0.5)
        if x is not None:
            got.append(x)
    cli.stop_stream()
    time.sleep(0.2)
    sync = cli.client_sync
    cli.close()
    return info, sync, np.concatenate(got)


def test_spyserver_same_server_same_iq():
    sock = _listener()
    sessions = []
    th_ = threading.Thread(target=_spy_serve, args=(sock, sessions, 2),
                           daemon=True)
    th_.start()
    t_info, t_sync, t_iq = _spy_session(tss, sock.getsockname()[1])
    j_info, j_sync, j_iq = _spy_session(jss, sock.getsockname()[1])
    th_.join(2 * TIMEOUT + 2)
    sock.close()
    assert t_info.__dict__ == j_info.__dict__ and t_info.serial == 1234
    assert t_sync == j_sync and t_sync["device_center_frequency"] == 1e8
    np.testing.assert_array_equal(t_iq, j_iq)
    assert len(t_iq) == SPY_SAMPLES
    # each message's decode as a function of its bytes
    want = [tss.decode_iq(t & 0xFFFF, b, t >> 16)
            for t, b in _spy_messages() if t & 0xFFFF >= 100]
    np.testing.assert_array_equal(t_iq, np.concatenate(want))
    assert sessions[0]["hello"][1][4:] == b"sdrtpu"
    assert sessions[0] == sessions[1]
    assert (tss.SETTING_IQ_FREQUENCY, 98500000) in sessions[0]["settings"]
    assert sessions[0]["settings"][-1] == (tss.SETTING_STREAMING_ENABLED, 0)


def test_spyserver_digital_gain_scaling():
    """Integer formats divided by the reported gain, the float format
    multiplied by it (spyserver_client.cpp:136-160), in both packages."""
    for mtype, body in [(tss.MSG_INT16_IQ, np.int16([16384, 0]).tobytes()),
                        (tss.MSG_UINT8_IQ, np.uint8([192, 128]).tobytes()),
                        (tss.MSG_FLOAT_IQ, np.float32([0.25, 0.0]).tobytes())]:
        got = tss.decode_iq(mtype, body, 20)
        want = {tss.MSG_FLOAT_IQ: 2.5}.get(mtype, 0.05)
        assert abs(got[0].real - want) < 1e-6
        cli = jss.SpyServerClient.__new__(jss.SpyServerClient)
        cli._cv, cli._chunks = threading.Condition(), []
        cli._handle(mtype, body, 20)
        np.testing.assert_array_equal(got, cli._chunks[0])


# -- Hermes ------------------------------------------------------------------

def test_usb_packet_codec_equal():
    rng = np.random.default_rng(73)
    for n in (126, 100, 63, 1, 0):
        iq = (rng.uniform(-1.1, 1.1, n)
              + 1j * rng.uniform(-1.1, 1.1, n)).astype(np.complex64)
        pkt = th.build_usb_packet(iq, seq=n)
        assert pkt == jh.build_usb_packet(iq, seq=n)
        back = th.parse_usb_packet(pkt)
        np.testing.assert_array_equal(back, jh.parse_usb_packet(pkt))
        inside = np.clip(iq.real, -1, 1 - 2**-23) + 1j * np.clip(
            iq.imag, -1, 1 - 2**-23)
        np.testing.assert_allclose(back[:n], inside, atol=2e-7)
    assert len(th.parse_usb_packet(b"\x00" * 20)) == 0
    bad = bytearray(th.build_usb_packet(np.zeros(126, np.complex64)))
    bad[8] = 0  # first frame's sync lost: only the second decodes
    assert len(th.parse_usb_packet(bytes(bad))) == 63


def _hermes_device(dev, rounds, logs, packets):
    """Serve ``rounds`` clients in turn; each one's control traffic goes
    to a list of its own in ``logs``."""
    for _ in range(rounds):
        try:
            data, addr = dev.recvfrom(2048)
        except socket.timeout:
            return
        log = [("start", struct.unpack(">HBB", data[:4]))]
        logs.append(log)
        for p in packets:
            dev.sendto(p, addr)
        try:
            while True:
                data, _ = dev.recvfrom(2048)
                if data[2] == th.PKT_USB:
                    log.append(("usb", data[8 + 3], data[8 + 4:8 + 8]))
                elif data[3] == 0:  # stop
                    log.append(("stop",))
                    break
        except socket.timeout:
            pass


def _hermes_session(mod, addr, n):
    cli = mod.HermesClient(addr)
    cli.start()
    cli.set_samplerate(384000)
    cli.set_frequency(7.1e6)
    got, deadline = [], time.time() + TIMEOUT
    while sum(len(g) for g in got) < n and time.time() < deadline:
        x = cli.read(timeout=0.5)
        if x is not None:
            got.append(x)
    cli.close()
    return np.concatenate(got)


def test_hermes_same_device_same_iq():
    rng = np.random.default_rng(5)
    iq = (0.8 * np.exp(2j * np.pi * rng.uniform(0, 1, 126 * 6))).astype(
        np.complex64)
    packets = [th.build_usb_packet(iq[k * 126:(k + 1) * 126], seq=k)
               for k in range(6)]
    dev = _listener(socket.SOCK_DGRAM)
    logs = []
    t = threading.Thread(target=_hermes_device, args=(dev, 2, logs, packets),
                         daemon=True)
    t.start()
    addr = dev.getsockname()
    t_iq = _hermes_session(th, addr, len(iq))
    j_iq = _hermes_session(jh, addr, len(iq))
    t.join(2 * TIMEOUT + 2)
    dev.close()
    np.testing.assert_array_equal(t_iq, j_iq)
    np.testing.assert_array_equal(
        t_iq, np.concatenate([th.parse_usb_packet(p) for p in packets]))
    assert len(logs) == 2 and logs[0] == logs[1]
    log = logs[0]
    assert log[-1] == ("stop",)
    assert log[0] == ("start", (th.METIS_SIGNATURE, th.PKT_CONTROL,
                                th.CTRL_IQ | th.CTRL_NO_WD))
    # the 384 kHz rate code, then the NCO frequency register
    assert log[2] == ("usb", 0, bytes([th.SAMP_RATE_CODES[384000], 0, 0, 0]))
    assert log[3] == ("usb", th.HL_REG_RX1_NCO_FREQ << 1,
                      (7_100_000).to_bytes(4, "big"))


def test_hermes_discover_equal():
    dev = _listener(socket.SOCK_DGRAM)
    reply = (b"\xef\xfe\x02" + bytes.fromhex("00163e112233") + bytes([73, 6])
             + bytes(10) + bytes([9]) + bytes(40))

    def responder():
        for _ in range(2):
            try:
                data, addr = dev.recvfrom(1024)
            except socket.timeout:
                return
            assert data[:3] == b"\xef\xfe\x02"
            dev.sendto(reply, addr)

    t = threading.Thread(target=responder, daemon=True)
    t.start()
    port = dev.getsockname()[1]
    got_t = th.discover("127.0.0.1", port, timeout=1.5)
    got_j = jh.discover("127.0.0.1", port, timeout=1.5)
    t.join(TIMEOUT)
    dev.close()
    assert [d.__dict__ for d in got_t] == [d.__dict__ for d in got_j]
    assert got_t[0].mac == bytes.fromhex("00163e112233")
    assert (got_t[0].gateware_major, got_t[0].board_id,
            got_t[0].gateware_minor) == (73, 6, 9)


# -- Spectran HTTP -----------------------------------------------------------

CHUNK_META = (b'{"startFrequency":99000000,"endFrequency":101000000,'
              b'"sampleFrequency":2000000}\n')


def _spectran_serve(sock, puts, payloads):
    conn, _ = sock.accept()
    conn.settimeout(TIMEOUT)
    req = b""
    while b"\r\n\r\n" not in req:
        req += conn.recv(4096)
    if req.startswith(b"PUT"):
        head, body = req.split(b"\r\n\r\n", 1)
        n = int(re.search(rb"Content-Length: (\d+)", head).group(1))
        while len(body) < n:
            body += conn.recv(4096)
        puts.append(body)
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n")
        conn.close()
        return
    conn.sendall(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n")
    for p in payloads:
        body = CHUNK_META + bytes([0x1E]) + p
        conn.sendall(hex(len(body))[2:].encode() + b"\r\n" + body + b"\r\n")
    conn.sendall(b"0\r\n\r\n")
    conn.close()



def test_spectran_same_stream_same_iq():
    rng = np.random.default_rng(2)
    payloads = [rng.standard_normal(2 * n).astype(np.float32).tobytes()
                for n in (16, 1000, 7)] + [b"\x00" * 12]  # a partial sample
    results = {}
    for mod in (tsh, jsh):
        sock = _listener()
        t = threading.Thread(target=_spectran_serve,
                             args=(sock, [], payloads), daemon=True)
        t.start()
        freqs, rates = [], []
        c = mod.SpectranHttpClient("127.0.0.1", sock.getsockname()[1],
                                   on_center_freq=freqs.append,
                                   on_samplerate=rates.append)
        blocks = [c.read(timeout=TIMEOUT) for _ in payloads]
        c.close()
        t.join(TIMEOUT)
        sock.close()
        results[mod] = (blocks, freqs, rates)
    (tb, tf, tr), (jb, jf, jr) = results[tsh], results[jsh]
    assert tf == jf == [100_000_000] and tr == jr == [2_000_000]
    assert len(tb) == len(jb) == 4
    for a, b, p in zip(tb, jb, payloads):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, tsh.decode_iq(p))
    assert len(tb[3]) == 1


def test_spectran_retune_put_equal():
    bodies = {}
    for mod in (tsh, jsh):
        sock = _listener()
        puts = []
        t = threading.Thread(target=_spectran_serve,
                             args=(sock, puts, [b"\x00" * 8]), daemon=True)
        t.start()
        c = mod.SpectranHttpClient("127.0.0.1", sock.getsockname()[1])
        t.join(TIMEOUT)
        t = threading.Thread(target=_spectran_serve, args=(sock, puts, []),
                             daemon=True)
        t.start()
        c.samplerate = 2_000_000
        assert c.set_center_frequency(433_000_000) == 200
        t.join(TIMEOUT)
        c.close()
        sock.close()
        bodies[mod] = puts[0]
    assert bodies[tsh] == bodies[jsh]
    cfg = json.loads(bodies[tsh])
    assert cfg["simpleconfig"]["main"]["centerfreq"] == 433_000_000
