"""sdrtpu_torch's SDR++ server edge against sdrtpu's (host copies):
sample compression and zstd, SmGui draw lists, the server protocol, the
headless server app and the component registry.

Host copies are held to equality: the same samples give the same wire
bytes, the same widget calls the same draw lists, and each package's
client talks to the other's server with the same IQ.  The port's
`compress` also takes a tensor; its bytes are the numpy input's.
"""

import pathlib
import re
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import registry as jreg  # noqa: E402
from sdrtpu.apps import server as jserver  # noqa: E402
from sdrtpu.io import compression as jcomp  # noqa: E402
from sdrtpu.io import server_protocol as jsp  # noqa: E402
from sdrtpu.io import smgui as jgui  # noqa: E402
from sdrtpu_torch.apps import registry as treg  # noqa: E402
from sdrtpu_torch.apps import server as tserver  # noqa: E402
from sdrtpu_torch.io import compression as tcomp  # noqa: E402
from sdrtpu_torch.io import server_protocol as tsp  # noqa: E402
from sdrtpu_torch.io import smgui as tgui  # noqa: E402
from sdrtpu_torch.io import wav as twav  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TYPES = [tcomp.PCM_TYPE_I8, tcomp.PCM_TYPE_I16, tcomp.PCM_TYPE_F32]
SOCKET_TIMEOUT = 5.0


def _iq(kind, n=512, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.uniform(-0.9, 0.9, n) + 1j * rng.uniform(-0.9, 0.9, n)
    elif kind == "asymmetric":  # I strongly negative, Q small
        x = rng.uniform(-0.7, -0.3, n) + 1j * rng.uniform(-0.05, 0.05, n)
    elif kind == "gaussian":
        x = 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    else:  # zeros
        x = np.zeros(n)
    return x.astype(np.complex64)


@pytest.mark.parametrize("pcm", TYPES)
@pytest.mark.parametrize("kind", ["uniform", "asymmetric", "gaussian",
                                  "zeros"])
def test_compression_bytes_equal(kind, pcm):
    iq = _iq(kind)
    wire = tcomp.compress(iq, pcm)
    assert wire == jcomp.compress(iq, pcm)
    assert tcomp.compress(torch.from_numpy(iq), pcm) == wire
    back = tcomp.decompress(wire)
    np.testing.assert_array_equal(back, jcomp.decompress(wire))
    tol = {tcomp.PCM_TYPE_I8: 0.02, tcomp.PCM_TYPE_I16: 1e-4,
           tcomp.PCM_TYPE_F32: 0.0}[pcm] * max(np.abs(iq).max(), 1.0)
    np.testing.assert_allclose(back, iq, atol=tol + 1e-7)


needs_zstd = pytest.mark.skipif(
    not (tcomp.HAVE_ZSTD and jcomp.HAVE_ZSTD),
    reason="no zstd on this host (neither the zstandard module nor libzstd)")


@needs_zstd
def test_zstd_cross_package():
    data = (b"\x01\x02\x03\x04" * 4096) + b"tail"
    z = tcomp.zstd_compress(data, level=1)
    assert len(z) < len(data)
    assert z == jcomp.zstd_compress(data, level=1)
    assert jcomp.zstd_decompress(z) == data == tcomp.zstd_decompress(z)
    iq = _iq("gaussian", 2048, seed=3)
    payload = tcomp.compress(iq, tcomp.PCM_TYPE_I16)
    back = tcomp.decompress(tcomp.zstd_decompress(
        jcomp.zstd_compress(payload)))
    np.testing.assert_array_equal(back, jcomp.decompress(payload))


def test_ctypes_zstd_directly():
    try:
        ctz = tcomp._CtypesZstd()
    except OSError as e:
        pytest.skip(f"no libzstd on this host: {e}")
    data = b"sdrtpu " * 999 + b"\x00\xff"
    z = ctz.compress(data, level=1)
    assert ctz.decompress(z) == data
    assert jcomp._CtypesZstd().decompress(z) == data
    # a frame declaring a huge content size is refused before allocation
    forged = struct.pack("<IBQ", 0xFD2FB528, 0xE0, 1 << 42) + b"x" * 9
    with pytest.raises(RuntimeError):
        ctz.decompress(forged)


# -- SmGui draw lists --------------------------------------------------------

def _every_widget(gui, state):
    """One pass over every recorder call, reading and writing ``state``."""
    gui.begin_disabled()
    gui.fill_width()
    gui.force_sync()
    _, state["src"] = gui.combo("##src", state["src"], ["File", "Net", "Ü"])
    gui.end_disabled()
    gui.same_line()
    gui.columns(3, "##cols", True)
    gui.next_column()
    gui.left_label("Path")
    ch, state["path"] = gui.input_text("##path", state["path"])
    state["path_changed"] |= ch
    if gui.button("Refresh##btn", 10.0, 2.5):
        state["refreshed"] = True
    if gui.radio_button("AM##r", state["src"] == 1):
        state["radio"] = True
    _, state["loop"] = gui.checkbox("Loop##cb", state["loop"])
    _, state["gain"] = gui.slider_int("##gain", state["gain"], 0, 49)
    _, state["lvl"] = gui.slider_float("##lvl", state["lvl"], -100.0, 0.0,
                                       tgui.FMT_FLOAT_DB_ONE_DECIMAL)
    _, state["step"] = gui.slider_float_with_steps("##st", state["step"],
                                                   0.0, 10.0, 0.5)
    _, state["port"] = gui.input_int("##port", state["port"], 1, 100)
    gui.text("hello")
    gui.text_colored((1.0, 0.5, 0.25, 1.0), "warn")
    gui.set_next_item_width(120.0)
    gui.open_popup("##pop")
    if gui.begin_popup("##pop"):
        gui.end_popup()
    if gui.begin_table("##tab", 2, 1, 1.0, 2.0, 3.0):
        gui.table_next_row(0, 1.5)
        gui.table_set_column_index(1)
        gui.end_table()
    gui.begin_group()
    gui.end_group()


def _state():
    return {"src": 0, "path": "/tmp/x.wav", "path_changed": False,
            "refreshed": False, "radio": False, "loop": True, "gain": 20,
            "lvl": -50.0, "step": 1.0, "port": 4950}


ACTIONS = [("", None), ("##src", "integer", 2), ("##path", "string", "/c.wav"),
           ("Refresh##btn", "integer", 0), ("AM##r", "integer", 0),
           ("Loop##cb", "boolean", False), ("##gain", "integer", 33),
           ("##lvl", "floating", -37.5), ("##st", "floating", 2.5),
           ("##port", "integer", 5259)]


def test_draw_lists_byte_equal():
    ts, js = _state(), _state()
    tmenu = tgui.RemoteMenu(lambda g: _every_widget(g, ts))
    jmenu = jgui.RemoteMenu(lambda g: _every_widget(g, js))
    for action in ACTIONS:
        if action[0]:
            label, kind, value = action
            tv, jv = (getattr(tgui.Elem, kind)(value),
                      getattr(jgui.Elem, kind)(value))
        else:
            label, tv, jv = "", None, None
        out = tmenu.render(label, tv)
        assert out == jmenu.render(label, jv), label
        assert ts == js, label
        tw, jw = tgui.parse_widgets(out), jgui.parse_widgets(out)
        assert [(w.step, w.label, [tgui.store_item(e) for e in w.operands])
                for w in tw] == [
            (w.step, w.label, [jgui.store_item(e) for e in w.operands])
            for w in jw]
    assert ts["src"] == 2 and ts["path"] == "/c.wav" and ts["refreshed"]
    assert ts["radio"] and ts["loop"] is False and ts["gain"] == 33
    # the wire layout (smgui.cpp:304-342)
    assert tgui.store_item(tgui.Elem.string("ab")) == b"\x04\x02\x00ab"
    assert tgui.load_list(jgui.store_list([jgui.Elem.integer(-42)]))[0].i == -42


def test_server_menu_equal():
    for running in (False, True):
        st = {"source_id": 0, "path": "/a.wav", "samplerate": 2.4e6,
              "running": running}
        jst = dict(st)
        tm = tgui.RemoteMenu(tserver.ServerMenu(st).draw)
        jm = jgui.RemoteMenu(jserver.ServerMenu(jst).draw)
        assert tm.render() == jm.render()
        out = tm.render("##sdrtpu_server_src_sel", tgui.Elem.integer(1))
        assert out == jm.render("##sdrtpu_server_src_sel",
                                jgui.Elem.integer(1))
        assert st == jst and st["source_id"] == 1
        labels = [w.label for w in tgui.parse_widgets(out)]
        assert "##sdrtpu_net_port" in labels and "##sdrtpu_net_fmt" in labels


# -- the server protocol -----------------------------------------------------

def _wait(cond, timeout=SOCKET_TIMEOUT):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("server_pkg,client_pkg", [
    (tsp, tsp), (tsp, jsp), (jsp, tsp)],
    ids=["port-port", "port-server-reference-client",
         "reference-server-port-client"])
def test_session_and_interop(server_pkg, client_pkg):
    """Samplerate, tune, sample type, START/STOP and baseband between the
    packages: the IQ each client decodes is the same."""
    tuned = []
    server = server_pkg.SdrppServer("127.0.0.1", 0, samplerate=2_400_000.0,
                                    tune_callback=tuned.append)
    client = client_pkg.SdrppClient("127.0.0.1", server.port)
    client._sock.settimeout(SOCKET_TIMEOUT)
    try:
        assert client.get_samplerate() == 2_400_000.0
        client.set_frequency(98.5e6)
        iq = _iq("uniform", 2048, seed=9)
        for pcm in (tcomp.PCM_TYPE_I16, tcomp.PCM_TYPE_I8,
                    tcomp.PCM_TYPE_F32):
            client.set_sample_type(pcm)
            client.start()
            assert _wait(lambda: server.running and server.sample_type == pcm)
            server.send_baseband(torch.from_numpy(iq) if server_pkg is tsp
                                 else iq)
            back = client.recv_baseband(timeout=SOCKET_TIMEOUT)
            want = jcomp.decompress(jcomp.compress(iq, pcm))
            np.testing.assert_array_equal(back, want)
        assert tuned == [98.5e6]
        client.stop()
        assert _wait(lambda: not server.running)
    finally:
        client.close()
        server.close()


@needs_zstd
@pytest.mark.parametrize("server_pkg,client_pkg", [(tsp, jsp), (jsp, tsp)],
                         ids=["port-server", "reference-server"])
def test_compressed_session_interop(server_pkg, client_pkg):
    server = server_pkg.SdrppServer("127.0.0.1", 0, samplerate=1e6)
    client = client_pkg.SdrppClient("127.0.0.1", server.port)
    try:
        client.set_sample_type(tcomp.PCM_TYPE_I16)
        client.set_compression(True)
        client.start()
        assert _wait(lambda: server.running and server.use_compression)
        iq = _iq("gaussian", 4096, seed=5)
        server.send_baseband(iq)
        back = client.recv_baseband(timeout=SOCKET_TIMEOUT)
        np.testing.assert_array_equal(
            back, jcomp.decompress(jcomp.compress(iq, tcomp.PCM_TYPE_I16)))
    finally:
        client.close()
        server.close()


def test_compression_refused_without_zstd(monkeypatch):
    """Where no zstd is available the port's server answers a request for
    compression with an error and keeps it off, and the port's client
    refuses to ask."""
    monkeypatch.setattr(tcomp, "HAVE_ZSTD", False)
    server = tsp.SdrppServer("127.0.0.1", 0, samplerate=1e6)
    client = tsp.SdrppClient("127.0.0.1", server.port)
    try:
        with pytest.raises(RuntimeError):
            client.set_compression(True)
        client._command(tsp.CMD_SET_COMPRESSION, bytes([1]))
        client._sock.settimeout(SOCKET_TIMEOUT)
        errors = []
        while not errors:
            ptype, payload = client.recv()
            if ptype == tsp.PKT_ERROR:
                errors.append(struct.unpack("<I", payload[:4])[0])
        assert errors == [tsp.ERR_NO_COMPRESSION]
        assert not server.use_compression
        with pytest.raises(RuntimeError):
            client._absorb(tsp.PKT_ERROR,
                           struct.pack("<I", tsp.ERR_NO_COMPRESSION))
    finally:
        client.close()
        server.close()


def test_remote_ui_session():
    state = {"mode": 0, "gain": 20.0}

    def draw(gui):
        _, state["mode"] = gui.combo("##mode", state["mode"],
                                     ["wfm", "nfm", "am"])
        _, state["gain"] = gui.slider_float("##gain", state["gain"], 0.0,
                                            50.0)

    server = tsp.SdrppServer("127.0.0.1", 0, samplerate=48000.0,
                             menu=tgui.RemoteMenu(draw))
    try:
        for pkg in (tsp, jsp):  # the port's client, then the reference's
            gui = tgui if pkg is tsp else jgui
            cli = pkg.SdrppClient("127.0.0.1", server.port)
            widgets = cli.get_ui()
            assert [w.label for w in widgets] == ["##mode", "##gain"]
            widgets = cli.ui_action("##mode", gui.Elem.integer(2))
            assert state["mode"] == 2
            combo = next(w for w in widgets if w.step == gui.STEP_COMBO)
            assert combo.operands[1].i == 2
            cli.ui_action("##gain", gui.Elem.floating(35.0), sendback=False)
            assert _wait(lambda: state["gain"] == np.float32(35.0))
            cli.close()
            assert _wait(lambda: server._client is None)
            state.update(mode=0, gain=20.0)
    finally:
        server.close()


def test_server_app_file_session(tmp_path):
    """``python -m sdrtpu_torch.apps.server`` serves a capture looped
    without a seam: each block is the looped capture's next block,
    compressed, whole captures and partial blocks alike."""
    fs, n, block = 100_000, 10_000, 4096  # blocks cross the capture's end
    t = np.arange(n) / fs
    iq = (0.5 * np.exp(2j * np.pi * 10_000.0 * t)).astype(np.complex64)
    path = str(tmp_path / "cap.wav")
    twav.write_iq_wav(path, fs, iq, "float32")
    _, cap = twav.read_iq_wav(path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrtpu_torch.apps.server", "--input", path,
         "--port", "0", "--addr", "127.0.0.1", "--block", str(block),
         "--max-seconds", "20"],
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        port = None
        deadline = time.time() + 15.0
        while port is None and time.time() < deadline:
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)",
                          proc.stderr.readline())
            port = int(m.group(1)) if m else None
        assert port, "the server did not start"
        cli = tsp.SdrppClient("127.0.0.1", port)
        assert cli.get_samplerate() == fs
        cli.start()
        got = [cli.recv_baseband(timeout=SOCKET_TIMEOUT) for _ in range(6)]
        cli.stop()
        cli.close()
    finally:
        proc.kill()
        proc.wait(10)
        proc.stderr.close()
    looped = np.tile(cap, 4)
    for k, b in enumerate(got):
        want = tcomp.decompress(tcomp.compress(
            looped[k * block:(k + 1) * block], tcomp.PCM_TYPE_I16))
        np.testing.assert_array_equal(b, want, err_msg=f"block {k}")
    spec = np.abs(np.fft.fft(got[0]))
    assert abs(np.fft.fftfreq(block, 1 / fs)[np.argmax(spec)] - 1e4) < 50


# -- the registry ------------------------------------------------------------

def test_registry_semantics_equal():
    for mod in (treg, jreg):
        r = mod.Registry()
        r.register("thing", "misc", lambda x: x * 2, max_instances=1)
        assert r.names("misc") == ["thing"]
        assert r.create("thing", 21) == 42
        with pytest.raises(RuntimeError):
            r.create("thing", 1)
        r.release("thing")
        assert r.create("thing", 2) == 4
        with pytest.raises(ValueError):
            r.register("thing", "misc", int)


def test_default_registry_holds_the_ports_classes():
    t, j = treg.default_registry(), jreg.default_registry()
    assert t.names() == j.names()
    for kind in ("source", "sink", "decoder", "misc"):
        assert t.names(kind) == j.names(kind)
    for name in t.names():
        factory = t._entries[name].factory
        assert factory.__module__.startswith("sdrtpu_torch."), (name, factory)
        assert factory.__name__ == j._entries[name].factory.__name__
    assert t.load_entry_points() == 0  # no port plugin is installed


def test_listener_refuses_second_client():
    server = tsp.SdrppServer("127.0.0.1", 0, samplerate=1e6)
    try:
        a = tsp.SdrppClient("127.0.0.1", server.port)
        assert a.get_samplerate() == 1e6
        b = socket.create_connection(("127.0.0.1", server.port))
        b.settimeout(SOCKET_TIMEOUT)
        assert b.recv(64) == b""  # closed at once
        b.close()
        a.close()
    finally:
        server.close()
