"""sdrtpu_torch's rigctl server and client against sdrtpu's (host
copies): the same commands give the same replies and callbacks, over
loopback TCP and through `handle_command`; each package's client talks
to the other's server.  Each socket has its own timeout."""

import socket
import time

import pytest

pytest.importorskip("torch")

from sdrtpu.apps import rigctl_client as jcl  # noqa: E402
from sdrtpu.apps import rigctl_server as jsv  # noqa: E402
from sdrtpu_torch.apps import rigctl_client as tcl  # noqa: E402
from sdrtpu_torch.apps import rigctl_server as tsv  # noqa: E402

TIMEOUT = 5.0

COMMANDS = ["f", "F 145600000", "f", "\\get_freq", "\\set_freq 7074000",
            "m", "M ?", "M FM 12500", "m", "M USB -1", "m", "M USB",
            "M XXX 1000", "M USB 1e3", "M LSB --5", "v", "V VFO", "V ?",
            "V VFOB", "V", "\\chk_vfo", "s", "S 0 VFOA", "AOS", "LOS",
            "\\recorder_start", "\\recorder_stop", "\\dump_state", "fF",
            "F", "F abc", "", "xyz", "q"]


def _server(mod):
    state = {"freq": 100e6, "rec": [], "mode": "wfm", "bw": 150000.0}
    srv = mod.RigctlServer(
        "127.0.0.1", 0,
        get_freq=lambda: state["freq"],
        set_freq=lambda f: state.update(freq=f),
        start_recorder=lambda: state["rec"].append("start"),
        stop_recorder=lambda: state["rec"].append("stop"),
        get_mode=lambda: state["mode"],
        set_mode=lambda m: state.update(mode=m),
        get_bandwidth=lambda: state["bw"],
        set_bandwidth=lambda b: state.update(bw=b))
    return srv, state


def test_handle_command_equal():
    (ts, tst), (js, jst) = _server(tsv), _server(jsv)
    try:
        for cmd in COMMANDS:
            assert ts.handle_command(cmd) == js.handle_command(cmd), cmd
            assert tst == jst, cmd
        assert tst["freq"] == 7074000.0 and tst["rec"] == ["start", "stop"] * 2
        assert tst["mode"] == "usb" and tst["bw"] == 12500.0
        assert tsv.DUMP_STATE == jsv.DUMP_STATE
    finally:
        ts.close()
        js.close()


def _talk(port, lines):
    s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    out = []
    for line in lines:
        s.sendall(line.encode() + b"\n")
        want = {"\\dump_state": jsv.DUMP_STATE.count("\n"), "m": 2,
                "s": 2, "fF 145600000": 2}.get(line, 1)
        buf = b""
        while buf.count(b"\n") < want:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
        out.append(buf)
    s.sendall(b"q\n")
    assert s.recv(64) == b""  # the server closes on q
    s.close()
    return out


def test_over_tcp_equal():
    lines = ["F 145600000", "f", "M AM 8000", "m", "AOS", "LOS", "s",
             "\\dump_state", "fF 145600000"]
    (ts, tst), (js, jst) = _server(tsv), _server(jsv)
    try:
        assert _talk(ts.port, lines) == _talk(js.port, lines)
        assert tst == jst and tst["freq"] == 145600000.0
        assert tst["mode"] == "am" and tst["bw"] == 8000.0
    finally:
        ts.close()
        js.close()


@pytest.mark.parametrize("server_mod,client_mod", [(tsv, tcl), (jsv, tcl),
                                                   (tsv, jcl)],
                         ids=["port-port", "reference-server",
                              "reference-client"])
def test_panadapter_client(server_mod, client_mod):
    rig = []
    srv = server_mod.RigctlServer(port=0, set_freq=rig.append,
                                  get_freq=lambda: 7074000.0)
    hw = []
    cli = client_mod.RigctlClient(port=srv.port, if_freq=8_830_000.0,
                                  tune_hw=hw.append)
    try:
        assert cli.tune(14_200_000.0) == -1  # not running: not forwarded
        cli.start()
        cli.start()  # idempotent
        assert hw == [8_830_000.0]  # the SDR parked on the rig's IF
        assert cli.tune(14_200_000.0) == 0
        assert cli.tune(7_074_000.0) == 0
        deadline = time.time() + TIMEOUT
        while len(rig) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert rig == [14_200_000.0, 7_074_000.0]
        assert cli.client.get_freq() == pytest.approx(7_074_000.0)
        assert cli.client.is_open
        cli.set_if_freq(10_700_000.0)
        assert hw == [8_830_000.0, 10_700_000.0]
        cli.stop()
        assert cli.client is None and cli.tune(1.0) == -1
    finally:
        cli.stop()
        srv.close()
