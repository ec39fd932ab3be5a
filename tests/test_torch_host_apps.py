"""sdrtpu_torch's small host helpers against sdrtpu's (host copies):
tuning policies, scheduler, bookmarks, band plans, themes, presence and
the constellation/symbol diagrams.  The same calls give equal state,
equal callbacks and byte-equal files; the diagrams take tensors."""

import datetime
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import bandplan as jbp  # noqa: E402
from sdrtpu.apps import diagrams as jdg  # noqa: E402
from sdrtpu.apps import frequency_manager as jfm  # noqa: E402
from sdrtpu.apps import presence as jpr  # noqa: E402
from sdrtpu.apps import scheduler as jsch  # noqa: E402
from sdrtpu.apps import theme as jth  # noqa: E402
from sdrtpu.apps import tuner as jtu  # noqa: E402
from sdrtpu_torch.apps import bandplan as tbp  # noqa: E402
from sdrtpu_torch.apps import diagrams as tdg  # noqa: E402
from sdrtpu_torch.apps import frequency_manager as tfm  # noqa: E402
from sdrtpu_torch.apps import presence as tpr  # noqa: E402
from sdrtpu_torch.apps import scheduler as tsch  # noqa: E402
from sdrtpu_torch.apps import theme as tth  # noqa: E402
from sdrtpu_torch.apps import tuner as ttu  # noqa: E402

RES = os.path.join(os.path.dirname(__file__), "..", "res")


def _tuner_state(mod):
    calls = {"hw": [], "vfo": []}
    st = mod.TunerState(center_freq=100e6, bandwidth=2.4e6,
                        vfo_offsets={"v": 0.0}, vfo_bandwidths={"v": 200e3},
                        tune_hw=calls["hw"].append,
                        set_vfo_offset=lambda n, o: calls["vfo"].append((n, o)))
    return st, calls


@pytest.mark.parametrize("mode,vfo,freq", [
    ("center", "v", 98.5e6), ("normal", "v", 100.5e6), ("normal", "v", 105e6),
    ("normal", "v", 95e6), ("normal", None, 99e6), ("iq_only", None, 99e6),
    ("normal", "zz", 101e6)])
def test_tuner_policies_equal(mode, vfo, freq):
    (ts, tc), (js, jc) = _tuner_state(ttu), _tuner_state(jtu)
    ttu.tune(ts, mode, vfo, freq)
    jtu.tune(js, mode, vfo, freq)
    assert tc == jc
    assert (ts.center_freq, ts.view_offset, ts.vfo_offsets) == (
        js.center_freq, js.view_offset, js.vfo_offsets)
    if vfo == "v":  # the absolute frequency is kept
        assert abs(ts.center_freq + ts.vfo_offsets["v"] - freq) < 1.0
    with pytest.raises(ValueError):
        ttu.tune(ts, "bogus", vfo, freq)


def test_scheduler_equal():
    base = datetime.datetime(2026, 8, 17, 10, 0, 0)
    fired = {"t": [], "j": []}
    scheds = {}
    for key, mod in (("t", tsch), ("j", jsch)):
        s = mod.Scheduler()
        out = fired[key]

        def boom():
            raise RuntimeError("task failed")

        s.add(mod.Task(base, lambda out=out: out.append("a")))
        s.add(mod.Task(base, lambda out=out: out.append("b"),
                       recurring_days=1))
        s.add(mod.Task(base, boom, name="bad"))
        later = base + datetime.timedelta(hours=1)
        s.add(mod.Task(base, lambda s=s, mod=mod, later=later: s.add(
            mod.Task(later, lambda: None)), name="resched"))
        counts = [s.tick(base - datetime.timedelta(seconds=1)), s.tick(base),
                  s.tick(base + datetime.timedelta(days=1))]
        scheds[key] = (counts, [(t.at, t.name, t.recurring_days, t.done)
                                for t in s.tasks])
    assert scheds["t"] == scheds["j"]
    assert scheds["t"][0] == [0, 4, 2] and fired["t"] == fired["j"] == [
        "a", "b", "b"]


def test_frequency_manager_files_equal(tmp_path):
    for key, mod in (("t", tfm), ("j", jfm)):
        fm = mod.FrequencyManager(str(tmp_path / f"{key}.json"))
        fm.add("Ham", "repeater", mod.Bookmark(145.6e6, 12500.0, "nfm"))
        fm.add("BC", "radio1", mod.Bookmark(98.5e6, 200e3, "wfm"))
        fm.add("BC", "gone", mod.Bookmark(1e6))
        fm.remove("BC", "gone")
        fm.save()
        fm.export_list("BC", str(tmp_path / f"{key}_bc.json"))
    for name in ("{}.json", "{}_bc.json"):
        assert (tmp_path / name.format("t")).read_bytes() == (
            tmp_path / name.format("j")).read_bytes()
    fm2 = tfm.FrequencyManager(str(tmp_path / "j.json"))  # the reference's
    fm2.import_list("Imported", str(tmp_path / "j_bc.json"))
    tuned = []
    fm2.apply("Imported", "radio1", lambda f, m, b: tuned.append((f, m, b)))
    assert tuned == [(98.5e6, "wfm", 200e3)]
    assert fm2.get("Ham", "repeater") == tfm.Bookmark(145.6e6, 12500.0, "nfm")


def test_bandplans_equal(tmp_path):
    plans = sorted(glob.glob(os.path.join(RES, "bandplans", "*.json")))
    assert len(plans) >= 21
    for p in plans:
        t, j = tbp.BandPlan.load(p), jbp.BandPlan.load(p)
        assert t.name == j.name
        assert [b.__dict__ for b in t.bands] == [b.__dict__ for b in j.bands]
        for f in (0.5e6, 7.05e6, 98.5e6, 145e6, 433e6):
            assert [b.name for b in t.lookup(f)] == [b.name
                                                     for b in j.lookup(f)]
    t, j = tbp.BandPlan(), jbp.BandPlan()
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (
        tmp_path / "j.json").read_bytes()
    assert [b.name for b in t.bands_in_range(87e6, 140e6)] == [
        "FM Broadcast", "Airband"]


def test_themes_equal(tmp_path):
    t, j = tth.ThemeManager(), jth.ThemeManager()
    d = os.path.join(RES, "themes")
    assert t.load_themes_from_dir(d) == j.load_themes_from_dir(d) > 0
    assert t.get_theme_names() == j.get_theme_names()
    for name in t.get_theme_names():
        assert t.apply(name).__dict__ == j.apply(name).__dict__
    assert tth.decode_color("#FF800040") == jth.decode_color("#FF800040")
    for bad in ("#FF8000", "FF800040", "#FF800040\n"):
        with pytest.raises(ValueError):
            tth.decode_color(bad)
    (tmp_path / "bad.json").write_text(json.dumps({"name": 3}))
    (tmp_path / "ok.json").write_text(json.dumps(
        {"name": "x", "author": "me", "Text": "#01020304"}))
    assert t.load_themes_from_dir(str(tmp_path)) == 1
    with pytest.raises(KeyError):
        t.apply("nope")


def test_presence_equal(tmp_path):
    for f in (98_500_000, 7_074_000, 144_500, 12.0, 2.4e9):
        assert tpr.format_frequency(f) == jpr.format_frequency(f)
    got = {"t": [], "j": []}
    pubs = {"t": tpr.PresencePublisher(sinks=[got["t"].append]),
            "j": jpr.PresencePublisher(sinks=[got["j"].append])}
    for args in [(98.5e6, "WFM", 0.0), (98.5e6, "WFM", 0.5),
                 (98.7e6, "WFM", 0.5), (98.7e6, "WFM", 2.0),
                 (14.074e6, None, 5.0)]:
        f, m, now = args
        assert pubs["t"].update(f, m, now=now) == pubs["j"].update(
            f, m, now=now)
    assert got["t"] == got["j"] and len(got["t"]) == 3
    path = tmp_path / "p.json"
    tpr.file_sink(str(path))(got["t"][0])
    assert json.loads(path.read_text()) == got["j"][0]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_diagrams_equal(as_tensor):
    rng = np.random.default_rng(0)
    pts = (np.exp(1j * (rng.integers(0, 4, 500) * np.pi / 2 + np.pi / 4))
           + 0.05 * rng.standard_normal(500)).astype(np.complex64)
    t, j = tdg.ConstellationDiagram(256), jdg.ConstellationDiagram(256)
    for chunk in (pts[:100], pts[100:100], pts[100:]):
        t.push(torch.from_numpy(chunk) if as_tensor else chunk)
        j.push(chunk)
    np.testing.assert_array_equal(t.points, j.points)
    assert t.evm() == j.evm() and 0.0 < t.evm() < 0.2
    np.testing.assert_array_equal(t.density(64), j.density(64))
    sd_t, sd_j = tdg.SymbolDiagram(128), jdg.SymbolDiagram(128)
    vals = np.array([1.0, -1.0] * 100) + 0.01 * rng.standard_normal(200)
    sd_t.push(torch.from_numpy(vals) if as_tensor else vals)
    sd_j.push(vals)
    np.testing.assert_array_equal(sd_t.values, sd_j.values)
    (ht, et), (hj, ej) = sd_t.histogram(bins=8), sd_j.histogram(bins=8)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(et, ej)
    assert ht.sum() == 128
    assert np.isnan(tdg.ConstellationDiagram().evm())


def _fake_discord(path, received):
    """A Discord IPC daemon on a unix socket: READY after the handshake,
    then it records frames until CLOSE."""
    import socket
    import struct
    import threading

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    srv.settimeout(5.0)

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        try:
            while True:
                hdr = b""
                while len(hdr) < 8:
                    c = conn.recv(8 - len(hdr))
                    if not c:
                        return
                    hdr += c
                op, length = struct.unpack("<II", hdr)
                body = b""
                while len(body) < length:
                    body += conn.recv(length - len(body))
                received.append((op, json.loads(body)))
                if op == 0:
                    ready = json.dumps({"cmd": "DISPATCH",
                                        "evt": "READY"}).encode()
                    conn.sendall(struct.pack("<II", 1, len(ready)) + ready)
                if op == 2:
                    return
        finally:
            conn.close()
            srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return t


def test_discord_ipc_frames_equal(tmp_path):
    frames = {}
    for key, mod in (("t", tpr), ("j", jpr)):
        path = str(tmp_path / f"discord-ipc-{key}")
        received = []
        t = _fake_discord(path, received)
        ipc = mod.DiscordIpc("12345", socket_path=path)
        assert mod.PresencePublisher(sinks=[ipc]).update(93.5e6, "wfm",
                                                         now=0.0)
        ipc.close()
        t.join(5.0)
        for _, payload in received:  # per-process values
            payload.get("args", {}).pop("pid", None)
            payload.pop("nonce", None)
        frames[key] = received
    assert frames["t"] == frames["j"]
    assert [op for op, _ in frames["t"]] == [0, 1, 2]
    assert frames["t"][1][1]["args"]["activity"]["details"] == "93.5MHz - wfm"
