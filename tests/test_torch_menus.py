"""sdrtpu_torch's module menus (`apps/menus.py`) against sdrtpu's, over
each package's own `Scanner`, `Recorder` and `FrequencyManager`: the
same actions give byte-equal draw lists, the same module state and the
same callbacks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import frequency_manager as jfm  # noqa: E402
from sdrtpu.apps import menus as jm  # noqa: E402
from sdrtpu.apps import recorder as jrec  # noqa: E402
from sdrtpu.apps import scanner as jsc  # noqa: E402
from sdrtpu.io import smgui as jgui  # noqa: E402
from sdrtpu_torch.apps import frequency_manager as tfm  # noqa: E402
from sdrtpu_torch.apps import menus as tm  # noqa: E402
from sdrtpu_torch.apps import recorder as trec  # noqa: E402
from sdrtpu_torch.apps import scanner as tsc  # noqa: E402
from sdrtpu_torch.io import smgui as tgui  # noqa: E402


def _drive(t_menu, j_menu, actions):
    """Render both menus through ``actions`` ((label, kind, value) or
    None for a plain frame); every frame must be byte-equal."""
    frames = []
    for a in [None] + list(actions):
        if a is None:
            out, ref = t_menu.render(), j_menu.render()
        else:
            label, kind, value = a
            out = t_menu.render(label, getattr(tgui.Elem, kind)(value))
            ref = j_menu.render(label, getattr(jgui.Elem, kind)(value))
        assert out == ref, a
        frames.append(out)
    return frames


def test_registry_sections_equal():
    regs = []
    for m in (tm, jm):
        reg = m.MenuRegistry()
        reg.register("Alpha", lambda g: g.text("a"))
        reg.register("Beta", lambda g: g.text("b"))
        regs.append(reg)
    frames = _drive(regs[0].remote(), regs[1].remote(), [])
    texts = [w.operands[0].s for w in tgui.parse_widgets(frames[0])
             if w.step == tgui.STEP_TEXT]
    assert texts == ["-- Alpha --", "a", "-- Beta --", "b"]
    regs[0].unregister("Alpha")
    assert regs[0].names == ["Beta"]


def test_scanner_menu_over_the_ports_scanner():
    kw = dict(vfo_bandwidth=200e3, level_db=-50.0)
    ts, js = tsc.Scanner(88e6, 108e6, 100e3, **kw), jsc.Scanner(
        88e6, 108e6, 100e3, **kw)
    tt, jt = [], []
    t_menu = tgui.RemoteMenu(tm.ScannerMenu(ts, on_toggle=tt.append).draw)
    j_menu = jgui.RemoteMenu(jm.ScannerMenu(js, on_toggle=jt.append).draw)
    frames = _drive(t_menu, j_menu, [
        ("##sdrtpu_scan_stop", "integer", 96_000_000),
        ("##sdrtpu_scan_interval", "integer", 50_000),
        ("##sdrtpu_scan_level", "floating", -37.5),
        ("Start##sdrtpu_scan_run", "integer", 0), None])
    assert (ts.stop_freq, ts.interval, ts.level_db) == (
        js.stop_freq, js.interval, js.level_db) == (96e6, 50e3, -37.5)
    assert tt == jt == [True]
    assert any(w.label.startswith("Stop##sdrtpu_scan_run")
               for w in tgui.parse_widgets(frames[-1]))


@pytest.mark.parametrize("recording", [False, True])
def test_recorder_menu_over_the_ports_recorder(tmp_path, recording):
    t = np.arange(4800) / 48000.0
    block = np.stack([0.8 * np.sin(2 * np.pi * 440 * t)] * 2).astype(
        np.float32)
    recs = [trec.Recorder(str(tmp_path / "t.wav"), 48000),
            jrec.Recorder(str(tmp_path / "j.wav"), 48000)]
    recs[0].push(torch.from_numpy(block))
    recs[1].push(block)
    events = {0: [], 1: []}
    states = [{"mode_id": 0, "type_id": 0, "template": "$t",
               "recording": recording, "recorder": r} for r in recs]
    menus = [mod.RecorderMenu(st, on_record=lambda i=i: events[i].append("rec"),
                              on_stop=lambda i=i: events[i].append("stop"))
             for i, (mod, st) in enumerate(zip((tm, jm), states))]
    btn = "Stop##sdrtpu_rec_btn" if recording else "Record##sdrtpu_rec_btn"
    frames = _drive(tgui.RemoteMenu(menus[0].draw),
                    jgui.RemoteMenu(menus[1].draw),
                    [("##sdrtpu_rec_fmt", "integer", 1), (btn, "integer", 0),
                     None])
    steps = [w.step for w in tgui.parse_widgets(frames[0])]
    assert (tgui.STEP_BEGIN_DISABLED in steps) == recording
    assert events[0] == events[1] == (["stop"] if recording else ["rec"])
    assert states[0]["recording"] == states[1]["recording"] != recording
    text = [w.operands[0].s for w in tgui.parse_widgets(frames[-1])
            if w.step == tgui.STEP_TEXT]
    assert text == ["     0.1 s   peak 0.800"]
    for r in recs:
        r.close()


def test_frequency_manager_menu_equal():
    fms, tunes = [], ([], [])
    for mod in (tfm, jfm):
        fm = mod.FrequencyManager()
        fm.add("General", "NOAA", mod.Bookmark(162_400_000.0, 12500.0, "nfm"))
        fm.add("General", "BBC", mod.Bookmark(93_500_000.0, 200e3, "wfm"))
        fms.append(fm)
    menus = [mod.FrequencyManagerMenu(
        fm, tune=lambda f, m, b, out=out: out.append((f, m, b)))
        for mod, fm, out in zip((tm, jm), fms, tunes)]
    frames = _drive(tgui.RemoteMenu(menus[0].draw),
                    jgui.RemoteMenu(menus[1].draw),
                    [("##sdrtpu_fm_sel", "integer", 1),
                     ("Apply##sdrtpu_fm_apply", "integer", 0)])
    combo = next(w for w in tgui.parse_widgets(frames[0])
                 if w.step == tgui.STEP_COMBO)
    assert tgui.split_combo_items(combo.operands[2].s) == ["NOAA", "BBC"]
    assert tunes[0] == tunes[1] == [(93_500_000.0, "wfm", 200e3)]


def test_radio_menu_equal():
    states, changes = [], ([], [])
    for _ in range(2):
        states.append({"mode": "wfm", "squelch_on": False,
                       "squelch_db": -50.0, "volume": 1.0, "muted": False})
    menus = [mod.RadioMenu(st, out.append)
             for mod, st, out in zip((tm, jm), states, changes)]
    frames = _drive(tgui.RemoteMenu(menus[0].draw),
                    jgui.RemoteMenu(menus[1].draw),
                    [("NFM##sdrtpu_radio_mode_nfm", "integer", 0),
                     ("Squelch##sdrtpu_radio_sq_on", "boolean", True),
                     ("##sdrtpu_radio_sq_lv", "floating", -37.5),
                     ("##sdrtpu_radio_vol", "floating", 0.5),
                     ("Mute##sdrtpu_radio_mute", "boolean", True), None])
    assert states[0] == states[1]
    assert states[0]["mode"] == "nfm" and states[0]["muted"]
    assert abs(states[0]["squelch_db"] + 37.5) < 1e-6
    assert changes[0] == changes[1] and len(changes[0]) == 5
    labels = [w.label for w in tgui.parse_widgets(frames[-1])]
    assert "##sdrtpu_radio_sq_lv" in labels
