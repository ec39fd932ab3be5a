"""Uniform module control surface over SmGui — ``gui::menu`` capability
(PyTorch counterpart of ``sdrtpu/apps/menus.py``; host code).

The reference gives every module a menu panel registered through
``gui::menu.registerEntry`` (``core/src/gui/menus/``); headless builds
re-expose the source panel over the SmGui wire protocol.  This module is
the sdrtpu equivalent for ALL modules: a `MenuRegistry` of named draw
callbacks rendered into one SmGui draw list (section separators between
modules), so any SmGui client — including an actual SDR++
``sdrpp_server_source`` — gets a working remote control surface for the
scanner, recorder, frequency manager and radio, not just the source.

Every menu is a thin, stateless view over its module object: widget IDs
are namespaced (``##sdrtpu_<module>_<field>``), values are read from and
written back to the live module on each render/action round trip, the
same pattern as `apps.server.ServerMenu`.
"""

from __future__ import annotations

from typing import Callable

from ..io import smgui


class MenuRegistry:
    """Ordered name -> draw(gui) registry (``Menu::registerEntry``)."""

    def __init__(self):
        self._entries: dict[str, Callable] = {}

    def register(self, name: str, draw: Callable) -> None:
        self._entries[name] = draw

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    @property
    def names(self) -> list[str]:
        return list(self._entries)

    def draw(self, gui: smgui.SmGui) -> None:
        for name, draw in self._entries.items():
            gui.text(f"-- {name} --")
            draw(gui)

    def remote(self) -> smgui.RemoteMenu:
        return smgui.RemoteMenu(self.draw)


class ScannerMenu:
    """Scanner panel (``misc_modules/scanner`` menu equivalent)."""

    def __init__(self, scanner, on_toggle: Callable | None = None):
        self.scanner = scanner
        self.running = False
        self.on_toggle = on_toggle

    def draw(self, gui: smgui.SmGui) -> None:
        s = self.scanner
        gui.left_label("Start")
        gui.fill_width()
        _, v = gui.input_int("##sdrtpu_scan_start", int(s.start_freq), 0, 0)
        s.start_freq = float(v)
        gui.left_label("Stop")
        gui.fill_width()
        _, v = gui.input_int("##sdrtpu_scan_stop", int(s.stop_freq), 0, 0)
        s.stop_freq = float(v)
        gui.left_label("Interval")
        gui.fill_width()
        _, v = gui.input_int("##sdrtpu_scan_interval", int(s.interval), 0, 0)
        s.interval = float(v)
        gui.left_label("Level")
        gui.fill_width()
        _, lv = gui.slider_float("##sdrtpu_scan_level", float(s.level_db),
                                 -150.0, 0.0)
        s.level_db = float(lv)
        label = "Stop##sdrtpu_scan_run" if self.running else "Start##sdrtpu_scan_run"
        if gui.button(label):
            self.running = not self.running
            if self.on_toggle:
                self.on_toggle(self.running)
        gui.text(
            f"Tuned: {s.current / 1e6:.4f} MHz "
            f"({'receiving' if s.receiving else 'scanning'})"
        )


class RecorderMenu:
    """Recorder panel (``misc_modules/recorder`` menu equivalent)."""

    MODES = ["Audio", "Baseband"]
    TYPES = ["int16", "float32"]

    def __init__(self, state: dict, on_record: Callable | None = None,
                 on_stop: Callable | None = None):
        # state: mode_id, type_id, template, recording, recorder(obj|None)
        self.state = state
        self.on_record = on_record
        self.on_stop = on_stop

    def draw(self, gui: smgui.SmGui) -> None:
        st = self.state
        rec = st.get("recorder")
        if st.get("recording"):
            gui.begin_disabled()
        gui.left_label("Mode")
        gui.fill_width()
        _, st["mode_id"] = gui.combo("##sdrtpu_rec_mode",
                                     st.get("mode_id", 0), self.MODES)
        gui.left_label("Format")
        gui.fill_width()
        _, st["type_id"] = gui.combo("##sdrtpu_rec_fmt",
                                     st.get("type_id", 0), self.TYPES)
        gui.fill_width()
        _, st["template"] = gui.input_text(
            "##sdrtpu_rec_tmpl", st.get("template", "$t_$f")
        )
        if st.get("recording"):
            gui.end_disabled()
        if not st.get("recording"):
            if gui.button("Record##sdrtpu_rec_btn"):
                st["recording"] = True
                if self.on_record:
                    self.on_record()
        else:
            if gui.button("Stop##sdrtpu_rec_btn"):
                st["recording"] = False
                if self.on_stop:
                    self.on_stop()
        if rec is not None:
            secs = rec.recorded_samples / max(rec.samplerate, 1)
            gui.text(f"{secs:8.1f} s   peak {rec.peak:.3f}")
        else:
            gui.text("idle")


class FrequencyManagerMenu:
    """Bookmark panel (``misc_modules/frequency_manager`` equivalent)."""

    def __init__(self, fm, tune: Callable | None = None,
                 list_name: str = "General"):
        self.fm = fm
        self.tune = tune
        self.list_name = list_name
        self.sel = 0

    def _names(self) -> list[str]:
        lst = self.fm.lists.get(self.list_name, {})
        return list(lst)

    def draw(self, gui: smgui.SmGui) -> None:
        names = self._names() or ["(none)"]
        gui.fill_width()
        _, self.sel = gui.combo("##sdrtpu_fm_sel",
                                min(self.sel, len(names) - 1), names)
        if gui.button("Apply##sdrtpu_fm_apply") and self.tune:
            bm = self.fm.get(self.list_name, names[self.sel])
            if bm is not None:
                self.fm.apply(self.list_name, names[self.sel], self.tune)
        bm = self.fm.get(self.list_name, names[self.sel])
        if bm is not None:
            gui.text(f"{bm.frequency / 1e6:.4f} MHz  {bm.mode}  "
                     f"bw {bm.bandwidth / 1e3:.1f} k")


class RadioMenu:
    """Per-VFO radio panel (``decoder_modules/radio`` menu equivalent)."""

    MODES = ["nfm", "wfm", "am", "usb", "lsb", "dsb", "cw", "raw"]

    def __init__(self, state: dict, on_change: Callable | None = None):
        # state: mode, squelch_db, squelch_on, volume, muted
        self.state = state
        self.on_change = on_change

    def draw(self, gui: smgui.SmGui) -> None:
        st = self.state
        changed = False
        mode_id = self.MODES.index(st.get("mode", "wfm"))
        gui.columns(4, "##sdrtpu_radio_modes")
        for i, m in enumerate(self.MODES):
            if gui.radio_button(f"{m.upper()}##sdrtpu_radio_mode_{m}",
                                i == mode_id):
                if i != mode_id:
                    st["mode"] = m
                    changed = True
            gui.next_column()
        gui.columns(1, "##sdrtpu_radio_modes_end")
        ch, on = gui.checkbox("Squelch##sdrtpu_radio_sq_on",
                              st.get("squelch_on", False))
        changed |= ch
        st["squelch_on"] = on
        if on:
            gui.fill_width()
            ch, lv = gui.slider_float("##sdrtpu_radio_sq_lv",
                                      float(st.get("squelch_db", -50.0)),
                                      -100.0, 0.0)
            changed |= ch
            st["squelch_db"] = float(lv)
        gui.left_label("Volume")
        gui.fill_width()
        ch, vol = gui.slider_float("##sdrtpu_radio_vol",
                                   float(st.get("volume", 1.0)), 0.0, 2.0)
        changed |= ch
        st["volume"] = float(vol)
        ch, mut = gui.checkbox("Mute##sdrtpu_radio_mute",
                               st.get("muted", False))
        changed |= ch
        st["muted"] = mut
        if changed and self.on_change:
            self.on_change(dict(st))
