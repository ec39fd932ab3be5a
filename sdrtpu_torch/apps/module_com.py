"""Inter-module RPC registry — ``ModuleComManager`` capability (PyTorch
counterpart of ``sdrtpu/apps/module_com.py``; host code).

The reference routes cross-module calls through a named-interface
registry (``core/src/module_com.h:12-23``: ``registerInterface(module,
name, handler)`` / ``callInterface(name, code, in, out)``), used e.g. by
rigctl_server to drive the radio and recorder
(``rigctl_server/src/main.cpp:347-415``).  This is the Python analog:
handlers are ``handler(code, arg) -> result`` callables keyed by
interface name; the radio command codes mirror
``decoder_modules/radio/src/radio_interface.h``.

`RadioInterface` adapts a `Receiver` + VFO name to those codes so any
controller (rigctl, scheduler, scripts) can drive a VFO by the
reference's RPC vocabulary.  It is the reference's: it edits the VFO's
live config and then calls ``rebuild``.  `receiver_rebuild` is the
``rebuild`` that switches a port `Receiver`'s chain to that config; a
plain ``receiver.set_mode(name, cfg.mode)`` does not, because
`Receiver.set_mode` keys the outgoing chain by its config, which the
interface has already edited (ROADMAP.md, fault F7).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

# decoder_modules/radio/src/radio_interface.h command codes
RADIO_IFACE_CMD_GET_MODE = 0
RADIO_IFACE_CMD_SET_MODE = 1
RADIO_IFACE_CMD_GET_BANDWIDTH = 2
RADIO_IFACE_CMD_SET_BANDWIDTH = 3
RADIO_IFACE_CMD_GET_SQUELCH_MODE = 4
RADIO_IFACE_CMD_SET_SQUELCH_MODE = 5
RADIO_IFACE_CMD_GET_SQUELCH_LEVEL = 6
RADIO_IFACE_CMD_SET_SQUELCH_LEVEL = 7

# radio_interface.h mode ids, in the reference's order
RADIO_IFACE_MODES = ["nfm", "wfm", "am", "dsb", "usb", "cw", "lsb", "raw"]


class ModuleComManager:
    """Named-interface registry (``module_com.h``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._interfaces: dict[str, tuple[str, Callable]] = {}

    def register_interface(self, module_name: str, name: str,
                           handler: Callable) -> bool:
        with self._lock:
            if name in self._interfaces:
                return False
            self._interfaces[name] = (module_name, handler)
            return True

    def unregister_interface(self, name: str) -> bool:
        with self._lock:
            return self._interfaces.pop(name, None) is not None

    def interface_exists(self, name: str) -> bool:
        with self._lock:
            return name in self._interfaces

    def get_module_name(self, name: str) -> str | None:
        with self._lock:
            entry = self._interfaces.get(name)
            return entry[0] if entry else None

    def call_interface(self, name: str, code: int, arg=None):
        with self._lock:
            entry = self._interfaces.get(name)
        if entry is None:
            raise KeyError(f"no interface {name!r}")
        return entry[1](code, arg)


class RadioInterface:
    """radio_interface.h handler over a `Receiver` VFO.

    SETs that actually change the configuration invoke the provided
    ``rebuild`` callback (the reference swaps demod chains live the same
    way, ``radio_module.h:780-842``); no-op SETs are ignored.  The
    squelch level is a trace constant of `PowerSquelch`, so level
    changes rebuild too — amortized by the persistent compile cache.
    """

    def __init__(self, receiver, vfo_name: str, rebuild: Callable | None = None):
        self.receiver = receiver
        self.vfo_name = vfo_name
        self.rebuild = rebuild
        # the level is remembered independently of the enable flag (the
        # reference stores them as separate config fields,
        # ``radio_module.h:86-93``), so SET_LEVEL-then-enable works
        cfg = self._cfg
        self._squelch_level = (
            cfg.squelch_db if cfg.squelch_db is not None else -50.0
        )

    @property
    def _cfg(self):
        return self.receiver.frontend.vfos[self.vfo_name].cfg

    def __call__(self, code: int, arg=None):
        cfg = self._cfg
        if code == RADIO_IFACE_CMD_GET_MODE:
            return RADIO_IFACE_MODES.index(cfg.mode)
        if code == RADIO_IFACE_CMD_SET_MODE:
            mode = RADIO_IFACE_MODES[int(arg)]
            if mode != cfg.mode:
                cfg.mode = mode
                if self.rebuild:
                    self.rebuild()
            return None
        if code == RADIO_IFACE_CMD_GET_BANDWIDTH:
            return cfg.bandwidth
        if code == RADIO_IFACE_CMD_SET_BANDWIDTH:
            if cfg.bandwidth != float(arg):
                cfg.bandwidth = float(arg)
                if self.rebuild:
                    self.rebuild()
            return None
        if code == RADIO_IFACE_CMD_GET_SQUELCH_MODE:
            return cfg.squelch_db is not None
        if code == RADIO_IFACE_CMD_SET_SQUELCH_MODE:
            if bool(arg) != (cfg.squelch_db is not None):
                cfg.squelch_db = self._squelch_level if arg else None
                if self.rebuild:
                    self.rebuild()
            return None
        if code == RADIO_IFACE_CMD_GET_SQUELCH_LEVEL:
            return (
                cfg.squelch_db if cfg.squelch_db is not None
                else self._squelch_level
            )
        if code == RADIO_IFACE_CMD_SET_SQUELCH_LEVEL:
            self._squelch_level = float(arg)
            if cfg.squelch_db is not None and cfg.squelch_db != float(arg):
                cfg.squelch_db = float(arg)
                if self.rebuild:
                    self.rebuild()
            return None
        raise ValueError(f"unknown radio interface code {code}")


# the mode a retired chain is filed under in `Receiver.set_mode`'s cache
# for the moment of a switch (no caller asks for it)
_RETIRED = "retired"


def receiver_rebuild(receiver, vfo_name: str) -> Callable[[], float]:
    """A `RadioInterface` ``rebuild`` that switches ``receiver``'s VFO
    ``vfo_name`` to the config the interface has just edited.

    It remembers the mode and bandwidth the VFO's chain was built with
    and, at each call, puts them back on the live config before
    `Receiver.set_mode` to the edited mode and bandwidth, so the
    outgoing chain is cached under what it runs.  A squelch change drops
    the VFO's cached chains (the cache is keyed by mode and bandwidth
    only) and retires the outgoing one, so the new chain is built with
    the new squelch.  Returns `Receiver.set_mode`'s switch latency (s).
    Every later switch of that VFO goes through it: a direct
    `Receiver.set_mode` would leave it remembering the old chain.
    """
    built = dataclasses.replace(receiver.frontend.vfos[vfo_name].cfg)

    def rebuild() -> float:
        nonlocal built
        cache = receiver._mode_programs
        with receiver._state_lock:
            old = receiver.frontend.vfos[vfo_name]
            want = dataclasses.replace(old.cfg)
            if want.squelch_db == built.squelch_db:
                old.cfg.mode, old.cfg.bandwidth = built.mode, built.bandwidth
            else:
                for key in [k for k in cache if k[0] == vfo_name]:
                    del cache[key]
                old.cfg.mode = _RETIRED
            seconds = receiver.set_mode(vfo_name, want.mode, want.bandwidth)
            cache.pop((vfo_name, _RETIRED, old.cfg.bandwidth), None)
            built = dataclasses.replace(receiver.frontend.vfos[vfo_name].cfg)
        return seconds

    return rebuild
