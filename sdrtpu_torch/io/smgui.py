"""SmGui remote-UI draw lists — wire parity with the SDR++ headless
server (PyTorch counterpart of ``sdrtpu/io/smgui.py``; host code).

The reference's headless server has no local GUI; instead every module
menu is "drawn" into a serialized draw list (``core/src/gui/smgui.h:8-58``,
``smgui.cpp`` ``DrawList::{storeItem,loadItem,draw}``) that the client
(``sdrpp_server_source``) replays through real ImGui.  User interactions
come back as *diffs* — ``(widget label, new value)`` pairs — which the
server applies on the next render pass (``server.cpp:249-300`` UI_ACTION
handling, ``renderUI`` ``server.cpp:321-343``).

This module implements both directions in Python:

- :class:`SmGui` — the server-side recorder.  A menu callback draws
  widgets through it each pass; widget calls record draw-list elements
  AND report whether the pending diff targeted them (exactly the
  ``serverMode`` branch of every ``SmGui::*`` widget in ``smgui.cpp``).
- :func:`store_list` / :func:`load_list` — the byte format
  (``smgui.cpp`` ``storeItem``/``loadItem``): little-endian, strings
  u16-length-prefixed, combo item lists NUL-separated
  (``ImStrToString``).

An actual SDR++ client connected to :class:`~sdrtpu_torch.io.server_protocol.
SdrppServer` therefore gets a live, interactive source menu.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Sequence

# DrawListElemType (smgui.h:43-49)
ELEM_DRAW_STEP = 0
ELEM_BOOL = 1
ELEM_INT = 2
ELEM_FLOAT = 3
ELEM_STRING = 4

# DrawStep (smgui.h:9-41)
STEP_FILL_WIDTH = 0x00
STEP_SAME_LINE = 0x01
STEP_BEGIN_DISABLED = 0x02
STEP_END_DISABLED = 0x03
STEP_COMBO = 0x80
STEP_BUTTON = 0x81
STEP_COLUMNS = 0x82
STEP_NEXT_COLUMN = 0x83
STEP_RADIO_BUTTON = 0x84
STEP_BEGIN_GROUP = 0x85
STEP_END_GROUP = 0x86
STEP_LEFT_LABEL = 0x87
STEP_SLIDER_INT = 0x88
STEP_SLIDER_FLOAT_WITH_STEPS = 0x89
STEP_INPUT_INT = 0x8A
STEP_CHECKBOX = 0x8B
STEP_SLIDER_FLOAT = 0x8C
STEP_INPUT_TEXT = 0x8D
STEP_TEXT = 0x8E
STEP_TEXT_COLORED = 0x8F
STEP_OPEN_POPUP = 0x90
STEP_BEGIN_POPUP = 0x91
STEP_END_POPUP = 0x92
STEP_BEGIN_TABLE = 0x93
STEP_END_TABLE = 0x94
STEP_TABLE_NEXT_ROW = 0x95
STEP_TABLE_SET_COLUMN_INDEX = 0x96
STEP_SET_NEXT_ITEM_WIDTH = 0x97

# FormatString (smgui.h:61-74)
FMT_NONE = 0
FMT_INT_DEFAULT = 1
FMT_INT_DB = 2
FMT_FLOAT_DEFAULT = 3
FMT_FLOAT_NO_DECIMAL = 4
FMT_FLOAT_ONE_DECIMAL = 5
FMT_FLOAT_TWO_DECIMAL = 6
FMT_FLOAT_THREE_DECIMAL = 7
FMT_FLOAT_DB_NO_DECIMAL = 8
FMT_FLOAT_DB_ONE_DECIMAL = 9
FMT_FLOAT_DB_TWO_DECIMAL = 10
FMT_FLOAT_DB_THREE_DECIMAL = 11


@dataclass
class Elem:
    """One draw-list element (``SmGui::DrawListElem``, smgui.h:52-59)."""

    type: int
    step: int = 0
    force_sync: bool = False
    b: bool = False
    i: int = 0
    f: float = 0.0
    s: str = ""

    @staticmethod
    def string(s: str) -> "Elem":
        return Elem(ELEM_STRING, s=s)

    @staticmethod
    def integer(i: int) -> "Elem":
        return Elem(ELEM_INT, i=i)

    @staticmethod
    def floating(f: float) -> "Elem":
        return Elem(ELEM_FLOAT, f=f)

    @staticmethod
    def boolean(b: bool) -> "Elem":
        return Elem(ELEM_BOOL, b=b)


def store_item(e: Elem) -> bytes:
    """Serialize one element (``DrawList::storeItem`` smgui.cpp:304-342)."""
    if e.type == ELEM_DRAW_STEP:
        return struct.pack("<BBB", ELEM_DRAW_STEP, e.step, int(e.force_sync))
    if e.type == ELEM_BOOL:
        return struct.pack("<BB", ELEM_BOOL, int(e.b))
    if e.type == ELEM_INT:
        return struct.pack("<Bi", ELEM_INT, int(e.i))
    if e.type == ELEM_FLOAT:
        return struct.pack("<Bf", ELEM_FLOAT, float(e.f))
    if e.type == ELEM_STRING:
        raw = e.s.encode("utf-8", "replace")
        return struct.pack("<BH", ELEM_STRING, len(raw)) + raw
    raise ValueError(f"bad element type {e.type}")


def load_item(data: bytes, off: int = 0) -> tuple[Elem, int]:
    """Deserialize one element; returns (elem, next offset)."""
    t = data[off]
    off += 1
    if t == ELEM_DRAW_STEP:
        return Elem(t, step=data[off], force_sync=bool(data[off + 1])), off + 2
    if t == ELEM_BOOL:
        return Elem(t, b=bool(data[off])), off + 1
    if t == ELEM_INT:
        return Elem(t, i=struct.unpack_from("<i", data, off)[0]), off + 4
    if t == ELEM_FLOAT:
        return Elem(t, f=struct.unpack_from("<f", data, off)[0]), off + 4
    if t == ELEM_STRING:
        (n,) = struct.unpack_from("<H", data, off)
        off += 2
        return Elem(t, s=data[off : off + n].decode("utf-8", "replace")), off + n
    raise ValueError(f"bad element type {t}")


def store_list(elems: Sequence[Elem]) -> bytes:
    return b"".join(store_item(e) for e in elems)


def load_list(data: bytes) -> list[Elem]:
    out, off = [], 0
    while off < len(data):
        e, off = load_item(data, off)
        out.append(e)
    return out


def combo_items(items: Sequence[str]) -> str:
    """Join combo entries the way ``ImStrToString`` sees them (NUL-separated)."""
    return "\x00".join(items)


def split_combo_items(s: str) -> list[str]:
    return s.split("\x00") if s else []


class SmGui:
    """Server-side recorder + diff consumer.

    One instance per menu render pass sequence.  Call
    :meth:`set_diff` with an incoming UI_ACTION's (id, value), run the
    menu callback (which calls the widget methods), then :meth:`take` the
    recorded list.  Widget methods return the (possibly diff-updated)
    value plus a changed flag, mirroring the bool returns of the C++
    widgets in server mode (smgui.cpp ``if (diffId == label ...)``).
    """

    def __init__(self) -> None:
        self._elems: list[Elem] = []
        self._diff_id: str = ""
        self._diff: Elem | None = None
        self._force_next = False
        self._recording = True
        self.sync_required = False

    # -- recording control ------------------------------------------------
    def set_diff(self, diff_id: str, value: Elem | None) -> None:
        self._diff_id = diff_id
        self._diff = value

    def begin(self, recording: bool = True) -> None:
        self._elems = []
        self._recording = recording
        self._force_next = False

    def take(self) -> list[Elem]:
        elems, self._elems = self._elems, []
        return elems

    def render_bytes(self) -> bytes:
        return store_list(self._elems)

    def _step(self, step: int) -> None:
        if not self._recording:
            return
        self._elems.append(
            Elem(ELEM_DRAW_STEP, step=step, force_sync=self._force_next)
        )
        self._force_next = False

    def _push(self, *elems: Elem) -> None:
        if self._recording:
            self._elems.extend(elems)

    # -- signaling / format calls ------------------------------------------
    def force_sync(self) -> None:
        # ForceSync marks the next widget so the client round-trips its
        # actions synchronously (smgui.cpp ForceSync).
        self._force_next = True

    def fill_width(self) -> None:
        self._step(STEP_FILL_WIDTH)

    def same_line(self) -> None:
        self._step(STEP_SAME_LINE)

    def begin_disabled(self) -> None:
        self._step(STEP_BEGIN_DISABLED)

    def end_disabled(self) -> None:
        self._step(STEP_END_DISABLED)

    def begin_group(self) -> None:
        self._step(STEP_BEGIN_GROUP)

    def end_group(self) -> None:
        self._step(STEP_END_GROUP)

    def next_column(self) -> None:
        self._step(STEP_NEXT_COLUMN)

    def columns(self, count: int, ident: str = "", border: bool = False) -> None:
        self._step(STEP_COLUMNS)
        self._push(Elem.integer(count), Elem.string(ident), Elem.boolean(border))

    def left_label(self, text: str) -> None:
        self._step(STEP_LEFT_LABEL)
        self._push(Elem.string(text))

    def text(self, s: str) -> None:
        self._step(STEP_TEXT)
        self._push(Elem.string(s))

    def text_colored(self, rgba: tuple[float, float, float, float], s: str) -> None:
        self._step(STEP_TEXT_COLORED)
        self._push(*(Elem.floating(c) for c in rgba), Elem.string(s))

    def set_next_item_width(self, w: float) -> None:
        self._step(STEP_SET_NEXT_ITEM_WIDTH)
        self._push(Elem.floating(w))

    # -- widgets -------------------------------------------------------------
    def _hit(self, label: str, want_type: int | None = None) -> bool:
        if self._diff_id != label or self._diff is None:
            return False
        return want_type is None or self._diff.type == want_type

    def combo(
        self, label: str, current: int, items: Sequence[str], popup_max: int = -1
    ) -> tuple[bool, int]:
        if self._hit(label, ELEM_INT):
            current = self._diff.i
            changed = True
        else:
            changed = False
        self._step(STEP_COMBO)
        self._push(
            Elem.string(label),
            Elem.integer(current),
            Elem.string(combo_items(items)),
            Elem.integer(popup_max),
        )
        return changed, current

    def button(self, label: str, w: float = 0.0, h: float = 0.0) -> bool:
        clicked = self._hit(label)
        self._step(STEP_BUTTON)
        self._push(Elem.string(label), Elem.floating(w), Elem.floating(h))
        return clicked

    def radio_button(self, label: str, active: bool) -> bool:
        clicked = self._hit(label)
        self._step(STEP_RADIO_BUTTON)
        self._push(Elem.string(label), Elem.boolean(active))
        return clicked

    def checkbox(self, label: str, value: bool) -> tuple[bool, bool]:
        if self._hit(label, ELEM_BOOL):
            value = self._diff.b
            changed = True
        else:
            changed = False
        self._step(STEP_CHECKBOX)
        self._push(Elem.string(label), Elem.boolean(value))
        return changed, value

    def slider_int(
        self,
        label: str,
        value: int,
        vmin: int,
        vmax: int,
        fmt: int = FMT_INT_DEFAULT,
        flags: int = 0,
    ) -> tuple[bool, int]:
        if self._hit(label, ELEM_INT):
            value = self._diff.i
            changed = True
        else:
            changed = False
        self._step(STEP_SLIDER_INT)
        self._push(
            Elem.string(label),
            Elem.integer(value),
            Elem.integer(vmin),
            Elem.integer(vmax),
            Elem.integer(fmt),
            Elem.integer(flags),
        )
        return changed, value

    def slider_float(
        self,
        label: str,
        value: float,
        vmin: float,
        vmax: float,
        fmt: int = FMT_FLOAT_DEFAULT,
        flags: int = 0,
    ) -> tuple[bool, float]:
        if self._hit(label, ELEM_FLOAT):
            value = self._diff.f
            changed = True
        else:
            changed = False
        self._step(STEP_SLIDER_FLOAT)
        self._push(
            Elem.string(label),
            Elem.floating(value),
            Elem.floating(vmin),
            Elem.floating(vmax),
            Elem.integer(fmt),
            Elem.integer(flags),
        )
        return changed, value

    def slider_float_with_steps(
        self,
        label: str,
        value: float,
        vmin: float,
        vmax: float,
        step: float,
        fmt: int = FMT_FLOAT_DEFAULT,
    ) -> tuple[bool, float]:
        if self._hit(label, ELEM_FLOAT):
            value = self._diff.f
            changed = True
        else:
            changed = False
        self._step(STEP_SLIDER_FLOAT_WITH_STEPS)
        self._push(
            Elem.string(label),
            Elem.floating(value),
            Elem.floating(vmin),
            Elem.floating(vmax),
            Elem.floating(step),
            Elem.integer(fmt),
        )
        return changed, value

    def input_int(
        self, label: str, value: int, step: int = 1, step_fast: int = 100,
        flags: int = 0,
    ) -> tuple[bool, int]:
        if self._hit(label, ELEM_INT):
            value = self._diff.i
            changed = True
        else:
            changed = False
        self._step(STEP_INPUT_INT)
        self._push(
            Elem.string(label),
            Elem.integer(value),
            Elem.integer(step),
            Elem.integer(step_fast),
            Elem.integer(flags),
        )
        return changed, value

    def input_text(
        self, label: str, value: str, maxlen: int = 4095, flags: int = 0
    ) -> tuple[bool, str]:
        if self._hit(label, ELEM_STRING):
            value = self._diff.s
            changed = True
        else:
            changed = False
        self._step(STEP_INPUT_TEXT)
        self._push(
            Elem.string(label),
            Elem.string(value),
            Elem.integer(maxlen),
            Elem.integer(flags),
        )
        return changed, value

    def open_popup(self, ident: str, flags: int = 0) -> None:
        self._step(STEP_OPEN_POPUP)
        self._push(Elem.string(ident), Elem.integer(flags))

    def begin_popup(self, ident: str, flags: int = 0) -> bool:
        self._step(STEP_BEGIN_POPUP)
        self._push(Elem.string(ident), Elem.integer(flags))
        return True

    def end_popup(self) -> None:
        self._step(STEP_END_POPUP)

    def begin_table(
        self,
        ident: str,
        columns: int,
        flags: int = 0,
        outer_w: float = 0.0,
        outer_h: float = 0.0,
        inner_width: float = 0.0,
    ) -> bool:
        self._step(STEP_BEGIN_TABLE)
        self._push(
            Elem.string(ident),
            Elem.integer(columns),
            Elem.integer(flags),
            Elem.floating(outer_w),
            Elem.floating(outer_h),
            Elem.floating(inner_width),
        )
        return True

    def end_table(self) -> None:
        self._step(STEP_END_TABLE)

    def table_next_row(self, flags: int = 0, min_height: float = 0.0) -> None:
        self._step(STEP_TABLE_NEXT_ROW)
        self._push(Elem.integer(flags), Elem.floating(min_height))

    def table_set_column_index(self, idx: int) -> None:
        self._step(STEP_TABLE_SET_COLUMN_INDEX)
        self._push(Elem.integer(idx))


@dataclass
class RemoteMenu:
    """Serves a menu callback over the server protocol.

    ``draw(gui)`` is called per render pass (``server.cpp drawMenu``); it
    reads/writes its own state and calls ``gui`` widget methods.  The
    double-render on actions matches ``renderUI`` (``server.cpp:321-343``):
    apply the diff in a throwaway pass, then record a clean frame that
    reflects the new state.
    """

    draw: Callable[[SmGui], None]
    gui: SmGui = field(default_factory=SmGui)

    def render(self, diff_id: str = "", diff_value: Elem | None = None) -> bytes:
        if diff_id:
            self.gui.set_diff(diff_id, diff_value)
            self.gui.begin(recording=False)
            self.draw(self.gui)
        self.gui.set_diff("", None)
        self.gui.begin(recording=True)
        self.draw(self.gui)
        return self.gui.render_bytes()


# ---------------------------------------------------------------------------
# Client-side helpers: parse a received draw list into inspectable widgets.

_WIDGET_OPERANDS = {
    STEP_COMBO: 4,
    STEP_BUTTON: 3,
    STEP_COLUMNS: 3,
    STEP_RADIO_BUTTON: 2,
    STEP_LEFT_LABEL: 1,
    STEP_SLIDER_INT: 6,
    STEP_SLIDER_FLOAT_WITH_STEPS: 6,
    STEP_INPUT_INT: 5,
    STEP_CHECKBOX: 2,
    STEP_SLIDER_FLOAT: 6,
    STEP_INPUT_TEXT: 4,
    STEP_TEXT: 1,
    STEP_TEXT_COLORED: 5,
    STEP_OPEN_POPUP: 2,
    STEP_BEGIN_POPUP: 2,
    STEP_BEGIN_TABLE: 6,
    STEP_TABLE_NEXT_ROW: 2,
    STEP_TABLE_SET_COLUMN_INDEX: 1,
    STEP_SET_NEXT_ITEM_WIDTH: 1,
}


@dataclass
class Widget:
    step: int
    label: str
    operands: list[Elem]


def parse_widgets(data: bytes) -> list[Widget]:
    """Walk a draw list the way ``DrawList::draw`` does, yielding widgets."""
    elems = load_list(data)
    out: list[Widget] = []
    i = 0
    while i < len(elems):
        e = elems[i]
        i += 1
        if e.type != ELEM_DRAW_STEP:
            continue
        n = _WIDGET_OPERANDS.get(e.step, 0)
        ops = elems[i : i + n]
        i += n
        label = ops[0].s if ops and ops[0].type == ELEM_STRING else ""
        out.append(Widget(e.step, label, ops))
    return out
