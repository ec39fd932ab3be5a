"""The program's spans in the traced window (`sdrbench.trace.Trace`).

``sdrtpu_torch`` opens a host range at each of its layers while the
profiler records (``sdrtpu.channelizer``, ``sdrtpu.if_back_end``,
``sdrtpu.waterfall``, inside ``sdrtpu.wbfm.call`` or ``.scan_call``).
For one span name, over the window and on the loop's thread: the launch
calls (`sdrbench.trace.LAUNCH_CALLS`) that start inside a span of that
name, and the host time those spans cover.  Spans are clipped to the
window, and spans of one name that overlap count once.  Where the
program opens no span of the name, as before it had them, each reading
is None.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

from sdrbench.trace import LAUNCH_CALLS, _union


def intervals(trace, name: str) -> list:
    """The union of the spans ``name``, clipped to the window, in us."""
    return _union(sorted(
        (max(s, trace.t0), min(e, trace.t1)) for n, s, e in trace.host
        if n == name and e > trace.t0 and s < trace.t1))


def launches(trace, name: str) -> int | None:
    """Launch calls that start inside a span ``name`` in the window."""
    spans = intervals(trace, name)
    if not spans:
        return None
    starts = sorted(s for n, s, _ in trace.host
                    if n in LAUNCH_CALLS and trace.t0 <= s <= trace.t1)
    return sum(bisect_right(starts, e) - bisect_left(starts, s)
               for s, e in spans)


def host_s(trace, name: str) -> float | None:
    """Host seconds inside the spans ``name`` in the window."""
    spans = intervals(trace, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-6


def launches_per_block(run, name: str) -> float | None:
    """`launches` over the blocks of the traced window; None where the
    trace holds no launch call at all (no card)."""
    tr = run.traced
    if tr is None or not tr.blocks or not tr.trace.launches:
        return None
    n = launches(tr.trace, name)
    return None if n is None else n / tr.blocks


def host_ms_per_block(run, name: str) -> float | None:
    """`host_s` in ms over the blocks of the traced window."""
    tr = run.traced
    if tr is None or not tr.blocks:
        return None
    s = host_s(tr.trace, name)
    return None if s is None else s * 1e3 / tr.blocks
