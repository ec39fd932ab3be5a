"""The traced window: ``torch.profiler`` over the run's loop, reduced to
what the per-layer readers and the result's ``breakdown`` need.

- The window is the host range ``sdrbench.window`` around the loop.
- Device activity: every device event (kernels, copies, sets) inside
  the window; ``busy_s`` is the length of their union, so operations
  that overlap count once.
- Launches: the host's calls of the CUDA launch API inside the window,
  counted from the profiler's host events, which the trace's known loss
  of back-to-back device events does not touch.
- Idle gaps: each stretch of the window in which nothing ran on the
  device, named by the innermost host range open at its middle on the
  loop's thread (``sdrbench.*`` for the harness's own phases, else the
  program's operator).
"""

from __future__ import annotations

import heapq
from collections import defaultdict

import torch

NAME_CHARS = 160  # a device operation's name in the breakdown, cut
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")
WINDOW = "sdrbench.window"


class Trace:
    def __init__(self, window: tuple, device: list, host: list,
                 launch_starts: list):
        """``window`` (start, end) in us; ``device`` [(name, start, end)];
        ``host`` [(name, start, end)] of the loop's thread;
        ``launch_starts``: start of every launch call, any thread."""
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.device = sorted((n, max(s, self.t0), min(e, self.t1))
                             for n, s, e in device
                             if e > self.t0 and s < self.t1)
        self.host = host
        self.launches = sum(1 for s in launch_starts
                            if self.t0 <= s <= self.t1)
        self.busy = _union(sorted((s, e) for _, s, e in self.device))
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6

    def kernel_us(self, part: str) -> list[float]:
        """Device time of each event whose name holds ``part``, in us."""
        return [e - s for n, s, e in self.device if part in n]

    def device_ops(self, top: int = 10) -> list:
        total = defaultdict(float)
        for n, s, e in self.device:
            total[n[:NAME_CHARS]] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in total.items()),
                      key=lambda r: -r[1])[:top]

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds summed by what the host was doing, largest first."""
        gaps = self.gaps()
        mids = sorted(((s + e) / 2.0, e - s) for s, e in gaps)
        events = sorted((s, e, n) for n, s, e in self.host)
        total = defaultdict(float)
        open_, i = [], 0
        for mid, length in mids:
            while i < len(events) and events[i][0] <= mid:
                s, e, n = events[i]
                heapq.heappush(open_, (-s, e, n))
                i += 1
            while open_ and open_[0][1] < mid:
                heapq.heappop(open_)
            name = open_[0][2] if open_ else "(no host range)"
            total[name] += length * 1e-6
        return sorted(([n, v] for n, v in total.items()),
                      key=lambda r: -r[1])[:top]


def _union(spans):
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(loop) -> Trace:
    """Run ``loop(mark)`` under the profiler, ``mark(name)`` being a host
    range, and reduce the profile."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            loop(record_function)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device, host, launches, window, thread = [], [], [], None, None
    events = prof.events()
    # host ranges (record_function) are mirrored on the device's timeline
    # as annotations: they are not device work
    ranges = {WINDOW}
    for ev in events:
        if ev.device_type != cuda and getattr(ev, "is_user_annotation", False):
            ranges.add(ev.name)
        if ev.name == WINDOW and ev.device_type != cuda:
            window = (ev.time_range.start, ev.time_range.end)
            thread = ev.thread
    for ev in events:
        span = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == cuda:
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name in ranges or ev.name.startswith("sdrbench.")):
                device.append(span)
            continue
        if ev.name in LAUNCH_CALLS:
            launches.append(ev.time_range.start)
        if ev.thread == thread and ev.name != WINDOW:
            host.append(span)
    return Trace(window, device, host, launches)
