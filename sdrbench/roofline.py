"""A hand kernel's share of its roofline in the traced window, for the
``*_roofline`` readers: the least time of one launch's work
(``frozen.peaks.bound``) over the profiler's mean device time per launch
of the kernels whose names hold a part, in percent."""

from __future__ import annotations

from sdrbench.frozen import peaks


def share(run, counter: str, kernel: str, work) -> float | None:
    """``work(traced, launches, shapes)`` -> {"bytes", "flops"} of one
    launch, or None; ``counter``: the wrapper whose ``<counter>.launches``
    the program counts; ``kernel``: part of the device kernels' names.
    None where the run was not traced, the program counts no launch or
    the trace holds no such kernel."""
    tr = run.traced
    if tr is None or not tr.blocks:
        return None
    launches = tr.counters.get(f"{counter}.launches")
    if not launches:
        return None
    times = tr.trace.kernel_us(kernel)
    if not times:
        return None
    w = work(tr, launches, tr.system.scan_shapes())
    if w is None:
        return None
    least_ms = peaks.bound(w["bytes"], w["flops"])["bound_ms"]
    return 100.0 * least_ms * 1e3 / (sum(times) / len(times))
