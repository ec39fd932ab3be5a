"""The chunk build's (K1, ``chunk_poly``) share of its roofline: the
least time the build's function needs for one launch, its bytes (the
window read once, the chunks written once: ``frozen.counts``) over the
published HBM rate (``frozen.peaks``), divided by the profiler's mean
device time per launch, in percent.

The samples one launch takes are the blocks of the traced window over
the program's own count of launches in it."""

from sdrbench.frozen import counts, peaks


def read(run):
    tr = run.traced
    if tr is None:
        return None
    plan = tr.system.chunk_build_plan()
    launches = tr.counters.get("chunk_poly_launches")
    if plan is None or not launches or not tr.blocks:
        return None
    times = tr.trace.kernel_us("chunk_poly")
    if not times:
        return None
    n_new = tr.blocks * tr.block_len / launches
    work = counts.chunk_build(n_new, plan["tpad"], n_new / plan["valid"],
                              plan["nfft"])
    least_ms = peaks.bound(work["bytes"], work["flops"])["bound_ms"]
    return 100.0 * least_ms * 1e3 / (sum(times) / len(times))
