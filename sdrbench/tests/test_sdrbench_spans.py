"""The span readers (`sdrbench.spans`, ``metrics/{chan,if,wf}_*``): exact
counts and times on hand-built traces, None where there is nothing to
read, and host times inside the entry's on a tiny CPU run of each cell."""

from types import SimpleNamespace

import pytest

from sdrbench import harness, spans
from sdrbench.trace import Trace

LAYERS = {"chan": "sdrtpu.channelizer", "if": "sdrtpu.if_back_end",
          "wf": "sdrtpu.waterfall"}
L = "cudaLaunchKernel"


def trace(host):
    """A window of 100..1100 us holding the launch calls among ``host``."""
    return Trace((100.0, 1100.0), [("k", 120.0, 130.0)], host,
                 [s for n, s, _ in host if n == L])


# the channelizer's first span and the waterfall's cross the window's
# edges; the launch at 600 is in no layer's span (the pipeline's glue)
HOST = [
    ("sdrbench.call", 40.0, 1200.0),
    ("sdrtpu.channelizer", 50.0, 200.0),
    (L, 60.0, 61.0), (L, 150.0, 151.0),
    ("sdrtpu.if_back_end", 300.0, 500.0),
    (L, 310.0, 311.0), (L, 320.0, 321.0), (L, 330.0, 331.0),
    (L, 600.0, 601.0),
    ("sdrtpu.channelizer", 700.0, 800.0),
    ("sdrtpu.waterfall", 1000.0, 1200.0),
    (L, 1050.0, 1051.0), (L, 1150.0, 1151.0),
]


def run_of(tr, blocks=2):
    return SimpleNamespace(traced=SimpleNamespace(trace=tr, blocks=blocks))


def read(metric, run):
    return harness.reader(metric)(run)


@pytest.mark.parametrize("short,launches,host_us", [
    ("chan", 1, 200.0), ("if", 3, 200.0), ("wf", 1, 100.0)])
def test_exact_counts_and_times(short, launches, host_us):
    tr = trace(HOST)
    assert tr.launches == 6
    assert spans.launches(tr, LAYERS[short]) == launches
    assert spans.host_s(tr, LAYERS[short]) == pytest.approx(host_us * 1e-6)
    run = run_of(tr)
    for suffix in ("", ".live"):
        assert read(f"{short}_launches_per_block{suffix}", run) == launches / 2
        assert read(f"{short}_host_ms{suffix}", run) == pytest.approx(
            host_us * 1e-3 / 2)


def test_glue_is_the_rest_of_the_window():
    tr = trace(HOST)
    inside = sum(spans.launches(tr, n) for n in LAYERS.values())
    assert tr.launches - inside == 1
    assert spans.launches(tr, "sdrbench.call") == tr.launches


def test_overlapping_spans_of_one_name_count_once():
    host = [("sdrtpu.channelizer", 200.0, 400.0),
            ("sdrtpu.channelizer", 300.0, 500.0), (L, 350.0, 351.0)]
    tr = trace(host)
    assert spans.launches(tr, "sdrtpu.channelizer") == 1
    assert spans.host_s(tr, "sdrtpu.channelizer") == pytest.approx(300e-6)


def test_a_span_without_launches_reads_zero():
    host = [("sdrtpu.waterfall", 200.0, 300.0), (L, 600.0, 601.0)]
    assert read("wf_launches_per_block", run_of(trace(host))) == 0.0


def test_no_launches_read_none_and_host_time_stays():
    host = [h for h in HOST if h[0] != L]
    run = run_of(trace(host))
    for short in LAYERS:
        assert read(f"{short}_launches_per_block", run) is None
        assert read(f"{short}_host_ms", run) > 0


def test_a_program_without_spans_reads_none():
    run = run_of(trace([h for h in HOST if not h[0].startswith("sdrtpu.")]))
    for short in LAYERS:
        assert read(f"{short}_launches_per_block", run) is None
        assert read(f"{short}_host_ms", run) is None
    assert read("chan_host_ms", SimpleNamespace(traced=None)) is None


@pytest.mark.parametrize("cell", ["wbfm8.batch", "wbfm8.live"])
def test_host_times_of_a_cpu_run(tiny_cell, cell):
    """The three layers' host times are read and together stay inside the
    entry's (``sdrbench.call``, on the same clock)."""
    c = tiny_cell(cell)
    run, *_ = harness.measure(c, 13, 0.3, True, "cpu", 0.0)
    tr = run.traced
    got = {m: read(m, run) for m in (f"{s}_host_ms" for s in LAYERS)}
    assert all(v > 0 for v in got.values()), got
    call_ms = spans.host_s(tr.trace, "sdrbench.call") * 1e3 / tr.blocks
    assert sum(got.values()) <= call_ms
    for short in LAYERS:
        assert read(f"{short}_launches_per_block", run) is None
    names = {m["name"] for m in c["per_layer"]}
    suffix = ".live" if cell.endswith(".live") else ""
    assert names >= {f"{s}_{k}{suffix}" for s in LAYERS
                     for k in ("host_ms", "launches_per_block")}
