"""The ``rx8.stream`` cell: it resolves from its files, its reference runs
without the program, a CPU run at the size of `rx8.tiny_cell` is correct
and reads every metric that has something to read there, and the span
readers count exactly on a hand-built trace."""

import subprocess
import sys
from types import SimpleNamespace

import pytest

from sdrbench import harness, spans
from sdrbench.tests.rx8 import tiny_cell
from sdrbench.trace import Trace

NEW = ("rx_launches_per_block.stream", "ddc_launches_per_block.stream",
       "ddc_host_ms.stream", "radio_launches_per_block.stream",
       "radio_host_ms.stream", "agc_launches_per_block.stream")
LAUNCHES = ("rx_launches_per_block.stream", "ddc_launches_per_block.stream",
            "radio_launches_per_block.stream")
L = "cudaLaunchKernel"


def test_the_cell_resolves():
    cell = harness.load_cell("rx8.stream")
    cfg = cell["config"]
    assert (cfg["system"], cfg["reference"], cfg["capture"]["kind"]) == (
        "receiver", "receiver", "mixed_stations")
    assert [m["name"] for m in cell["end_to_end"]] == ["realtime_x",
                                                       "setup_s"]
    assert tuple(m["name"] for m in cell["per_layer"]) == NEW
    assert cell["traffic"]["entry"] == "call"
    # the capture is 16 whole blocks
    assert (cell["traffic"]["capture_s"] * cfg["samplerate"]
            == 16 * cfg["block_len"])
    assert sorted(v["mode"] for v in cfg["vfos"]) == [
        "am", "cw", "nfm", "nfm", "usb", "wfm", "wfm", "wfm"]
    assert set(cfg["limits"]) == {"audio_gap", "agc_audio_gap",
                                  "waterfall_gap_db"}


def test_the_reference_runs_without_the_program():
    code = (
        "import sys, torch\n"
        "from sdrbench import harness\n"
        "from sdrbench.reference import receiver\n"
        "from sdrbench.tests.rx8 import scaled\n"
        "cfg = scaled(harness.load_cell('rx8.stream')['config'])\n"
        "x = torch.randn(1, cfg['block_len'], dtype=torch.complex64)\n"
        "out = receiver.run(cfg, x)\n"
        "assert out['audio.cw'].shape == (1, 2, 9600), out['audio.cw'].shape\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax", "sdrtpu",
                                          "sdrtpu_torch"}


def test_a_traced_cpu_run_is_correct_and_reads_its_metrics():
    out = harness.run_cell(tiny_cell(), 2**31 + 41, 0.3, True, "cpu", 0.0)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["ddc_host_ms.stream"]["value"] > 0
    assert got["radio_host_ms.stream"]["value"] > 0
    # on the CPU no AGC kernel is launched, and the trace holds no launch
    # call for the span readers to count
    assert got["agc_launches_per_block.stream"]["value"] == 0.0
    assert not set(LAUNCHES) & set(got)


# one block's frontend call: the waterfall and a fused group outside the
# per-VFO spans, two DDCs and three radio chains; the launch at 900 is
# the harness's, outside the frontend
HOST = [
    ("sdrtpu.rx.frontend", 100.0, 800.0),
    (L, 110.0, 111.0), (L, 120.0, 121.0),
    ("sdrtpu.rx.radio", 200.0, 300.0), (L, 210.0, 211.0),
    ("sdrtpu.rx.ddc", 320.0, 400.0), (L, 330.0, 331.0), (L, 340.0, 341.0),
    ("sdrtpu.rx.radio", 400.0, 500.0), (L, 450.0, 451.0),
    ("sdrtpu.rx.ddc", 520.0, 560.0), (L, 530.0, 531.0),
    ("sdrtpu.rx.radio", 600.0, 700.0), (L, 650.0, 651.0), (L, 660.0, 661.0),
    (L, 900.0, 901.0),
]


def run_of(host, counters=None, blocks=1):
    tr = Trace((0.0, 1000.0), [("k", 10.0, 20.0)], host,
               [s for n, s, _ in host if n == L])
    return SimpleNamespace(traced=SimpleNamespace(
        trace=tr, blocks=blocks, counters=counters or {}))


@pytest.mark.parametrize("metric,value", [
    ("rx_launches_per_block.stream", 9.0),
    ("ddc_launches_per_block.stream", 3.0),
    ("radio_launches_per_block.stream", 4.0),
    ("ddc_host_ms.stream", 0.12),
    ("radio_host_ms.stream", 0.3),
])
def test_span_readers_count_exactly(metric, value):
    assert harness.reader(metric)(run_of(HOST)) == pytest.approx(value)
    assert spans.launches(run_of(HOST).traced.trace,
                          "sdrtpu.rx.frontend") == 9


def test_a_program_without_the_spans_reads_none():
    run = run_of([h for h in HOST if not h[0].startswith("sdrtpu.")])
    for metric in NEW[:-1]:
        assert harness.reader(metric)(run) is None


def test_agc_launches_read_the_programs_counter():
    read = harness.reader("agc_launches_per_block.stream")
    assert read(run_of(HOST, {"agc_scan.launches": 30}, blocks=10)) == 3.0
    assert read(run_of(HOST, {"agc_scan.launches": None})) is None
    assert read(SimpleNamespace(traced=None)) is None
