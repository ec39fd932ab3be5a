"""The ``meteor.batch`` cell: it resolves from its files, the plain CCSDS
code and reference recover what the capture encoded, a CPU run at the
size of `lrpt.tiny_cell` is correct (~25 s on one core of a 2024 x86
host: three program calls of three 50 ms blocks, the Costas and M&M
scans in their plain loops), each fault the cell can have makes it
incorrect, the reference runs without the program, and the readers of
the cell's metrics read exactly, or nothing, on hand-built runs."""

import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sdrbench import harness
from sdrbench.captures import lrpt_pass
from sdrbench.reference import ccsds, lrpt
from sdrbench.systems import lrpt as lrpt_system
from sdrbench.tests.lrpt import tiny_cell
from sdrbench.trace import Trace

SEED = 2**31 + 7
NEW = ("demod_launches_per_block.pass", "demod_host_ms.pass",
       "deframe_host_ms.pass", "rs_host_ms.pass", "costas_roofline",
       "mm_roofline", "viterbi_roofline")


def test_the_cell_resolves():
    cell = harness.load_cell("meteor.batch")
    cfg = cell["config"]
    assert (cfg["system"], cfg["reference"], cfg["capture"]["kind"]) == (
        "lrpt", "lrpt", "lrpt_pass")
    assert [m["name"] for m in cell["end_to_end"]] == ["realtime_x",
                                                       "setup_s"]
    assert tuple(m["name"] for m in cell["per_layer"]) == NEW
    t = cell["traffic"]
    assert (t["kind"], t["entry"], t["blocks_per_call"]) == (
        "closed_loop", "call", 1)
    assert t["capture_s"] * cfg["samplerate"] == 16 * cfg["block_len"]
    assert t["check_blocks"] >= 6 and t["warmup_calls"] >= 3
    assert set(cfg["limits"]) == {"symbol_gap", "symbol_outliers",
                                  "frame_mismatch"}
    assert cfg["limits"]["frame_mismatch"] == 0
    assert [v["mode"] for v in cfg["vfos"]] == ["meteor_lrpt"]


def test_rs_corrects_16_byte_errors_and_refuses_17():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, ccsds.K, dtype=np.uint8)
    code = ccsds.rs_encode(data)
    for errors, want in ((0, 0), (1, 1), (16, 16), (17, -1)):
        bad = code.copy()
        at = rng.choice(ccsds.N, errors, replace=False)
        bad[at] ^= rng.integers(1, 256, errors, dtype=np.uint8)
        got, n = ccsds.rs_decode(bad)
        assert n == want
        if want >= 0:
            assert np.array_equal(got, data)


def test_the_reference_recovers_every_cvcdu_the_capture_encoded():
    """The 2 s loop from rest and its first 0.25 s again: every CVCDU, in
    the loop's order, from the first or, where the loops lock within the
    first frame (its ASM lies 14 symbols in, past the filters' delay),
    from the second."""
    cell = tiny_cell()
    cfg = cell["config"]
    n = round(cell["traffic"]["capture_s"] * cfg["samplerate"])
    cvcdus, _ = lrpt_pass.payload(cfg, n, SEED)
    x = lrpt_pass.make(cfg, n, SEED, "cpu")
    x = torch.cat([x, x[:5 * cfg["block_len"]]]).reshape(-1, cfg["block_len"])
    syms, _, _ = lrpt.demodulate(lrpt.Arith("f64"), cfg, x)
    bits, frames = lrpt.deframe(syms)
    got = [lrpt._take(bits, p, inv)[0] for p, inv in frames]
    assert len(got) >= len(cvcdus) == 17
    assert all(g is not None for g in got)
    first = [i for i, c in enumerate(cvcdus) if np.array_equal(c, got[0])]
    assert first in ([0], [1])
    for k, g in enumerate(got):
        assert np.array_equal(g, cvcdus[(first[0] + k) % len(cvcdus)])


@pytest.fixture(scope="module")
def measured():
    """One CPU run of the program at the tiny size: (cell, sample, nb,
    host, seconds)."""
    t0 = time.perf_counter()
    cell = tiny_cell()
    run, sample, nb, host = harness.measure(cell, SEED, 0.0, False, "cpu",
                                            t0)
    return cell, sample, nb, host, time.perf_counter() - t0


def _check(measured, sample=None, control=None):
    cell, kept, nb, host, _ = measured
    return harness.check(cell, sample or kept, nb, host, "cpu",
                         control=control)


def test_a_cpu_run_is_correct(measured):
    verdict = _check(measured)
    assert verdict["correct"], verdict["numbers"]
    nums = verdict["numbers"]
    assert nums["frame_mismatch"]["value"] == 0
    assert nums["symbol_gap"]["value"] < nums["symbol_gap"]["limit"]
    assert len(verdict["blocks"]) == 3
    assert measured[4] < 60.0


def test_the_control_fails(measured):
    verdict = _check(measured, control="tf32")
    assert not verdict["correct"], verdict["numbers"]
    nums = verdict["numbers"]
    # by the symbols' gap, not by the frames
    assert nums["symbol_gap"]["value"] > nums["symbol_gap"]["limit"]
    assert nums["frame_mismatch"]["value"] == 0


def _edited(measured, edit):
    kept = measured[1]
    fake = SimpleNamespace(kept={i: {n: t.clone() for n, t in o.items()}
                                 for i, o in kept.kept.items()})
    edit(fake.kept)
    return fake


def test_a_symbol_altered_fails(measured):
    def edit(kept):
        first = min(kept)
        kept[first]["syms"][0, 100] += 1.0
    verdict = _check(measured, _edited(measured, edit))
    assert not verdict["correct"]
    assert verdict["numbers"]["symbol_outliers"]["value"] >= 1


def test_a_fifth_of_the_symbols_moved_a_little_fails(measured):
    """Below the loops' ~0.04 and `lrpt.OUTLIER`: caught by the gaps'
    `lrpt.QUANTILE`, each symbol taken at its nearest phase."""
    def edit(kept):
        for o in kept.values():
            o["syms"][0, 5::5] += 0.03
    verdict = _check(measured, _edited(measured, edit))
    assert not verdict["correct"]
    nums = verdict["numbers"]
    assert nums["symbol_gap"]["value"] > nums["symbol_gap"]["limit"]
    assert nums["symbol_outliers"]["value"] == 0


def test_blocks_left_out_fail(measured):
    """Each checked block's outputs stand in for another's."""
    def edit(kept):
        order = sorted(kept)
        outs = [kept[i] for i in order]
        for i, o in zip(order, outs[1:] + outs[:1]):
            kept[i] = o
    verdict = _check(measured, _edited(measured, edit))
    assert not verdict["correct"]


def test_frames_left_out_fail(measured):
    kept = measured[1].kept
    assert any(int(o["nframes"][0]) for o in kept.values())

    def edit(kept):
        for o in kept.values():
            o["nframes"].zero_()
    verdict = _check(measured, _edited(measured, edit))
    assert verdict["numbers"]["frame_mismatch"]["value"] >= 1


def stale_state(call):
    def f(self, entry, state, xs):
        _, out = call(self, entry, state, xs)
        return state, out
    return f


def rs_skipped(decode):
    """The frames' data bytes as they arrive, uncorrected."""
    def f(code, rs):
        c = np.asarray(code, np.uint8).reshape(ccsds.N, ccsds.DEPTH)
        return c[:ccsds.K].reshape(-1).copy(), 0
    return f


@pytest.mark.parametrize("fault", ["stale_state", "rs_skipped"])
def test_program_faults_fail(monkeypatch, fault):
    from sdrtpu_torch.decoders import ccsds as program_ccsds

    if fault == "stale_state":
        monkeypatch.setattr(lrpt_system.System, "call",
                            stale_state(lrpt_system.System.call))
    else:
        monkeypatch.setattr(program_ccsds, "rs_interleave_decode",
                            rs_skipped(program_ccsds.rs_interleave_decode))
    out = harness.run_cell(tiny_cell(), SEED, 0.0, False, "cpu", 0.0)
    assert not out["correct"], out["checks"]
    if fault == "rs_skipped":
        assert out["checks"]["frame_mismatch"]["value"] >= 1


def test_the_reference_runs_without_the_program():
    code = (
        "import sys, torch\n"
        "from sdrbench.reference import lrpt\n"
        "from sdrbench.tests.lrpt import tiny_cell\n"
        "cfg = tiny_cell()['config']\n"
        "x = torch.randn(2, cfg['block_len'], dtype=torch.complex64)\n"
        "out = lrpt.run(cfg, x)\n"
        "assert out['syms'].shape == (2, 2, lrpt.max_out(cfg))\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax", "sdrtpu",
                                          "sdrtpu_torch"}


L = "cudaLaunchKernel"
# one block: the frontend with the demodulator inside it, then the
# deframer with two RS decodes; the launch at 900 is the harness's
HOST = [
    ("sdrtpu.rx.frontend", 100.0, 400.0), (L, 110.0, 111.0),
    ("sdrtpu.rx.demod", 200.0, 380.0), (L, 210.0, 211.0),
    (L, 220.0, 221.0), (L, 230.0, 231.0),
    ("sdrtpu.deframe", 420.0, 820.0), (L, 430.0, 431.0),
    ("sdrtpu.deframe.rs", 500.0, 600.0), ("sdrtpu.deframe.rs", 650.0, 700.0),
    (L, 900.0, 901.0),
]
DEVICE = [("void costas_scan_kernel<1>", 10.0, 30.0),
          ("void mm_scan_kernel<true, 8, false>", 40.0, 50.0),
          ("void viterbi_kernel<2, true>", 60.0, 100.0)]


class _Shapes:
    @staticmethod
    def scan_shapes():
        return {"if_len": 150000, "sps": 150000 / 72000, "max_out": 73084,
                "mm_phases": 128, "mm_taps": 8}


def run_of(host, counters=None, blocks=1, device=DEVICE, system=_Shapes):
    tr = Trace((0.0, 1000.0), device, host, [s for n, s, _ in host if n == L])
    return SimpleNamespace(traced=SimpleNamespace(
        trace=tr, blocks=blocks, counters=counters or {}, system=system))


@pytest.mark.parametrize("metric,value", [
    ("demod_launches_per_block.pass", 3.0),
    ("demod_host_ms.pass", 0.18),
    ("deframe_host_ms.pass", 0.4),
    ("rs_host_ms.pass", 0.15),
])
def test_span_readers_count_exactly(metric, value):
    assert harness.reader(metric)(run_of(HOST)) == pytest.approx(value)


def test_a_program_without_the_spans_reads_none():
    run = run_of([h for h in HOST if not h[0].startswith("sdrtpu.")])
    for metric in NEW[:4]:
        assert harness.reader(metric)(run) is None


COUNTERS = {"costas_scan.launches": 2, "mm_scan.launches": 2,
            "viterbi_decode.launches": 2, "deframe.viterbi_steps": 176896}


@pytest.mark.parametrize("metric,kernel_us,work", [
    ("costas_roofline", 20.0,
     lambda: lrpt_roofline_work("costas", 150000)),
    ("mm_roofline", 10.0, lambda: lrpt_roofline_work("mm", 150000)),
    ("viterbi_roofline", 40.0, lambda: lrpt_roofline_work("viterbi", 88448)),
])
def test_rooflines_read_least_time_over_device_time(metric, kernel_us, work):
    from sdrbench.frozen import peaks

    least_ms = peaks.bound(*work())["bound_ms"]
    got = harness.reader(metric)(run_of(HOST, COUNTERS, blocks=2))
    assert got == pytest.approx(100.0 * least_ms * 1e3 / kernel_us)
    assert 0.0 < got <= 100.0


def lrpt_roofline_work(kind, n):
    from sdrbench.frozen import scan_counts

    if kind == "costas":
        w = scan_counts.costas_scan(n)
    elif kind == "mm":
        w = scan_counts.mm_scan(n, 73084, n / (150000 / 72000), 128, 8)
    else:
        w = scan_counts.viterbi_decode(n)
    return w["bytes"], w["flops"]


@pytest.mark.parametrize("metric", NEW[4:])
def test_rooflines_read_none_without_launches_or_kernels(metric):
    read = harness.reader(metric)
    assert read(run_of(HOST, {}, blocks=2)) is None
    assert read(run_of(HOST, COUNTERS, blocks=2, device=[])) is None
    assert read(SimpleNamespace(traced=None)) is None


def test_the_capture_loops_seamlessly():
    """Its spectrum is whole bins: the loop's last sample runs into its
    first as any two neighbours do (no step larger than the signal's
    own), and the fill holds no false ASM."""
    cfg = tiny_cell()["config"]
    cfg["capture"].update(esn0_db=60.0, burst_esn0_db=200.0)
    n = round(2.0 * cfg["samplerate"])
    x = lrpt_pass.make(cfg, n, SEED, "cpu").to(torch.complex128)
    steps = (x - torch.roll(x, 1)).abs()
    assert float(steps[0]) <= float(steps.max())
    _, bits = lrpt_pass.payload(cfg, n, SEED)
    nfill = len(bits) % ccsds.FRAME_BITS
    tail = np.concatenate([bits[-nfill:], bits[:31]])
    assert not ccsds.asm_hits(tail)
