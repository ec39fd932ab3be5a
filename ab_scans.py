"""A/B of the scan kernels `costas_scan`, `viterbi_decode`, `mm_scan`,
`agc_scan` and `pll_scan` on one card.

Builds another tree's three sources beside this tree's and times both at
the paths' shapes in one process, in the order other, this, this, other:
device ms from the profiler (`chip_smoke.device_ms`) and CUDA events,
with the SM clock sampled beside each.  Each tree's outputs are held
against the other's to the bit (`chip_smoke.same_bits`, a NaN equal to
any NaN).  Shapes, one row each: `costas_scan` order 4 x 150 000 steps
and `viterbi_decode` K=7 x 88 448 (the Meteor path's); `mm_scan` complex
at 150 000 samples in (the Meteor block, 8 taps x 128 phases), float at
the Falcon 9 path's first block (60 000 in, its own inputs), and the
16/32-tap banks (complex and float 16 x 256, complex 8 x 1 024, float
32 x 1 600); `agc_scan` at 4 800, 3 000 and 600 steps (the receiver
path's usb, am and cw launches) and 4 800 steps from an average of -0.0
(a row outside the domain of the threshold walk); `pll_scan` on the
pilot of `chip_smoke.pll_args` at 12 500 steps (the pll path's block),
25 000 (the rds path's) and 2 rows x 25 000, and 12 500 steps from a
phase of 100 rad (a row outside the bounded walk's domain).

    mkdir DIR
    git archive <rev> sdrtpu_torch/csrc | tar -x -C DIR --strip-components=2
    python3 ab_scans.py [--old DIR] [--probe] [--probe-old PDIR] [--out FILE]

Without ``--old`` only this tree is timed.  With ``--probe``, this
tree's probe builds run once at the same shapes (`sdrtpu_torch.probe`)
and their cycles per part are logged and kept; with ``--probe-old``, so
do the probe builds of PDIR's sources (the other tree's kernels with the
marks of ``csrc/probe.cuh`` put in, and the headers beside them).  The
other tree's C entries must be this tree's.  Prints the card's name and
power limit first and one JSON object last.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from sdrtpu_torch import _build, probe
from sdrtpu_torch.fec import viterbi as tv
from sdrtpu_torch.kernels import clock, loops
from sdrtpu_torch.kernels.psk import MeteorDemod

COSTAS_STEPS = 150_000
VITERBI_STEPS = 88_448
SOURCES = ("sync_loops", "viterbi", "seq_loops")
REPS = 5


def build(src_dir: Path, out_dir: Path, name: str, probe_build: bool) -> Path:
    """nvcc of ``src_dir/name.cu`` with the port's flags."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}{'-probe' if probe_build else ''}.so"
    flags = list(_build.NVCC_FLAGS) + ([_build.PROBE_DEFINE]
                                       if probe_build else [])
    proc = subprocess.run([_build._nvcc(), *flags, "-o", str(lib),
                           str(src_dir / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src_dir / name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    (out_dir / f"{lib.name}.log").write_text(proc.stdout + proc.stderr)
    return lib


def entries(libs: dict) -> dict:
    """Each kernel of a tree's libraries as ``fn(*args)`` (the wrappers'
    arguments), launched through that library's C entry."""
    costas = libs["sync_loops"].costas_scan_launch
    costas.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                       + [ctypes.c_float] * 4 + [ctypes.c_int]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    costas.restype = ctypes.c_int
    vit = libs["viterbi"].viterbi_decode_launch
    vit.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    vit.restype = ctypes.c_int
    mm = libs["sync_loops"].mm_scan_launch
    mm.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                   + [ctypes.c_void_p])
    mm.restype = ctypes.c_int
    room = libs["sync_loops"].mm_scan_max_bank_bytes
    room.argtypes = [ctypes.c_int] * 2
    room.restype = ctypes.c_longlong
    agc = libs["seq_loops"].agc_scan_launch
    agc.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                    + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    agc.restype = ctypes.c_int
    pll = libs["seq_loops"].pll_scan_launch
    pll.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                    + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    pll.restype = ctypes.c_int
    return {
        "costas_scan": lambda *a: loops._costas_launch(costas, *a,
                                                       count=False),
        "viterbi_decode": lambda *a: tv._viterbi_launch(vit, *a,
                                                        count=False),
        "mm_scan": lambda *a: clock._mm_launch((mm, room), *a, count=False),
        "agc_scan": lambda *a: loops._agc_launch(agc, *a, count=False),
        "pll_scan": lambda *a: loops._pll_launch(pll, *a, count=False)}


def mm_args(mm, x, device="cuda"):
    """`mm_scan`'s arguments for ``x`` from ``mm``'s initial state."""
    n = x.shape[-1]
    st = mm.init_state()
    ext = torch.cat([st["tail"], torch.as_tensor(x, device=device)])
    return (ext[None].contiguous(), mm._bank, n, mm.max_out(n),
            st["offset"].reshape(1),
            torch.stack([st["phase"], st["freq"], st["last_out"]])[None],
            torch.stack([st[k] for k in ("p1", "p2", "c1", "c2")])[None],
            float(np.float32(mm.omega * (1 - mm.omega_rel_limit))),
            float(np.float32(mm.omega * (1 + mm.omega_rel_limit))),
            float(np.float32(mm.omega_gain)), float(np.float32(mm.mu_gain)))


def falcon9_mm_args():
    """The Falcon 9 path's first `mm_scan` call on the card, recorded."""
    from sdrtpu_torch.decoders import falcon9 as f9

    _, x = cs.falcon_capture(72)
    with cs.recording("mm_scan") as calls:
        f9.Falcon9Decoder(device="cuda").bits(x[:cs.FALCON_BLOCK])
    return calls["mm_scan"][0][0]


def inputs() -> dict:
    """{kernel: {shape name: the wrapper's arguments}} on the card, made
    as `chip_smoke`'s kernel phases make them."""
    rng = np.random.default_rng(17)
    path = MeteorDemod(device="cuda")
    coef = path.costas._coefficients()
    n = COSTAS_STEPS
    ph = 2 * np.pi * rng.integers(0, 4, (1, n)) / 4
    x = np.exp(1j * (ph + 2 * np.pi * 100.0 / cs.METEOR_FS * np.arange(n)
                     + 0.7))
    x = x + 0.05 * (rng.standard_normal((1, n))
                    + 1j * rng.standard_normal((1, n)))
    costas = (torch.as_tensor(x.astype(np.complex64), device="cuda"),
              torch.full((1,), 0.3, device="cuda"),
              torch.zeros(1, device="cuda"), *coef, loops.COSTAS_ORDER4)
    enc = tv.ConvEncoder(7, (0o171, 0o133))
    dec = tv.ViterbiDecoder(7, (0o171, 0o133), device="cuda")
    soft = enc.encode_to_soft(rng.integers(0, 2, VITERBI_STEPS))
    soft = soft + 0.7 * rng.standard_normal(soft.shape)
    sym = torch.as_tensor(soft.astype(np.float32).reshape(
        1, VITERBI_STEPS, 2), device="cuda")

    n = cs.METEOR_BLOCK
    q = cs.qpsk_rrc(rng, n * 12 // 25 + 1)[:n]
    q = q + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    mm = {"meteor": mm_args(path.recov, q.astype(np.complex64)),
          "falcon9": falcon9_mm_args()}
    for cplx, n, taps, phases in [(True, 3000, 16, 256),
                                  (False, 3000, 16, 256),
                                  (True, 3000, 8, 1024),
                                  (False, 2000, 32, 1600)]:
        omega = 25.0 / 12.0 if cplx else 5000.0 / 1187.5
        m = clock.MuellerMuller(omega, 1e-6, 0.01, 0.01, complex_mode=cplx,
                                interp_phase_count=phases,
                                interp_tap_count=taps, device="cuda")
        if cplx:
            v = cs.qpsk_rrc(rng, n * 12 // 25 + 1)[:n].astype(np.complex64)
        else:
            v = cs.bpsk_real(rng, int(n / omega) + 1, omega)[:n]
        mm[f"{'complex' if cplx else 'float'} {taps}x{phases}"] = mm_args(
            m, v)

    agc = {}
    for name, n in (("usb", 4800), ("am", 3000), ("cw", 600),
                    ("usb, average -0.0", 4800)):
        in_amp, smax = cs.agc_row(rng, 1, n, False)
        amp0 = torch.full((1,), -0.0 if "-0.0" in name else 0.0,
                          device="cuda")
        agc[f"{name} {n}"] = (in_amp, smax, amp0, *cs.AGC_COEF)
    pll = {f"{rows} x {n}{', phase 100 rad' if phase0 else ''}":
           cs.pll_args(rng, rows, n, phase0)
           for rows, n, phase0 in ((1, 12500, 0.0), (1, 25000, 0.0),
                                   (2, 25000, 0.0), (1, 12500, 100.0))}
    return {"costas_scan": {f"order 4 x {COSTAS_STEPS}": costas},
            "viterbi_decode": {f"K=7 x {VITERBI_STEPS}":
                               (sym, dec.exp_prev, dec.prev, dec.prev_bit)},
            "mm_scan": mm, "agc_scan": agc, "pll_scan": pll}


KERNEL_NAMES = {"costas_scan": "costas_scan_kernel",
                "viterbi_decode": "viterbi_kernel",
                "mm_scan": "mm_scan_kernel", "agc_scan": "agc_scan_kernel",
                "pll_scan": "pll_scan_kernel"}
PROBES = {"costas_scan": ("costas", probe.costas),
          "viterbi_decode": ("viterbi", probe.viterbi),
          "mm_scan": ("mm", probe.mm), "agc_scan": ("agc", probe.agc),
          "pll_scan": ("pll", probe.pll)}


def timed(fn, kernel: str, reps: int = REPS) -> dict:
    with cs.SmClocks() as clocks:
        ms = cs.device_ms(fn, reps, kernel)
        event_ms = cs.cuda_ms(fn, reps)
    return {"ms": ms, "event_ms": event_ms, "sm_clock_mhz": clocks.summary()}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--probe-old", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    cs.phase_device()
    print(cs.card_line(), flush=True)
    out_dir = _build.BUILD_DIR.parent / "ab_scans"
    shutil.rmtree(out_dir, ignore_errors=True)
    _build.build_all(SOURCES, probes=SOURCES if args.probe else ())
    runs = {"new": entries({name: _build.load(name) for name in SOURCES})}
    if args.old:
        runs["old"] = entries({
            name: ctypes.CDLL(str(build(args.old, out_dir / "old", name,
                                        False))) for name in SOURCES})
    shapes = inputs()
    report = {"card": cs.card_line(),
              "shapes": {k: list(v) for k, v in shapes.items()}}

    order = ("old", "new", "new", "old") if args.old else ("new",)
    for kernel, by_shape in shapes.items():
        report[kernel] = {}
        for shape, a in by_shape.items():
            row = report[kernel][shape] = {}
            if args.old:
                got = runs["new"][kernel](*a)
                want = runs["old"][kernel](*a)
                torch.cuda.synchronize()
                same = all(cs.same_bits(g.cpu(), w.cpu())
                           for g, w in zip(got, want))
                if not same:
                    raise AssertionError(f"{kernel} at {shape}: this tree "
                                         "and the other differ")
                row["bit_equal_to_old"] = same
            reps = 20 if kernel in ("agc_scan", "pll_scan") else REPS
            for i, tree in enumerate(order):
                fn = runs[tree][kernel]
                row[f"{i + 1}_{tree}"] = t = timed(lambda: fn(*a),
                                                   KERNEL_NAMES[kernel], reps)
                cs.log(f"{kernel} {shape} {tree}: {t}")

    report["probe"] = {}
    if args.probe:
        report["probe"]["new"] = {
            kernel: {shape: _strip(PROBES[kernel][1](*a))
                     for shape, a in by_shape.items()}
            for kernel, by_shape in shapes.items()}
    if args.probe_old:
        report["probe"]["old"] = old_probe(args.probe_old, out_dir, shapes)
    for tree, tables in report["probe"].items():
        for kernel, by_shape in tables.items():
            for shape, t in by_shape.items():
                cs.log(f"probe, {tree} {kernel} {shape}: cycles a step "
                       f"{t['per_step']}, a tile {t['per_tile']}, once "
                       f"{t['once']}, all parts {t['cycles_per_step']:.1f} "
                       "a step")
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


def _strip(result: dict) -> dict:
    result.pop("outputs")
    return result


def old_probe(src: Path, out_dir: Path, shapes: dict) -> dict:
    """The probe builds of ``src``'s sources (their entries as this
    tree's) at every shape."""
    libs = {name: ctypes.CDLL(str(build(src, out_dir / "old_probe", name,
                                        True)))
            for name in SOURCES}
    run = entries(libs)
    lib_of = {"costas_scan": "sync_loops", "viterbi_decode": "viterbi",
              "mm_scan": "sync_loops", "agc_scan": "seq_loops",
              "pll_scan": "seq_loops"}
    out = {}
    for kernel, by_shape in shapes.items():
        prefix = PROBES[kernel][0]
        out[kernel] = {}
        for shape, a in by_shape.items():
            _, raw = probe.run(libs[lib_of[kernel]], prefix,
                               lambda: run[kernel](*a), "cuda")
            out[kernel][shape] = probe.table(raw)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
