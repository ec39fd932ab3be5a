"""A/B of the scan kernels `costas_scan` and `viterbi_decode` on one card.

Builds another tree's two sources beside this tree's and times both at
the Meteor path's shapes (`costas_scan` order 4 x 150 000 steps,
`viterbi_decode` K=7 x 88 448 steps, one row each) in one process, in
the order other, this, this, other: device ms from the profiler
(`chip_smoke.device_ms`) and CUDA events, with the SM clock sampled
beside each.  Each tree's outputs are held against the other's
(`costas_scan` within COSTAS_REL_TOL of the peak, `viterbi_decode`
bits and metrics equal).

    git show <rev>:sdrtpu_torch/csrc/sync_loops.cu > DIR/sync_loops.cu
    git show <rev>:sdrtpu_torch/csrc/viterbi.cu > DIR/viterbi.cu
    python3 ab_scans.py --old DIR [--probe] [--probe-old PDIR] [--out FILE]

The other tree's C entries are PR 5's (`costas_scan_launch` without the
wrap threshold).  With ``--probe``, this tree's probe build runs once
at the same shapes (`sdrtpu_torch.probe`) and its cycles per part are
logged; with ``--probe-old``, so does the probe build of PDIR's sources
(the other tree's kernels with the marks of ``csrc/probe.cuh`` put in,
and that header beside them).  Prints the card's name and power limit
first and one JSON object last.  Needs a card and nvcc.
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
from sdrtpu_torch.kernels import loops
from sdrtpu_torch.kernels.psk import MeteorDemod

COSTAS_STEPS = 150_000
VITERBI_STEPS = 88_448
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


def costas_entry(lib: ctypes.CDLL, pr5: bool):
    fn = lib.costas_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                   + [ctypes.c_float] * 4 + [ctypes.c_int]
                   + [ctypes.c_float] * (4 if pr5 else 6)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    broken = [loops._f32(p) for p in loops.BROKEN_PHASES]
    extra = broken + ([] if pr5 else [loops.COSTAS_WRAP_FAST,
                                      loops.COSTAS_WRAP_TURN])

    def run(x, phase0, freq0, alpha, beta, fmin, fmax, mode):
        y = torch.empty_like(x)
        ph, fr = torch.empty_like(phase0), torch.empty_like(freq0)
        rc = fn(x.data_ptr(), y.data_ptr(), phase0.data_ptr(),
                freq0.data_ptr(), ph.data_ptr(), fr.data_ptr(), x.shape[0],
                x.shape[1], alpha, beta, fmin, fmax, mode, *extra,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"costas_scan_launch: error {rc}")
        return y, ph, fr
    return fn, run


def viterbi_entry(lib: ctypes.CDLL):
    fn = lib.viterbi_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, lambda *a: tv._viterbi_launch(fn, *a, count=False)


def inputs():
    """The Meteor shapes' inputs, as `chip_smoke.phase_sync_kernels`
    makes them (seed 17)."""
    rng = np.random.default_rng(17)
    coef = MeteorDemod(device="cuda").costas._coefficients()
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
    return costas, (sym, dec.exp_prev, dec.prev, dec.prev_bit)


def timed(fn, kernel: str) -> dict:
    with cs.SmClocks() as clocks:
        ms = cs.device_ms(fn, REPS, kernel)
        event_ms = cs.cuda_ms(fn, REPS)
    return {"ms": ms, "event_ms": event_ms, "sm_clock_mhz": clocks.summary()}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--probe-old", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    cs.phase_device()
    out_dir = _build.BUILD_DIR.parent / "ab_scans"
    shutil.rmtree(out_dir, ignore_errors=True)
    old_libs = {name: ctypes.CDLL(str(build(args.old, out_dir / "old", name,
                                            False)))
                for name in ("sync_loops", "viterbi")}
    _build.build_all(("sync_loops", "viterbi"))
    new_libs = {name: _build.load(name) for name in ("sync_loops", "viterbi")}
    c_args, v_args = inputs()
    runs = {
        "old": {"costas_scan": costas_entry(old_libs["sync_loops"], True)[1],
                "viterbi_decode": viterbi_entry(old_libs["viterbi"])[1]},
        "new": {"costas_scan": costas_entry(new_libs["sync_loops"], False)[1],
                "viterbi_decode": viterbi_entry(new_libs["viterbi"])[1]}}
    report = {"card": cs.card_line(), "shapes": {
        "costas_scan": [1, COSTAS_STEPS, "order 4"],
        "viterbi_decode": [1, VITERBI_STEPS, "K=7, R=2"]}}

    # each tree against the other
    outs = {tree: {"costas_scan": r["costas_scan"](*c_args),
                   "viterbi_decode": r["viterbi_decode"](*v_args)}
            for tree, r in runs.items()}
    torch.cuda.synchronize()
    report["costas_scan_vs_old"] = cs.held(
        "costas_scan", outs["new"]["costas_scan"], outs["old"]["costas_scan"],
        "this tree vs the other")
    report["viterbi_decode_vs_old"] = cs.held(
        "viterbi_decode", outs["new"]["viterbi_decode"],
        outs["old"]["viterbi_decode"], "this tree vs the other")

    kernels = {"costas_scan": ("costas_scan_kernel", c_args),
               "viterbi_decode": ("viterbi_kernel", v_args)}
    for name, (kernel, a) in kernels.items():
        report[name] = {}
        for i, tree in enumerate(("old", "new", "new", "old")):
            fn = runs[tree][name]
            report[name][f"{i + 1}_{tree}"] = t = timed(lambda: fn(*a),
                                                        kernel)
            cs.log(f"{name} {tree}: {t}")

    report["probe"] = {}
    if args.probe:
        report["probe"]["new"] = {
            "costas_scan": _strip(probe.costas(*c_args)),
            "viterbi_decode": _strip(probe.viterbi(*v_args))}
    if args.probe_old:
        report["probe"]["old"] = old_probe(args.probe_old, out_dir, c_args,
                                           v_args)
        for tree, tables in report["probe"].items():
            for name, t in tables.items():
                cs.log(f"probe, {tree} {name}: cycles a step "
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


def old_probe(src: Path, out_dir: Path, c_args, v_args) -> dict:
    """The probe builds of ``src``'s sources (their entries as this
    tree's, `costas_scan_launch` as PR 5's)."""
    libs = {name: ctypes.CDLL(str(build(src, out_dir / "old_probe", name,
                                        True)))
            for name in ("sync_loops", "viterbi")}
    c_run = costas_entry(libs["sync_loops"], True)[1]
    v_run = viterbi_entry(libs["viterbi"])[1]
    _, c_raw = probe.run(libs["sync_loops"], "costas",
                         lambda: c_run(*c_args), "cuda")
    _, v_raw = probe.run(libs["viterbi"], "viterbi",
                         lambda: v_run(*v_args), "cuda")
    return {"costas_scan": probe.table(c_raw),
            "viterbi_decode": probe.table(v_raw)}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
