"""Latency probe of the scan kernels `costas_scan`, `viterbi_decode`,
`mm_scan`, `agc_scan` and `pll_scan`.

Each function launches the probe build of a kernel (``csrc/*.cu`` built
with ``-DSDRTPU_PROBE``, `_build.load(name, probe=True)`; see
``csrc/probe.cuh``): lane 0 reads the SM clock after each part of each
step and sums the cycles per part.  The result says which part of a
step is long; the marks serialise the parts, so the probe's cycles per
step exceed the plain build's.  Needs a card.  Its launches go to a
library of their own and add nothing to the wrappers' launch counts.

    from sdrtpu_torch import probe
    probe.costas(x, phase0, freq0, alpha, beta, fmin, fmax, mode)
    probe.viterbi(sym, exp_prev, prev, prev_bit)
    probe.mm(ext, bank, n, n_out, offset0, fstate0, cstate0, fmin, fmax,
             omega_gain, mu_gain)
    probe.agc(in_amp, suffix_max, amp0, one_m_atk, atk, one_m_dcy, dcy,
              set_point, max_gain, max_out)
    probe.pll(x, phase0, freq0, alpha, beta, fmin, fmax)
    probe.identities()

The first five return ``{"outputs": the kernel's outputs, "steps": n,
"tiles": t, "per_step": {part: cycles a step}, "per_tile": {part:
cycles a tile}, "once": {part: cycles}, "cycles_per_step": all cycles /
steps}``.  `identities` counts, over every float32 bit pattern, where
the Costas kernel's sine and cosine, phase wraps and two-instruction
clip differ from the forms they replace.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fec import viterbi as _viterbi
from .kernels import clock as _clock
from .kernels import loops as _loops

# parts that run once a tile (tile load and store, symbol staging, the
# AGC and PLL walkers' wait at the tile's barrier; `mm_scan`'s tile is a
# window) and once a launch (the final metrics and their argmax, the
# AGC's domain test); the rest, and the traceback, once a step.  Counts,
# not cycles: steps, tiles, the traceback's chunks walked again
# (``rewalks``), the M&M symbols walked in batches and the batches.
_PER_TILE = ("tile_load", "tile_store", "sym_tile", "tile_wait")
_ONCE = ("final", "domain")
_COUNTS = ("steps", "tiles", "rewalks", "fast_steps", "batches")


def run(lib, prefix: str, launch, device) -> tuple:
    """``launch()`` with library ``lib``'s probe counters pointed at a
    fresh buffer on ``device``: returns (its outputs, counters by part
    name)."""
    parts_fn = getattr(lib, f"{prefix}_probe_parts")
    parts_fn.restype = ctypes.c_char_p
    names = parts_fn().decode().split(",")
    target = getattr(lib, f"{prefix}_probe_target")
    target.argtypes = [ctypes.c_void_p]
    target.restype = None
    counters = torch.zeros(len(names), dtype=torch.int64, device=device)
    target(counters.data_ptr())
    try:
        out = launch()
    finally:
        target(None)
    return out, dict(zip(names, counters.tolist()))


def table(raw: dict) -> dict:
    """Counters as cycles per step, per tile and once, and the counts."""
    counts = {k: raw.pop(k) for k in _COUNTS if k in raw}
    steps, tiles = counts["steps"], counts["tiles"]
    return {
        **counts,
        "per_step": {k: v / steps for k, v in raw.items()
                     if k not in _PER_TILE + _ONCE},
        "per_tile": {k: v / tiles for k, v in raw.items() if k in _PER_TILE},
        "once": {k: v for k, v in raw.items() if k in _ONCE},
        "cycles_per_step": sum(raw.values()) / steps}


def costas(x, phase0, freq0, alpha, beta, fmin, fmax, mode) -> dict:
    """`costas_scan`'s probe build on ``x`` (one launch; the arguments
    as `costas_scan`'s, on the card)."""
    out, raw = run(
        _build.load("sync_loops", probe=True), "costas",
        lambda: _loops._costas_launch(
            _loops._costas_launcher(probe=True), x, phase0, freq0, alpha,
            beta, fmin, fmax, mode, count=False), x.device)
    return {"outputs": out, **table(raw)}


def viterbi(sym, exp_prev, prev, prev_bit) -> dict:
    """`viterbi_decode`'s probe build on ``sym`` (one launch; the
    arguments as `viterbi_decode`'s, on the card)."""
    out, raw = run(
        _build.load("viterbi", probe=True), "viterbi",
        lambda: _viterbi._viterbi_launch(
            _viterbi._viterbi_launcher(probe=True), sym, exp_prev, prev,
            prev_bit, count=False), sym.device)
    return {"outputs": out, **table(raw)}


def mm(*args) -> dict:
    """`mm_scan`'s probe build (one launch; the arguments as
    `mm_scan`'s, on the card).  A tile is a window of the input."""
    out, raw = run(
        _build.load("sync_loops", probe=True), "mm",
        lambda: _clock._mm_launch(_clock._mm_launcher(probe=True), *args,
                                  count=False), args[0].device)
    return {"outputs": out, **table(raw)}


def agc(*args) -> dict:
    """`agc_scan`'s probe build (one launch; the arguments as
    `agc_scan`'s, on the card)."""
    out, raw = run(
        _build.load("seq_loops", probe=True), "agc",
        lambda: _loops._agc_launch(_loops._agc_launcher(probe=True), *args,
                                   count=False), args[0].device)
    return {"outputs": out, **table(raw)}


def pll(*args) -> dict:
    """`pll_scan`'s probe build (one launch; the arguments as
    `pll_scan`'s, on the card)."""
    out, raw = run(
        _build.load("seq_loops", probe=True), "pll",
        lambda: _loops._pll_launch(_loops._pll_launcher(probe=True), *args,
                                   count=False), args[0].device)
    return {"outputs": out, **table(raw)}


IDENTITY_COUNTS = ("patterns", "small_patterns", "sincosf_differ",
                   "sincos_small_differ", "wrap_fast_patterns",
                   "wrap_fast_differ", "wrap_turn_patterns",
                   "wrap_turn_differ", "clip_differ")


def identities(device="cuda") -> dict:
    """The probe build's `costas_identity_check` over all 2^32 float32
    patterns v (``patterns``): among the ``small_patterns`` with |v| <= 4,
    at how many sincosf(v) (``sincosf_differ``) and the kernel's
    `sincos_small` (``sincos_small_differ``) differ from sinf(v), cosf(v)
    in any bit; how many lie below `COSTAS_WRAP_FAST` and at how many of
    all the kernel's `wrap_pi_fast` differs from the division's wrap
    (``wrap_fast_*``); how many lie below `COSTAS_WRAP_TURN` and at how
    many of those `wrap_pi_turn` (``csrc/phase_wrap.cuh``, shared by
    `costas_scan` and `pll_scan`) differs in either of its forms, the
    turn's bits an immediate or a parameter (``wrap_turn_*``); and at
    how many the max.NaN / min.NaN clip differs from the compare-and-
    select clip at the bounds (-1, 1) and (-pi, pi) (``clip_differ``).
    A NaN equals any NaN."""
    fn = _build.load("sync_loops", probe=True).costas_identity_check
    fn.argtypes = [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    counts = torch.zeros(len(IDENTITY_COUNTS), dtype=torch.int64,
                         device=device)
    with torch.cuda.device(counts.device):
        rc = fn(_loops.COSTAS_WRAP_FAST, _loops.COSTAS_WRAP_TURN,
                counts.data_ptr(),
                torch.cuda.current_stream(counts.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"costas_identity_check: launch failed (error "
                           f"{rc})")
    return dict(zip(IDENTITY_COUNTS, counts.tolist()))
