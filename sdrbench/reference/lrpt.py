"""Plain reference of the Meteor-M2 LRPT decoder VFO (``meteor_lrpt_2m4``),
in float64 PyTorch, NumPy and Python floats.

From the configuration and the wideband blocks the benchmark made, it
computes each block's soft symbols and the CVCDUs whose frames end in
it, by the textbook route, every serial loop one step at a time:

1. the VFO mixed to baseband by its own float64 oscillator and decimated
   to the decoder's rate by direct decimating FIRs (`receiver.ddc`, the
   mixed receiver's reference);
2. the root-raised-cosine matched filter (SDR++'s
   ``taps::rootRaisedCosine``: 33 taps, beta 0.6, 72 ksym/s at 150 ksps);
3. FastAGC (``loop/fast_agc.h``): ``out = in gain``, then ``gain +=
   (set_point - |out|) rate``, at most ``max_gain``, from a gain of 1;
4. the 4th-order Costas loop (``meteor_costas.h``): ``out = in
   exp(-i phase)``, error ``sign(re) im - sign(im) re`` clipped to +-1,
   ``freq += beta err`` within +-pi, ``phase += freq + alpha err``
   wrapped to a turn, alpha and beta of a critically damped loop of
   bandwidth 0.005 (``phase_control_loop.h``);
5. Mueller & Muller timing (``clock_recovery/mm.h``, complex mode) with
   its own interpolator: a 128-phase bank of 8 taps cut from a Nuttall
   windowed sinc of 1 024 taps, the phase picked as ``floor(mu 128)``;
   the symbol is emitted in the block that holds the last sample of its
   8-sample window;
6. the deframer: the symbols' (re, im) as the coded pairs, a 64-state
   soft Viterbi (`ccsds.viterbi`) over the whole run, from an unknown
   start state, and of the run turned by 90 degrees too until one of the
   two finds a frame (the 180-degree turns are the ASM's complement);
   the ASM walk of SDR++'s deframer: from the run's first bit, one bit
   at a time until 32 bits lie within 3 of the ASM or of its complement,
   then a whole frame on; the derandomizer, RS(255,223) with
   Berlekamp-Massey, Chien and Forney (`ccsds.rs_decode`) and the
   de-interleave.  A frame is emitted in the block that holds its last
   symbol, and only if all four codewords decode.

Where it departs from SDR++: the VFO has no channel filter at its
bandwidth (SDR++'s ``RxVFO`` lowpass), only the resampler's; the
deframer decodes the whole run at once where SDR++ streams.

Every run starts from rest (zero filter memories, gain 1, phase and
frequency 0, the timing loop at its nominal rate, the deframer unlocked)
at a block boundary; the loops settle within the traffic's
``warm_blocks``.  Nothing here imports the program.

``precision="tf32"`` is the control: every operand of the filters'
products rounded to TF32, and each serial loop's input samples too.

Outputs per block (`run`), float32 as the program's:

- ``syms`` (2, max_out): the valid symbols' real and imaginary parts,
  zero past ``nsyms`` (1,); ``syms_near`` (4 NEAR, max_out), of the
  last block alone: its symbols interpolated at the `NEAR` phases
  either side (`demodulate`'s order, real and imaginary rows in turn),
  for `gaps`;
- ``frames`` (12, 892): the CVCDUs whose frames end in the block, their
  ASMs' positions in ``frame_pos`` (12,) as symbol indices from the
  block's first symbol, ``nframes`` (1,).
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from . import ccsds, design
from .receiver import _no_tf32, ddc
from .wbfm import Arith

MAX_FRAMES = 12  # CVCDUs a block's output holds (a 1 s block ends <= 9)
NEAR = 16  # interpolator phases either side a symbol is compared with
ROTATIONS = ((1.0, 0.0), (0.0, -1.0))  # the symbols times 1 and -1j


def rrc_taps(count: int, beta: float, sps: float) -> np.ndarray:
    """SDR++'s root-raised-cosine taps: ``count`` taps at ``t = i -
    count/2 + 0.5``, ``sps`` samples a symbol, float64."""
    t = np.arange(count, dtype=np.float64) - count / 2.0 + 0.5
    x = t / sps
    out = np.empty(count)
    for i, v in enumerate(x):
        if v == 0.0:
            out[i] = (1.0 + beta * (4.0 / np.pi - 1.0)) / sps
        elif abs(abs(v) - 1.0 / (4.0 * beta)) < 1e-12 / sps:
            out[i] = (beta / (sps * np.sqrt(2.0))) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
        else:
            out[i] = (np.sin(np.pi * v * (1.0 - beta))
                      + 4.0 * beta * v * np.cos(np.pi * v * (1.0 + beta))) / (
                np.pi * v * (1.0 - (4.0 * beta * v) ** 2)) / sps
    return out


def interp_bank(phases: int = 128, taps: int = 8) -> np.ndarray:
    """The M&M interpolator: a Nuttall windowed sinc of ``phases * taps``
    taps at cutoff ``0.5 / phases`` of the rate, gain ``phases``, split
    into ``phases`` rows (`design.polyphase_bank`)."""
    count = phases * taps
    omega = 2.0 * np.pi * 0.5 / phases
    t = np.arange(count, dtype=np.float64) - count / 2.0 + 0.5
    proto = (np.sinc(t * omega / np.pi) * design.cosine_window(t - count / 2.0,
                                                               count)
             * phases * omega / np.pi)
    return design.polyphase_bank(phases, proto)


def critically_damped(bw: float) -> tuple[float, float]:
    zeta = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * zeta * bw + bw * bw
    return 4.0 * zeta * bw / denom, 4.0 * bw * bw / denom


def _sign(v: float) -> float:
    return 1.0 if v > 0.0 else -1.0


def fast_agc(y: np.ndarray, rate: float, set_point: float = 1.0,
             max_gain: float = 10e6) -> np.ndarray:
    out = np.empty_like(y)
    gain = 1.0
    for i, v in enumerate(y.tolist()):
        o = v * gain
        out[i] = o
        gain = min(gain + (set_point - abs(o)) * rate, max_gain)
    return out


def costas4(y: np.ndarray, bw: float) -> np.ndarray:
    alpha, beta = critically_damped(bw)
    out = np.empty_like(y)
    phase = freq = 0.0
    two_pi = 2.0 * math.pi
    for i, v in enumerate(y.tolist()):
        c, s = math.cos(phase), math.sin(phase)
        re = v.real * c + v.imag * s
        im = v.imag * c - v.real * s
        out[i] = complex(re, im)
        err = _sign(re) * im - _sign(im) * re
        err = min(max(err, -1.0), 1.0)
        freq = min(max(freq + beta * err, -math.pi), math.pi)
        phase = phase + freq + alpha * err
        phase -= two_pi * round(phase / two_pi)
    return out


def mueller_muller(y: np.ndarray, block: int, sps: float, omega_gain: float,
                   mu_gain: float, limit: float, bank: np.ndarray):
    """Complex M&M over the run ``y``: (symbols, the block of each, the
    position of each as ``sample * phases + phase``)."""
    P, T = bank.shape
    rows = bank.tolist()
    ext = np.concatenate([np.zeros(T - 1, y.dtype), y]).tolist()
    n = len(y)
    fmin, fmax = sps * (1.0 - limit), sps * (1.0 + limit)
    offset, mu, freq = 0, 0.0, sps
    p1 = p2 = c1 = c2 = 0j
    syms, where, pos = [], [], []
    mul = operator.mul
    while offset < n:
        k = min(max(int(math.floor(mu * P)), 0), P - 1)
        s = sum(map(mul, rows[k], ext[offset:offset + T]))
        c0 = complex(_sign(s.real), _sign(s.imag))
        # Re((s - p2) conj(c1)) - Re((c0 - c2) conj(p1))
        err = ((s.real - p2.real) * c1.real + (s.imag - p2.imag) * c1.imag
               - (c0.real - c2.real) * p1.real
               - (c0.imag - c2.imag) * p1.imag)
        err = min(max(err, -1.0), 1.0)
        freq = min(max(freq + omega_gain * err, fmin), fmax)
        mu = mu + freq + mu_gain * err
        step = math.floor(mu)
        syms.append(s)
        where.append(offset // block)
        pos.append(offset * P + k)
        offset += step
        mu -= step
        p2, p1, c2, c1 = p1, s, c1, c0
    return (np.array(syms, np.complex128), np.array(where, np.int64),
            np.array(pos, np.int64))


def interpolate(y: np.ndarray, pos: np.ndarray, bank: np.ndarray
                ) -> np.ndarray:
    """The M&M interpolator at the positions ``pos`` (``sample * phases +
    phase``, any phase, a sample before or after the run reading zeros),
    all at once."""
    P, T = bank.shape
    ext = np.concatenate([np.zeros(T, y.dtype), y, np.zeros(T, y.dtype)])
    start, phase = np.divmod(pos, P)
    win = ext[(start + 1)[:, None] + np.arange(T)]
    return np.einsum("nt,nt->n", bank[phase], win)


def _soft(syms: np.ndarray, rot: int) -> np.ndarray:
    """The coded soft pairs of the symbols turned by rotation ``rot``."""
    a, b = ROTATIONS[rot]
    z = syms * complex(a, b)
    return np.stack([z.real, z.imag], axis=1).reshape(-1)


def walk(bits: np.ndarray) -> list[tuple[int, bool]]:
    """SDR++'s ASM walk: (position, inverted) of every frame it takes."""
    b = np.asarray(bits, np.uint8)
    hits = dict(ccsds.asm_hits(b))
    out, i = [], 0
    while i + ccsds.FRAME_BITS <= len(b):
        if i in hits:
            out.append((i, hits[i]))
            i += ccsds.FRAME_BITS
        else:
            i += 1
    return out


def _take(bits: np.ndarray, pos: int, inverted: bool):
    fb = bits[pos + 32:pos + ccsds.FRAME_BITS]
    return ccsds.deframe_bytes(fb ^ 1 if inverted else fb)


def deframe(syms: np.ndarray) -> tuple[np.ndarray, list]:
    """The run's decoded bits in the rotation that finds a frame first,
    and the walk's frames [(position, inverted)]."""
    probe = min(len(syms), 3 * ccsds.FRAME_BITS)
    for rot in range(len(ROTATIONS)):
        bits = ccsds.viterbi(_soft(syms[:probe], rot))
        if any(_take(bits, p, inv)[0] is not None for p, inv in walk(bits)):
            bits = ccsds.viterbi(_soft(syms, rot))
            return bits, walk(bits)
    return np.zeros(0, np.uint8), []


def run(cfg: dict, blocks: torch.Tensor, precision: str = "f64") -> dict:
    """``blocks`` (k, block_len) complex, consecutive, from rest -> each
    block's outputs (module docstring), float32, with a leading block
    axis, on ``blocks``' device."""
    with _no_tf32():
        return _run(Arith(precision), cfg, blocks)


def demodulate(ar: Arith, cfg: dict, blocks: torch.Tensor):
    """(symbols complex128, the block of each, ``near``): ``near(lo,
    hi)`` gives symbols ``lo:hi`` at the `NEAR` interpolator phases
    either side, (2 NEAR, hi - lo): the phase before, the phase after,
    two before, two after, ..."""
    dem = cfg["demod"]
    k, n = blocks.shape
    fs, if_rate = float(cfg["samplerate"]), float(dem["samplerate"])
    sps = if_rate / float(dem["symbolrate"])
    x = blocks.reshape(-1).to(torch.complex128)
    y = ddc(ar, cfg, x, float(cfg["vfos"][0]["offset_hz"]), if_rate)
    y = ar.fir(y, rrc_taps(int(dem["rrc_taps"]), float(dem["rrc_beta"]),
                           sps))
    y = ar.op(y).cpu().numpy()
    y = fast_agc(y, float(dem["agc_rate"]))
    y = costas4(_low(ar, y), float(dem["costas_bw"]))
    y = _low(ar, y)
    bank = interp_bank()
    syms, where, pos = mueller_muller(
        y, round(n * if_rate / fs), sps, float(dem["omega_gain"]),
        float(dem["mu_gain"]), float(dem["omega_limit"]), bank)
    def near(lo: int, hi: int) -> np.ndarray:
        return np.stack([interpolate(y, pos[lo:hi] + j, bank)
                         for i in range(1, NEAR + 1) for j in (-i, i)])
    return syms, where, near


def _low(ar: Arith, y: np.ndarray) -> np.ndarray:
    return ar.op(torch.from_numpy(y)).numpy() if ar.low else y


def max_out(cfg: dict) -> int:
    """The program's bound on a block's symbols (M&M's ``max_out``)."""
    dem = cfg["demod"]
    fs, if_rate = float(cfg["samplerate"]), float(dem["samplerate"])
    n = round(int(cfg["block_len"]) * if_rate / fs)
    sps = if_rate / float(dem["symbolrate"])
    worst = max(sps * (1.0 - float(dem["omega_limit"]))
                - float(dem["mu_gain"]), 1.0)
    return int(np.ceil(n / worst)) + 2


def _run(ar: Arith, cfg: dict, blocks: torch.Tensor) -> dict:
    k = blocks.shape[0]
    syms, where, near = demodulate(ar, cfg, blocks)
    width = max_out(cfg)
    out = {"syms": np.zeros((k, 2, width), np.float32),
           "syms_near": np.zeros((1, 4 * NEAR, width), np.float32),
           "nsyms": np.zeros((k, 1), np.float32),
           "frames": np.zeros((k, MAX_FRAMES, ccsds.CVCDU_BYTES), np.float32),
           "frame_pos": np.zeros((k, MAX_FRAMES), np.float32),
           "nframes": np.zeros((k, 1), np.float32)}
    first = np.searchsorted(where, np.arange(k + 1))
    for b in range(k):
        s = syms[first[b]:first[b + 1]][:width]
        out["syms"][b, 0, :len(s)] = s.real
        out["syms"][b, 1, :len(s)] = s.imag
        out["nsyms"][b, 0] = len(s)
    z = near(first[k - 1], first[k - 1] + int(out["nsyms"][k - 1, 0]))
    out["syms_near"][0, 0::2, :z.shape[1]] = z.real
    out["syms_near"][0, 1::2, :z.shape[1]] = z.imag
    # frames are decoded for the last block only: the earlier ones are
    # warm-up
    bits, frames = deframe(syms)
    b = k - 1
    got = 0
    for pos, inv in frames:
        last = pos + ccsds.FRAME_BITS - 1
        if not first[b] <= last < first[b + 1]:
            continue
        data, _ = _take(bits, pos, inv)
        if data is None or got == MAX_FRAMES:
            continue
        out["frames"][b, got] = data
        out["frame_pos"][b, got] = pos - first[b]
        got += 1
    out["nframes"][b, 0] = got
    return {n: torch.from_numpy(v).to(blocks.device) for n, v in out.items()}


SHIFTS = (-2, -1, 0, 1, 2)
OUTLIER = 0.1  # of a symbol's gap (`gaps`): wrong, not rounded
QUANTILE = 0.9  # of the gaps, `symbol_gap`


def _quadrant(s: np.ndarray, q: int) -> np.ndarray:
    return s * (1j ** q)


def gaps(cfg: dict, got: dict, want: dict) -> dict:
    """The numbers compared, over the blocks given (``got`` the program's,
    ``want`` the reference's), each block aligned on its own: the
    program's symbols turned by the quarter turn and moved by the shift
    of at most two symbols (`SHIFTS`: a symbol at a block's edge may
    fall either side) that fit the reference's best, compared where both
    have symbols, each symbol with the nearest of the reference's
    interpolations at the reference's phase and at the `NEAR` phases
    either side (``syms_near``, 1/8 of a sample each way).  The M&M
    loop's interpolator has 128 phases, and the float32 program's timing
    is not float64's: it rounds the loop's rate (``omega += 1e-6 err``
    near 2.08, whose float32 step is 2.4e-7) and drifts ~1e-3 of a sample
    away, so a few percent of the symbols take the phase beside the
    reference's, each off by up to ~0.04 from the reference's symbol; and
    where noise puts a symbol at the slicer's threshold the two sides'
    errors can differ by up to 2, which moves ``mu`` by up to 0.02 of a
    sample (2.6 phases) for the ~100 symbols the loop takes to pull back
    (the worst seen, 6 phases, CPU port at 600 ksps).  Taken at the
    nearest phase, most symbols agree to float32's rounding; the Costas
    loop's slicer flips the same way (a kick of up to 0.028 rad a flip,
    pulled back over ~100 samples), so after a noise burst a few symbols
    stay off by up to ~0.04 (the card, 2 of ~110 blocks):

    - ``symbol_gap``: the `QUANTILE` of the symbols' gaps (the largest
      gap is the chaos's, not the program's);
    - ``symbol_outliers``: the symbols whose gap exceeds `OUTLIER`, and
      those one side has beyond the other's count and the shift;
    - ``frame_mismatch``: CVCDUs, matched by their ASM's position (after
      the shift), that one side has and the other has not, or not byte
      for byte."""
    sym_gap, outliers, mismatch = 0.0, 0, 0
    for b in range(want["syms"].shape[0]):
        def cplx(d, name="syms"):
            s = d[name][b].to("cpu", torch.float64).numpy()
            n = int(d["nsyms"][b, 0])
            return s[0::2, :n] + 1j * s[1::2, :n]
        g, w = cplx(got)[0], cplx(want)
        w = np.concatenate([w, cplx(want, "syms_near")])
        best = None
        for sh in SHIFTS:
            gs, ws = g[max(0, sh):], w[:, max(0, -sh):]
            m = min(len(gs), ws.shape[1])
            for q in range(4):
                med = float(np.median(np.abs(_quadrant(gs[:m], q)
                                             - ws[0, :m]))) if m else 0.0
                if best is None or med < best[0]:
                    best = (med, sh, q, m)
        _, shift, q, m = best
        gs, ws = g[max(0, shift):], w[:, max(0, -shift):]
        d = np.abs(_quadrant(gs[:m], q) - ws[:, :m]).min(axis=0)
        extra = len(gs) + ws.shape[1] - 2 * m
        sym_gap = max(sym_gap,
                      float(np.quantile(d, QUANTILE)) if len(d) else 0.0)
        outliers += int(np.count_nonzero(d > OUTLIER)) + max(0, extra - 2)

        def frames(d, move):
            n = int(d["nframes"][b, 0])
            pos = d["frame_pos"][b, :n].to("cpu").numpy().round().astype(int)
            data = d["frames"][b, :n].to("cpu").numpy().round().astype(int)
            return {int(p) - move: bytes(x.astype(np.uint8).tolist())
                    for p, x in zip(pos, data)}
        fg, fw = frames(got, shift), frames(want, 0)
        mismatch += sum(1 for p in fg.keys() | fw.keys()
                        if fg.get(p) != fw.get(p))
    return {"symbol_gap": sym_gap, "symbol_outliers": float(outliers),
            "frame_mismatch": float(mismatch)}
