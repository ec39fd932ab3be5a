"""Drive sdrtpu_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile FILE  # also writes the torch.profiler
                                          # tables of a steady window of
                                          # each path to FILE (fft),
                                          # FILE.pallas, FILE.receiver,
                                          # FILE.meteor and FILE.pfb

Phases, each fatal:

1. device: a CUDA card is present; its name and power limit; PyTorch's
   default flags (TF32 off);
2. build: every hand-written kernel from ``sdrtpu_torch/csrc`` (nvcc,
   one process per source, started together);
3. kernel check: each kernel against its plain PyTorch version on the
   card at the shapes the main paths and the tests use (chunk_poly is
   data movement, so exact, also at the two plans the receiver path's
   fused groups launch; mix_decimate within 1e-5 of the peak of both
   of its plain versions, the reference's per-sample rotation and the
   kernel's own output rotation, also over a 2.5 M-sample block at the
   band edges and with a ragged channel group), with its time beside
   its bound, its grid on this card and its registers;
4. multichip: `ShardedWbfmPipeline` over every card present, one NCCL
   process a card (built kernels only loaded), on the reference's mesh
   rule (four cards: a (2, 2) channel x time mesh with the halo crossing
   cards; one card: one process on a (1, 1) mesh, no collective), at
   two plans: the 8-VFO flagship (10 Msps, 500 000-sample global blocks,
   ``skip_rotator``, 8 blocks) and BASELINE config 5's 64 VFOs off 50
   Msps (2.5 M-sample blocks, 6 blocks); the gathered audio within 1e-4
   of the unsharded pipeline on the card from block 3, chunk_poly once
   a block on every rank; ms per block per rank, the bytes of the halo,
   all-gather and all-reduce a block, the weak-scaling t1 and tN;
5. tooling: `measure_op` of the flagship's FftDecimatorChain and of a
   317-tap `Fir` at 500 000 samples, `measure_hbm_peak` (at most 105 %
   of the data sheet's 3.35 TB/s), `profile_flagship` of the 8-VFO
   flagship against the H100's peaks (every stage's ``hbm_util`` at
   most 1.05), `four_step_fft` against ``torch.fft.fft`` at N = 65 536;
6. fft flagship: the 8-VFO WBFM pipeline off a 10 Msps capture,
   500k-sample blocks, 65536-bin waterfall at 20 Hz, ``skip_rotator``,
   through ``scan_repeat`` over 256 blocks;
7. pallas path: the same pipeline with ``channelizer_method="pallas"``
   (stage 1 in mix_decimate, one launch per block) and the rotator on;
8. scan kernels: agc_scan and pll_scan against their plain PyTorch loops
   on the card, at the step counts the receiver and the WFM pilot PLL
   launch and one long shape each, timed beside the plain loop, to the
   bit, also a row each kernel's general walk takes; then decim_fir
   against the shift-and-add, to the bit, at the receiver's 13 DDC
   stages, timed at the first and two last stages beside its bytes
   bound, the plain version and a strided ``conv1d``;
9. receiver path: `IQFrontend` + `Receiver.push`/`flush` off one 10 Msps
   capture with a 65536-bin waterfall at 20 Hz and eight VFOs — three
   wfm stereo (one fft channelizer group, K1), two nfm (a second group),
   am, usb and cw (per-VFO DDCs; agc_scan) — over 32 M samples at
   ``scan_batch`` 1 and 8, with a live retune of a grouped and a per-VFO
   channel and a demodulator switch am -> nfm -> am in mid stream; the
   CPU run's agc_scan calls held on the card to the bit and timed (as
   on the live, remote and netclients paths);
10. pll path: `BroadcastFm(pilot_mode="pll", rds_out=True)` over 8 blocks
   of 12 500 samples (pll_scan, one launch per block, each held to the
   bit against the plain loop on the card and one timed);
11. ctcss: an NFM chain with the CTCSS squelch on 50 ms blocks, card
   against CPU, and the squelch op's time per block;
12. sync kernels: costas_scan, mm_scan and viterbi_decode against their
   plain PyTorch versions, at the RDS path's shapes, a few short ones
   and the meteor path's longest Viterbi and M&M block (mm_scan to the
   bit), timed beside the plain versions and at the meteor path's
   shapes;
13. meteor path: the Meteor M2 LRPT chain of examples/meteor_lrpt.py at
   the configuration's published parameters — `MeteorDemod` on 16 blocks
   of 1 s at 150 ksps (costas_mm_scan: the Costas and M&M scans in one
   launch, counted as one costas_scan and one mm_scan), the ambiguity
   resolver's
   Viterbi (viterbi_decode), ASM search and RS(255,223) on the host, a
   `.s` soft-symbol file written and deframed again — every CVCDU but
   at most the first two recovered payload-exact, the host's share of
   each block timed stage by stage; two blocks turned by 90 degrees
   lock on the other rotation; card against CPU over the first block,
   and each kernel held against its plain version on that block's
   inputs; costas_mm_scan on those inputs against costas_scan then
   mm_scan on the card, to the bit, against the plain Costas loop's
   recorded outputs and the plain M&M loop over its own Costas output,
   and the three timed (the `kernels` line's costas_mm_scan entry; its
   costas_scan and mm_scan entries count the meteor path's launches net
   of costas_mm_scan's);
14. rds path: the RDS fixture through `BroadcastFm(pilot_mode="pll")`'s
   tap, `RdsDemod` and `RdsDecoder`: PI 0xF00D, PS "SDRTPU  "; its
   pll_scan calls held and timed as the pll path's;
15. viterbi rates and mm_scan banks (run after the sync kernels):
   viterbi_decode at rates 1/3 and 1/4 with K = 7 and 5, and mm_scan at
   16 taps x 256 phases, 8 x 1024 and 32 x 1600 (past 48 KB of shared
   memory), bit-equal to their plain versions on the card;
16. tf32: TF32 turned on globally; the alias fold, the 317-tap pilot FIR
   and the audio resampler at the flagship's shapes give the bits of the
   default flags;
17. dab path: 10 DAB mode-I frames (EN 300 401 at its published
   parameters) after junk samples, AWGN 0.02: null search on the host,
   the OFDM demodulator on the card, the FIC's four codewords as one
   rate-1/4 viterbi_decode launch a frame; all 120 FIBs CRC-valid and
   equal to those sent; the first frame against the CPU;
18. falcon9 path: 64 RS frames of the Falcon 9 downlink at 6 Msps and
   3.5714 Mbaud in blocks of 60 000 (float mm_scan a block), RS and
   packets on the host; every frame, 0 RS failures, the packets sent;
   the first block against the CPU;
19. kg_sstv, m17 and ryfi paths: KG-STV at 4800 Hz (two frames), M17 at
   48 kHz (an LSF and 16 stream frames, after examples/m17_voice.py's
   alternating preamble and again after a random one), the RyFi link of
   examples/ryfi_link.py (six frames): payloads, callsigns and frame
   numbers those sent and the CPU's (RyFi: over its first 5 blocks);
   the CPU run's plain Costas, M&M and Viterbi calls are launched again
   as the kernels on the card and held;
20. pfb path: the flagship with ``channelizer_method="pfb"`` (the shared
   polyphase filter bank: no hand kernel), the rotator on: every VFO's
   tones, card vs CPU, Msps, the fold's device ms per block;
21. paging path: ten POCSAG pages over the RF chain (`GfskMod` ->
   `Gfsk`, one mm_scan a 4 800-sample block -> `PocsagDecoder`), every
   page the one sent, the CPU's mm_scan calls held on the card; FLEX and
   HRPT frames handed over as tensors on the card;
22. vor path: five bearings, four 1 s blocks each, within 2 degrees,
   card within 0.01 degree of the CPU;
23. atv path: four PAL frames (625 x 945 samples), lines card vs CPU,
   the active region against the image, the frame assembler;
24. scanner path: the band scanner's selftest (two NFM stations found and
   recorded, each WAV its station's tone);
25. live path: network IQ (loopback TCP, i16, the native pump) into the
   receiver path's VFO set and eight paced audio sinks for 8 s paced to
   real time: every sample received, nothing dropped, no underrun after
   the first second, the tones, chunk_poly and agc_scan launches exact,
   card vs CPU on the first two blocks; the real-time factor and the
   send-to-audio latency, with no profiler; the same bytes unpaced; 4 s
   more under the profiler for the busy share; and a fake rtl_tcp
   server at 2.4 Msps u8 into one WFM VFO for 5 s;
26. remote path: ``python -m sdrtpu_torch.apps.server`` (a process of its
   own) serves the receiver capture as an int16 WAV over the SDR++ server
   protocol; `SdrppClient` (i16) feeds the receiver path's VFO set on the
   card for 4.8 s: the SmGui menu round trip and the rate before START;
   in mid stream, each from its own thread, a rigctl ``F`` moving the
   usb VFO onto another station (``f`` reads it back), the web view's
   ``/spectrum.json`` (every station's peak), ``/status.json`` and a
   ``/tune`` moving w2, and `RadioInterface` switching the am VFO to
   nfm and back; every sample the looped capture's wire decode, the
   tones after each event, card vs CPU on the first two blocks; then a
   second session, zstd where there is one, under the profiler;
27. netclients path: one process of fakes serves a SpyServer (int16,
   2.5 Msps, WFM), a Hermes (UDP, 384 kHz, AM) and a Spectran HTTP stream
   (float32, 2 Msps, NFM) for 2 s each; each port client feeds a
   one-VFO receiver on the card: the IQ bit-equal to the wire bytes'
   decode, the tone, the launches.

Around each path's run every kernel's launch count is set to 0 and read,
and must be exact for the seven kernels (fft: chunk_poly 32; pallas:
mix_decimate 256; receiver, pll, meteor, rds, dab, falcon9, kg_sstv,
m17, ryfi, paging, live, remote and netclients: see their phases;
multichip: chunk_poly once a block on each rank; pfb, vor, atv, scanner
and rtl_tcp: none; every other count 0), and on the receiver path
decim_fir's too (13 a block, one a DDC stage); then the same port runs on the
CPU (multichip: the unsharded pipeline on the card), and the card's
output is held against it.

Standard output: the card line, the ``kernels`` JSON line, the fft
flagship line, the pallas path line, the receiver, pll, ctcss, meteor,
rds, tf32, dab, falcon9, kg_sstv, m17, ryfi, pfb, paging, vor, atv, live,
scanner, remote, netclients, multichip and tooling lines, the timer
fallbacks line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from sdrtpu_torch import roofline as rooflib  # the card's peaks and bounds
K2_REL_TOL = 1e-5  # mix_decimate vs plain: max_abs_err / max|plain|
AUDIO_ATOL = 2e-4  # card vs CPU audio, as tests/test_torch_pipeline.py
SPEC_DB_ATOL = 0.02  # card vs CPU waterfall bins within 80 dB of the peak
# One step's dependent chain, for the serial bound of the scan kernels:
# cycles per dependent float32 operation and per IEEE division (assumed
# latencies of the SM's FP32 pipe and of the division's reciprocal plus
# refinement sequence), times the operations on the carry's path.
DEP_OP_CYCLES, DEP_DIV_CYCLES = 4, 36
# AGC, PR 11's threshold walk: mul, add, the ia > amp select, the compare
# with the sample's threshold, the select of the suffix maximum (the
# division and the clip test's product are off the chain)
AGC_CHAIN = (5, 0)
AGC_CHAIN_PR5 = (8, 1)  # mul add select select | div | min mul compare select
# PLL, the bounded walk: subtract, wrap (compare, select, subtract:
# 3), mul, add, clip (2), add, add, wrap (3); the divisions are gone
PLL_CHAIN = (13, 0)
PLL_CHAIN_PR4 = (13, 2)  # the same with each wrap a division and 3 ops
# Costas (order 4), as PR 10 walks a row whose phase stays bounded (every
# row of the driven paths): sine and cosine (`sincos_small`: multiply,
# round by an add and a subtract, three-part reduction, square, four
# polynomial steps, quadrant and sign selects: 13), mix (2), error
# (compare, select, subtract: 3), clip (2), freq (multiply, add, clip: 4),
# phase (add, add: 2), wrap (compare, select, subtract: 3)
COSTAS_CHAIN = (29, 0)
# the PR 5 kernel's: neg, sinf/cosf (~20), mix (2), error (3), clip (2),
# freq (4), phase add add, wrap (div + 3)
COSTAS_CHAIN_PR5 = (36, 1)
# the error's part of those chains by mode (order 4's is the 3 above):
# order 2 a product (1); order 8 a select, a product, a difference and a
# select (5); broken atan2f (~20 and a division), a difference, the wrap
# (3; in PR 5 a division and 3 more), the first of four minima (6), a
# product (31 and 1 division; PR 5: 31 and 2).  PR 5 reckoned every
# order with order 4's chain, and those figures are kept as they were.
COSTAS_ERROR_OPS = {0: ((1, 0), (3, 0)), 1: ((3, 0), (3, 0)),
                    2: ((5, 0), (3, 0)), 3: ((31, 1), (31, 2))}


def costas_chains(mode: int) -> tuple:
    """(this design's, PR 5's) reckoned chain of a step in ``mode``."""
    (ops, divs), (ops5, divs5) = COSTAS_ERROR_OPS[mode]
    return ((COSTAS_CHAIN[0] - 3 + ops, COSTAS_CHAIN[1] + divs),
            (COSTAS_CHAIN_PR5[0] - 3 + ops5, COSTAS_CHAIN_PR5[1] + divs5))
# M&M, PR 11's batched step: the next bank row from nphase (multiply,
# cvt.rmi, subtract, address: 4), the shared-memory bank read (~8), mul,
# pairwise sum (3), error (out - p2, mul, add, subtract: 4; the p1 product
# taken for both signs beforehand), clip (2), freq (4), phase (2)
MM_CHAIN = (28, 0)
# the PR 5 kernel's: phase*P floor clamp (4), shared-memory bank and window
# reads (~8), mul, pairwise sum (3), error (4), clip (2), freq (4), phase
# (2), floor, subtract, offset (3), window address (2)
MM_CHAIN_PR5 = (38, 0)
# Viterbi, PR 10: subtract the maximum, add the branch metric, compare
# and select (2), key (2), the lane's larger key, redux.sync (~6, as a
# shuffle), key back to float (2); the four predecessor shuffles and their
# select (~7) run beside the key, redux and back; the traceback, 32 chunks
# at once, adds ~(n / 32 + 512) x 6, under one a step at the path's n
VITERBI_CHAIN = (15, 0)
# the PR 5 kernel's: add-compare-select (shared-memory read ~8, add,
# compare and select 2, five shuffles ~30, subtract, write and warp
# barrier ~8), then the traceback (~6)
VITERBI_CHAIN_PR5 = (56, 0)
COSTAS_REL_TOL = 1e-5     # costas_scan vs plain: of the output's peak
COSTAS_PHASE_ATOL = 1e-4  # costas_scan vs plain: carried phase and freq
# MeteorDemod on the card vs the port on the CPU (the thresholds of
# tests/test_oracle_parity.py:386-393)
METEOR_SYM_ATOL, METEOR_CLOSE_SHARE, METEOR_BYTE_SHARE = 2e-2, 0.995, 0.99


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def smi_id() -> str:
    """nvidia-smi's id of the card this process uses: its UUID."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return f"GPU-{props.uuid}"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", smi_id()],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


PROFILER_TAKES = 5
TIMER_FALLBACKS: list[dict] = []  # device_ms calls timed by CUDA events


def cuda_ms(fn, reps: int) -> float:
    """CUDA-event time of ``fn()`` per call over ``reps`` back-to-back
    calls, after warm-up.  Where the host enqueues more slowly than the
    card runs, this is the host's rate: see `device_ms`."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled(fn):
    """Run ``fn()`` under torch.profiler; returns (profile, wall seconds,
    device-busy microseconds).  Kernels run on one stream, so the sum of
    their intervals is the time the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return prof, wall, busy


class SmClocks:
    """Samples the SM clock of the card in use every 20 ms with
    ``nvidia-smi -lms`` while the ``with`` block runs; ``summary()`` gives
    min, median and max in MHz.  The sampler process is ended on exit."""

    def __enter__(self):
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "20", "-i", smi_id()],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        out, _ = self._proc.communicate(timeout=30)
        self.mhz = [float(v) for v in out.split() if v.strip().isdigit()]

    def summary(self) -> dict:
        if not self.mhz:
            return {"samples": 0}
        return {"samples": len(self.mhz), "min": min(self.mhz),
                "median": float(np.median(self.mhz)), "max": max(self.mhz)}


def kernel_ms_per_launch(prof, names) -> dict:
    """Device ms per launch of each kernel whose name contains one of
    ``names``, from a profile."""
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.count:
                total = getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
                out[name] = total / e.count / 1e3
    return out


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Device ms per call of ``fn()`` over ``reps`` back-to-back calls,
    from the profiler: for each kernel name, its mean per launch times
    its launches per call, ceil(launches the trace holds / reps).  A
    trace of back-to-back launches has been seen to hold only some of
    them (1 to 4 of 5 at tens of ms each), so busy time / reps would
    read low.  With ``kernel``, only the kernels whose name contains it.
    A short trace is logged; one with no such launch is taken again.  The
    profiler has also been seen to lose every launch of a kernel over
    three takes in a row, so after `PROFILER_TAKES` empty takes the calls
    are timed with CUDA events instead (`cuda_ms`: the whole call, any
    other kernel of ``fn`` and the host's enqueue rate included, so it
    reads high) and the fallback is logged and counted in
    `TIMER_FALLBACKS`."""
    fn()
    for take in range(PROFILER_TAKES):
        prof, _, _ = profiled(lambda: [fn() for _ in range(reps)])
        by_name = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and (kernel is None or kernel in e.name)):
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        short = {k: n for k, (n, _) in by_name.items() if n % reps}
        if short:
            log(f"device_ms: take {take + 1}: the trace holds {short} "
                f"launches over {reps} calls")
        if by_name:
            return sum(us / n * -(-n // reps)
                       for n, us in by_name.values()) / 1e3
    ms = cuda_ms(fn, reps)
    TIMER_FALLBACKS.append({"kernel": kernel, "reps": reps, "event_ms": ms})
    log(f"device_ms: the profiler saw no {kernel or 'kernel'} launch in "
        f"{PROFILER_TAKES} takes; CUDA events give {ms} ms a call")
    return ms


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    # PyTorch's defaults; the port pins float32 in its contractions itself
    # (`phase_tf32` turns TF32 on to show it)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    card = card_line()
    print(f"card: {card}", flush=True)
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    """Every CUDA source with nvcc, all started together; then the
    native IO library with g++ (the live
    path's pump: it must be there, and built before the live session,
    whose first connection would otherwise wait for g++)."""
    from sdrtpu_torch import _build, native

    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.2f} s cached={r['cached']}\n{r['log']}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the native IO library did not build")
    log(f"native IO library: {time.perf_counter() - t0:.2f} s "
        f"({native.lib_path().name})")
    return report


def ptxas_usage(build_log: str, *instance: str) -> dict:
    """Registers, static shared bytes and spill bytes that ptxas reports
    for the kernel whose mangled name contains every part of
    ``instance``."""
    for block in build_log.split("Compiling entry function")[1:]:
        if not all(part in block.split("'")[1] for part in instance):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        return {"registers": int(regs.group(1)),
                "static_shared_bytes": int(smem.group(1)) if smem else 0,
                "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                if spill else 0)}
    raise AssertionError(f"no ptxas report for {instance}")


def receiver_plans() -> dict:
    """(valid, ratio, nif, chunks per block) of each fused group of the
    receiver path's front end: what its channelizers hand chunk_poly."""
    from sdrtpu_torch.apps.receiver import IQFrontend, VfoConfig

    fe = IQFrontend(RX_FS, {n: VfoConfig(o, m)
                            for n, (o, m) in RX_VFOS.items()},
                    fft_size=65536, fft_rate=20.0, device="cpu")
    fe.bind(RX_BLOCK)
    plans = {}
    for if_rate, (_, chan) in fe._groups.items():
        assert chan.method == "fft", (if_rate, chan.method)
        f = chan.fused
        plans[f"{if_rate:.0f}"] = (f.valid, f.ratio, f.nif, f.n_chunks)
    assert len(plans) == 2, plans
    return plans


def multichip_plans() -> dict:
    """(valid, ratio, nif, chunks per block) of each rank's FFT front on
    the multichip path, for each plan of `MULTICHIP_PLANS` at one and two
    time-ranks: what `ShardedWbfmPipeline` hands chunk_poly."""
    from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline
    from sdrtpu_torch.shard.channelizer import FftDecimatorChain

    plans = {}
    for name, (n_vfo, fs, block, _) in MULTICHIP_PLANS.items():
        offsets = np.linspace(-0.4 * fs, 0.4 * fs, n_vfo)
        rr = WbfmMultiVfoPipeline(offsets, fs, block,
                                  channelizer_method="fft", skip_rotator=True,
                                  device="cpu").channelizer.resampler
        stages = [(s.taps, s.decimation) for s in rr.predecim.stages]
        for n_time in (1, 2):
            f = FftDecimatorChain(offsets, fs, stages, block // n_time,
                                  skip_rotator=True, device="cpu")
            plans[f"{name}/{n_time}"] = (f.valid, f.ratio, f.nif,
                                         f.n_chunks)
    return plans


def phase_kernels(flagship_plan, rx_plans: dict,
                  mc_plans: dict) -> list[dict]:
    """chunk_poly against chunk_poly_ref, exact, at every checked shape
    (the test shapes, the flagship's sub-window, the 64-VFO plan, the
    receiver path's two fused groups and the multichip path's rank
    fronts), each timed beside its plain version and the one-call
    library copy.  The JSON entry's own numbers are at the flagship
    sub-window shape (what the fft path launches); the receiver path's
    shapes stand under ``receiver_shapes``, the multichip path's under
    ``multichip_shapes``.  ``ms``
    is time on the card from the profiler, ``event_ms`` CUDA events over
    back-to-back calls."""
    from sdrtpu_torch.kernels import chunks

    gen = torch.Generator(device="cuda").manual_seed(0)
    valid, R, nif, P_main = flagship_plan
    shapes = [
        (1600, 8, 256, 10),        # tests/test_pallas_chunks.py shapes
        (4000, 40, 128, 10),
        (25600, 200, 128, 5),
        (valid, R, nif, P_main),   # 8-VFO flagship, one 4M-sample window
        (20000, 200, 128, 125),    # 64-VFO plan, one 2.5M-sample block
    ]
    # the receiver path: one launch per fused group and 2M-sample block
    shapes += [s for s in rx_plans.values() if s not in shapes]
    # the multichip path: one launch per rank and block
    shapes += [s for s in mc_plans.values() if s not in shapes]
    worst = 0.0
    timings = {}
    for v, r, q, p in shapes:
        tpad = r * q - v + 1
        L = p * v + tpad - 1  # what FftDecimatorChain passes: tail ++ window
        ext = torch.randn(L, dtype=torch.complex64, device="cuda",
                          generator=gen)
        got = chunks.chunk_poly(ext, v, r, q, p)
        want = chunks.chunk_poly_ref(ext, v, r, q, p)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"chunk_poly disagrees at {(v, r, q, p)}: "
                                 f"max_abs_err {err}")
        worst = max(worst, err)
        need = (p - 1) * v + r * q
        padded = torch.cat([ext, ext.new_zeros(max(0, need - L))])

        def library(padded=padded, v=v, r=r, q=q, p=p):
            return padded.unfold(0, r * q, v)[:p].view(p, q, r).transpose(
                1, 2).contiguous()

        nbytes = 8 * L + 8 * p * r * q
        fns = {"": lambda: chunks.chunk_poly(ext, v, r, q, p),
               "plain_": lambda: chunks.chunk_poly_ref(ext, v, r, q, p),
               "library_": library}
        timings[(v, r, q, p)] = t = {
            "bound_ms": rooflib.bound(nbytes, 0)["bound_ms"]}
        for key, fn in fns.items():
            t[key + "ms"] = device_ms(
                fn, 20, "chunk_poly_kernel" if key == "" else None)
            t[key + "event_ms"] = cuda_ms(fn, 50)
        log(f"chunk_poly {(v, r, q, p)}: exact; {timings[(v, r, q, p)]}")
    main = timings[(valid, R, nif, P_main)]
    return [{
        "name": "chunk_poly",
        "route": "cuda",
        "source": "sdrtpu_torch/csrc/chunk_poly.cu",
        "replaces": "sdrtpu/kernels/pallas_chunks.py:102",
        "launches": None,  # filled in from the flagship run
        "max_abs_err": worst,
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
        # CUDA events over back-to-back calls (host enqueue included)
        "event_ms": main["event_ms"],
        "plain_event_ms": main["plain_event_ms"],
        "library_event_ms": main["library_event_ms"],
        "shape": [valid, R, nif, P_main],
        "other_shapes": [
            {"shape": list(k), **{n: round(t, 6) for n, t in v.items()}}
            for k, v in timings.items()
            if k != (valid, R, nif, P_main) and k not in rx_plans.values()
            and k not in mc_plans.values()],
        "receiver_shapes": [
            {"group_if_hz": g, "shape": list(k),
             **{n: round(t, 6) for n, t in timings[k].items()}}
            for g, k in rx_plans.items()],
        "multichip_shapes": [
            {"plan_n_time": g, "shape": list(k),
             **{n: round(t, 6) for n, t in timings[k].items()}}
            for g, k in mc_plans.items()],
    }]


def phase_mix_decimate(build: dict) -> dict:
    """mix_decimate against `mix_decimate_ref` and against
    `mix_decimate_modulated_ref` at every checked shape, within
    K2_REL_TOL of the plain version's peak, each timed beside its plain
    version and the two-call library copy (one elementwise mix, then one
    strided ``F.conv1d``).  The JSON entry's own numbers are at the
    flagship block (what the pallas path launches); the bound is the
    function's work (its arguments and output moved once; 12 flops per
    sample and channel of mixing plus 4T per output), whatever
    implements it."""
    import torch.nn.functional as F

    from sdrtpu_torch.kernels import fused_channelizer as fc
    from sdrtpu_torch.kernels.resample import RationalResampler

    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(5)
    stage1 = {fs: RationalResampler(fs, 250e3, device="cpu").predecim.stages[0]
              for fs in (10e6, 50e6)}
    flagship = (8, 10e6, 500_000)
    shapes = [  # (C, fs, n, M, T): tests/test_pallas_channelizer.py shapes
        (4, 10e6, fc.TILE_IN, 8, 36), (4, 10e6, fc.TILE_IN, 4, 20),
        (2, 10e6, fc.TILE_IN + 40000, 8, 36),
        flagship,                  # 8-VFO flagship block, its own taps
        (64, 50e6, 2_500_000),     # 64-VFO plan block, its own taps
        (9, 10e6, 100_000, 8, 36),  # a ragged channel group: 8 + 1
        (2, 10e6, 2_500_000, 8, 36, 0.45),  # long block at the band edges
    ]
    worst = 0.0
    rows = {}
    for shape in shapes:
        C, fs, n = shape[:3]
        if len(shape) >= 5:
            M, T = shape[3:5]
            h = rng.standard_normal(T).astype(np.float32)
            h /= np.abs(h).sum()
        else:
            h, M = np.asarray(stage1[fs].taps), stage1[fs].decimation
        edge = shape[5] if len(shape) == 6 else 0.4
        stage = fc.FusedChannelizerStage(
            np.linspace(-edge * fs, edge * fs, C), fs, h, M, n, device="cuda")
        T = stage.T
        tail = torch.randn(T - 1, dtype=torch.complex64, device="cuda",
                           generator=gen)
        x = torch.randn(n, dtype=torch.complex64, device="cuda", generator=gen)
        phase = torch.rand(C, device="cuda", generator=gen) * 6.28
        args = (tail, x, stage._coarse, stage._fine, stage._taps, phase, M)
        got = fc.mix_decimate(*args)
        want = fc.mix_decimate_ref(*args)
        modulated = fc.mix_decimate_modulated_ref(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        mod_err = (got - modulated).abs().max().item()
        del modulated
        scale = want.abs().max().item()
        if not max(err, mod_err) <= K2_REL_TOL * scale:
            raise AssertionError(
                f"mix_decimate disagrees at {(C, n, M, T)}: max_abs_err {err} "
                f"(plain), {mod_err} (modulated form), peak {scale}")
        worst = max(worst, err / scale, mod_err / scale)

        # the library copy: rotation table materialised beforehand
        ext = torch.cat([tail, x])
        e = torch.arange(ext.shape[0], device="cuda")
        c_rot = stage._coarse * torch.exp(1j * phase)[:, None]
        rot = c_rot[:, e // fc.ROW] * stage._fine[:, e % fc.ROW]
        w = stage._taps.expand(2, 1, T).contiguous()  # conv1d correlates

        def library(ext=ext, rot=rot, w=w, M=M):
            mixed = torch.view_as_real(ext[None, :] * rot).permute(0, 2, 1)
            return F.conv1d(mixed, w, stride=M, groups=2)

        lib = library()
        lib_err = (torch.complex(lib[:, 0], lib[:, 1]) - want).abs().max().item()
        del rot, lib
        nbytes = sum(a.numel() * a.element_size() for a in args[:-1]) + (
            got.numel() * got.element_size())
        flops = C * (n + T - 1) * 12 + C * (n // M) * 4 * T
        t = {"shape": [C, n, M, T], "max_abs_err": err, "peak": scale,
             "modulated_max_abs_err": mod_err,
             "library_max_abs_err": lib_err,
             "bytes": nbytes, "flops": flops, **roofline(nbytes, flops),
             **fc.launch_plan(n, C, M, T)}  # the grid on this card
        fns = {"": lambda: fc.mix_decimate(*args),
               "plain_": lambda: fc.mix_decimate_ref(*args),
               "library_": library}
        for key, fn in fns.items():
            t[key + "ms"] = device_ms(
                fn, 20, "mix_decimate_kernel" if key == "" else None)
            t[key + "event_ms"] = cuda_ms(fn, 20)
        if shape == flagship:
            # the wrapper's host time per call: checks, output allocation
            # and launch, nothing waited for inside the loop
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(256):
                fc.mix_decimate(*args)
            t["host_us"] = (time.perf_counter() - t0) / 256 * 1e6
            torch.cuda.synchronize()
        rows[shape] = t
        log(f"mix_decimate {(C, n, M, T)}: {t}")
        del ext, e, c_rot, w, args, got, want
        torch.cuda.empty_cache()
    main = rows[flagship]
    usage = ptxas_usage(
        build["log"], f"mix_decimate_kernelILi{main['shape'][2]}E",
        f"ShapeILi{main['threads']}ELi{main['outputs_per_lane']}E")
    return {
        "name": "mix_decimate",
        "route": "cuda",
        "source": "sdrtpu_torch/csrc/mix_decimate.cu",
        "replaces": "sdrtpu/kernels/pallas_channelizer.py:68",
        "launches": None,  # filled in from the pallas path's run
        "max_abs_err": main["max_abs_err"],
        "rel_tol": K2_REL_TOL,
        "worst_rel_err": worst,
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # one elementwise mix + one strided F.conv1d: no single call
        "library_ms": main["library_ms"],
        "library_calls": 2,
        "event_ms": main["event_ms"],
        "plain_event_ms": main["plain_event_ms"],
        "library_event_ms": main["library_event_ms"],
        "host_us": main["host_us"],
        # Facts of the build, not of this run's timing: ptxas' report for
        # the M and tile shape of the flagship, from the log kept beside
        # the library this run loaded (``cached``: built by an earlier
        # run from the same source and flags); the windows are dynamic
        # shared memory, which only the launcher knows.
        "build": {"cached": build["cached"],
                  "seconds": build["seconds"],
                  "registers": usage["registers"],
                  "spill_bytes": usage["spill_bytes"],
                  "shared_bytes": (usage["static_shared_bytes"]
                                   + main["dynamic_shared_bytes"])},
        "threads": main["threads"],
        "outputs_per_lane": main["outputs_per_lane"],
        "tiles_per_warp": main["tiles_per_warp"],
        "ctas": main["ctas"],
        "ctas_per_sm": main["ctas_per_sm"],
        "resident_ctas_per_sm": main["resident_ctas_per_sm"],
        "waves": main["waves"],
        "sms": main["sms"],
        "shape": main["shape"],
        "other_shapes": [v for k, v in rows.items() if k != flagship],
    }


def flagship_capture(offsets, fs, n) -> np.ndarray:
    """bench.py's synthetic capture: one FM station with a tone program
    at each VFO offset."""
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex64)
    for i, fc in enumerate(offsets):
        msg = np.sin(2 * np.pi * (500.0 + 300.0 * i) * t)
        phase = np.cumsum(2 * np.pi * 75000.0 * msg / fs)
        x += (0.1 * np.exp(1j * (2 * np.pi * fc * t + phase))).astype(
            np.complex64)
    return x


def stereo_capture(offsets, fs, n) -> np.ndarray:
    """One stereo FM station at each offset: L and R tones, a 19 kHz
    pilot and the 38 kHz L-R subcarrier, as tests/test_scan_call.py."""
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex128)
    for i, fc in enumerate(offsets):
        left = np.sin(2 * np.pi * (400 + 150 * i) * t)
        right = np.sin(2 * np.pi * (900 + 150 * i) * t)
        mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
        phase = np.cumsum(2 * np.pi * 75000.0 * mpx / fs)
        x += 0.1 * np.exp(1j * (2 * np.pi * fc * t + phase))
    return x.astype(np.complex64)


def build_flagship(device, method: str = "fft"):
    """The 8-VFO flagship; the fft path skips the residual rotator (the
    benchmark default), the others must keep it."""
    from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline

    fs, n_vfo, block = 10_000_000.0, 8, 500_000
    offsets = np.linspace(-0.4 * fs, 0.4 * fs, n_vfo)
    pipe = WbfmMultiVfoPipeline(offsets, fs, block, spectrum=True,
                                fft_size=65536, fft_rate=20.0,
                                channelizer_method=method,
                                skip_rotator=method == "fft", device=device)
    assert pipe.channelizer.method == method
    return pipe, flagship_capture(offsets, fs, block)


def kernel_counters() -> dict:
    from sdrtpu_torch.fec import viterbi
    from sdrtpu_torch.kernels import chunks, clock, fused_channelizer, loops

    return {"chunk_poly": chunks.chunk_poly,
            "mix_decimate": fused_channelizer.mix_decimate,
            "agc_scan": loops.agc_scan, "pll_scan": loops.pll_scan,
            "costas_scan": loops.costas_scan, "mm_scan": clock.mm_scan,
            "costas_mm_scan": clock.costas_mm_scan,
            "viterbi_decode": viterbi.viterbi_decode}


def expected_launches(**counts) -> dict:
    """Every kernel's expected launch count on a path: 0 unless given."""
    want = dict.fromkeys(kernel_counters(), 0)
    want.update(counts)
    return want


def phase_path(card: str, method: str, K: int = 256,
               profile_path: str | None = None) -> dict:
    """One path of the flagship on the card: launch counts around a
    K-block ``scan_repeat``, card vs CPU, throughput, device busy."""
    from sdrtpu_torch.convert import state_from_jax, state_to_numpy

    pipe, x_host = build_flagship("cuda", method)
    block = pipe.block_len
    x = torch.as_tensor(x_host, device="cuda")
    state = pipe.init_state()
    # warm-up: one sub-window (cuFFT/cuBLAS plans, kernel load)
    sub = pipe._subk(K)
    state, _ = pipe.scan_repeat(state, x, sub)
    torch.cuda.synchronize()

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    state, (audio, spec) = pipe.scan_repeat(state, x, K)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"fft": expected_launches(chunk_poly=K // sub),
            "pallas": expected_launches(mix_decimate=K),
            "pfb": expected_launches()}[method]
    if launches != want:
        raise AssertionError(f"{method} path launched {launches}, want {want}")

    n_af = pipe.out_len(block)
    assert audio.shape == (K, 2, 8, n_af), audio.shape
    assert spec.shape == (K, 1, 65536), spec.shape
    assert bool(torch.isfinite(audio).all()) and bool(torch.isfinite(spec).all())
    a_std = audio.std().item()
    wf_max = spec.max().item()
    assert a_std > 1e-4, f"no audio produced (std {a_std})"
    assert wf_max > -80.0, f"waterfall saw no signal (max {wf_max} dB)"

    # the same port on the CPU, from the card's mid-stream state, on
    # (a) one more block of the bench capture (no pilot, so the envelope
    # normalisation divides rounding noise: reported, not held) and
    # (b) two blocks of a stereo capture with a 19 kHz pilot, whose
    # second block is held at AUDIO_ATOL (the first refills the filters)
    cpu_pipe, _ = build_flagship("cpu", method)
    host_state = state_to_numpy(state)
    _, (a_cpu, _) = cpu_pipe(state_from_jax(host_state, "cpu"),
                             torch.as_tensor(x_host))
    _, (a_gpu, _) = pipe(state, x)
    bench_err = (a_gpu.cpu() - a_cpu).abs().max().item()

    stereo = stereo_capture(pipe.offsets, 10_000_000.0, 2 * block)
    st_c = state_from_jax(host_state, "cpu")
    st_g = state
    a_blocks = []
    for b in range(2):
        xb = stereo[b * block:(b + 1) * block]
        st_c, (a_cpu, s_cpu) = cpu_pipe(st_c, torch.as_tensor(xb))
        st_g, (a_gpu, s_gpu) = pipe(st_g, torch.as_tensor(xb, device="cuda"))
        a_blocks.append(a_gpu.cpu().numpy())
    a_err = (a_gpu.cpu() - a_cpu).abs().max().item()
    if not a_err <= AUDIO_ATOL:
        raise AssertionError(f"{method}: card audio vs CPU: max_abs_err {a_err}")
    s_gpu = s_gpu.cpu()
    live = s_cpu > s_cpu.amax(dim=-1, keepdim=True) - 80.0
    s_err = (s_gpu - s_cpu)[live].abs().max().item()
    if not s_err <= SPEC_DB_ATOL:
        raise AssertionError(
            f"{method}: card waterfall vs CPU: max_abs_err {s_err} dB")
    tail_err = (st_g["chan"]["fused"]["tail"].cpu()
                - st_c["chan"]["fused"]["tail"]).abs().max().item()
    assert tail_err == 0.0, tail_err
    # each VFO's left and right tones over the two stereo blocks (10 Hz
    # bins; the tones are multiples of 10 Hz)
    a2 = np.concatenate(a_blocks, axis=-1)
    recovered = [[dominant_hz(a2[0, c]), dominant_hz(a2[1, c])]
                 for c in range(a2.shape[1])]
    for c, (left, right) in enumerate(recovered):
        if abs(left - (400 + 150 * c)) > 10 or abs(right - (900 + 150 * c)) > 10:
            raise AssertionError(f"{method}: VFO {c} recovered {left}, "
                                 f"{right} Hz, sent {400 + 150 * c}, "
                                 f"{900 + 150 * c}")

    # throughput: 5 more passes of K blocks, host clock around each
    passes = []
    st_t = state
    for _ in range(5):
        t0 = time.perf_counter()
        st_t, _ = pipe.scan_repeat(st_t, x, K)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    dt = float(np.median(passes))

    # where the time goes: 4 more sub-windows under the profiler
    prof, p_wall, busy_us = profiled(
        lambda: pipe.scan_repeat(state, x, 4 * sub))
    busy_ms_block = busy_us / 1e3 / (4 * sub)
    if profile_path:
        os.makedirs(os.path.dirname(profile_path) or ".", exist_ok=True)
        with open(profile_path, "w") as fh:
            fh.write(f"{card}\n{method} path: 4 sub-windows of {sub} blocks; "
                     f"wall {p_wall * 1e3:.3f} ms under the profiler; device "
                     f"busy {busy_us / 1e3:.3f} ms\n")
            fh.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40))
        log(f"profile -> {profile_path}")

    ch = pipe.channelizer
    extra = {}
    if method == "fft":
        what = "skip_rotator"
        plan = [ch.fused.valid, ch.fused.ratio, ch.fused.nif, ch.fused.nfft]
    elif method == "pfb":
        what = "channelizer pfb, rotator on"
        pf = ch.fused
        plan = {"M": pf.M, "D": pf.D, "tpp": pf.tpp,
                "fold_launches": 2 * pf.tpp - 1}
        # the fold of one sub-window (2*tpp - 1 elementwise launches on a
        # strided view), device time from the profiler, per block
        F = sub * block // pf.D
        ext = torch.zeros(pf.L - pf.D + sub * block, dtype=torch.complex64,
                          device="cuda")
        ext[pf.L - pf.D:] = x.repeat(sub)
        fold_ms = device_ms(lambda: pf.fold(ext, F), 5) / sub
        del ext
        # the fold's least work a block: read the block once, write its
        # F x M outputs once; 8 float32 operations a tap and output
        bound = roofline(8 * block + 8 * (block // pf.D) * pf.M,
                         8 * (block // pf.D) * pf.M * pf.tpp)
        extra = {"fold_ms_per_block": fold_ms,
                 "fold_bound_ms_per_block": bound["bound_ms"],
                 "fold_bound_by": bound["bound_by"]}
    else:
        what = "channelizer pallas, rotator on"
        plan = [[ch.fused.decim, ch.fused.T]] + [
            [s.decimation, s.ntaps] for s in ch.rest_stages]
    return {
        "flagship": "wbfm 8 VFO, 10 Msps, 500k-sample blocks, waterfall "
                    f"65536 @ 20 Hz, {what}",
        "K": K, "sub_window_blocks": sub,
        "plan": plan,
        "kernel_launches": launches,
        "msps": K * block / dt / 1e6,  # median pass
        "msps_passes": [K * block / t / 1e6 for t in passes],
        "ms_per_block": dt * 1e3 / K,
        "audio_std": a_std, "waterfall_max_db": wf_max,
        "recovered_left_right_hz": recovered,
        "audio_vs_cpu_max_abs_err": a_err,
        "bench_capture_audio_vs_cpu_max_abs_err": bench_err,
        "waterfall_vs_cpu_max_abs_db": s_err,
        "device_busy_ms_per_block": busy_ms_block,
        "device_busy_share": busy_ms_block / (dt * 1e3 / K),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        **extra,
        "card": card,
    }


def wall_ms(fn) -> float:
    """Host-clock time of one ``fn()`` on the card, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def roofline(nbytes: int, flops: int) -> dict:
    """The contract's bound: the larger of bytes over the card's memory
    rate and float32 operations over its peak rate, and which it is
    (`sdrtpu_torch.roofline.bound`)."""
    return rooflib.bound(nbytes, flops)


def serial_chain_ms(steps: int, chain) -> float:
    """steps x the dependent latency of one step at the card's SM clock."""
    ops, divs = chain
    cycles = ops * DEP_OP_CYCLES + divs * DEP_DIV_CYCLES
    hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    return steps * cycles / hz * 1e3


# the AGC of the receiver's am chain at 15 kHz (attack 50 Hz, decay 5 Hz,
# set point 1, max gain 1e7, max output 10) as agc_scan's coefficients
AGC_COEF = tuple(float(v) for v in (
    np.float32(1) - np.float32(50.0 / 15000.0), np.float32(50.0 / 15000.0),
    np.float32(1) - np.float32(5.0 / 15000.0), np.float32(5.0 / 15000.0),
    1.0, 1e7, 10.0))


def agc_row(rng, rows: int, n: int, cplx: bool) -> tuple:
    """agc_scan's |x| and suffix maximum on the card for noise of 1e-3
    (complex with ``cplx``), four silent samples first (the average stays
    0) and a burst of three 3e4 times as loud half way (it trips the
    clipping look-ahead)."""
    x = 1e-3 * rng.standard_normal((rows, n))
    if cplx:
        x = x + 1e-3j * rng.standard_normal((rows, n))
    x[:, :4] = 0.0
    x[:, n // 2:n // 2 + 3] *= 3e4
    x = torch.as_tensor(x.astype(np.complex64 if cplx else np.float32),
                        device="cuda")
    in_amp = x.abs().float().contiguous()
    smax = in_amp.flip(-1).cummax(-1).values.flip(-1).contiguous()
    return in_amp, smax


def pll_args(rng, rows: int, n: int, phase0: float) -> tuple:
    """pll_scan's arguments on the card: a 19 kHz pilot (40 Hz higher a
    row) of amplitude 0.1 in complex noise of 0.01 at 250 kHz, the WFM
    pilot PLL's coefficients (`BroadcastFm`'s: 25 kHz loop bandwidth,
    18 750-19 250 Hz), the frequency starting at 19 kHz and the phase at
    ``phase0``."""
    from sdrtpu_torch.kernels import loops

    fs = 250000.0
    w = lambda hz: float(np.float32(2 * np.pi * hz / fs))
    pll = loops.Pll(25000.0 / fs, init_freq=w(19000.0), min_freq=w(18750.0),
                    max_freq=w(19250.0), device="cuda")
    f = 19000.0 + 40.0 * np.arange(rows)[:, None]
    x = (0.1 * np.exp(1j * (2 * np.pi * f / fs * np.arange(n) + 0.7))
         + 0.01 * (rng.standard_normal((rows, n))
                   + 1j * rng.standard_normal((rows, n))))
    return (torch.as_tensor(x.astype(np.complex64), device="cuda"),
            torch.full((rows,), phase0, device="cuda"),
            torch.full((rows,), w(19000.0), device="cuda"),
            *pll._coefficients())


def pll_walk(args) -> str:
    """The walk the pll_scan kernel takes on every row of ``args`` (the
    wrapper's arguments): "bounded" (no division), "general" or
    "mixed"."""
    from sdrtpu_torch.kernels import loops

    _, phase0, _, alpha, _, fmin, fmax = args
    walks = {loops.pll_bounded(p, alpha, fmin, fmax)
             for p in phase0.tolist()}
    return ("mixed" if len(walks) > 1 else
            "bounded" if walks.pop() else "general")


def phase_seq_loops() -> list[dict]:
    """agc_scan and pll_scan against their plain loops on the card.

    AGC shapes: 750 / 1200 / 150 steps (AM, SSB, CW IF blocks of 50 ms),
    3000 / 4800 / 600 (the receiver path's 200 ms blocks), real and
    complex input, one and five rows, the average starting at 0, a burst
    that trips the clipping look-ahead, and one long shape, each bit-equal
    to the plain loop (`same_bits`); and 4 800 steps from an average of
    -0.0, outside the threshold walk's domain: the kernel's general walk,
    bit-equal too.  PLL (`pll_args`): 12 500 steps (the pll path's
    block), 2 rows x 25 000 (the rds path's), and 12 500 steps from a
    phase of 100 rad, outside the bounded walk's domain (the kernel's
    general walk), each bit-equal to the plain loop on the card.  ``ms``
    is device time per launch
    (profiler), ``plain_ms`` the plain loop's wall time, taken once.
    ``bound_ms`` is the contract's bytes-or-operations bound.  What
    really bounds a scan is its serial chain; `serial_chain_ms` reckons
    it from assumed latencies, this design's and the one before its
    redesign (`AGC_CHAIN_PR5`; `PLL_CHAIN_PR4`, with both divisions), for
    the log only: it is not measured."""
    from sdrtpu_torch.kernels import loops

    rng = np.random.default_rng(7)
    agc_rows = {}
    agc_main = (1, 4800, False, "threshold")  # the receiver's usb launch
    for rows, n, cplx, walk in [
            (1, 750, False, "threshold"), (1, 1200, False, "threshold"),
            (1, 150, False, "threshold"), (1, 750, True, "threshold"),
            (5, 1200, True, "threshold"), (1, 3000, False, "threshold"),
            agc_main, (1, 600, False, "threshold"),
            (2, 24000, False, "threshold"), (1, 4800, False, "general")]:
        in_amp, smax = agc_row(rng, rows, n, cplx)
        amp0 = torch.full((rows,), -0.0 if walk == "general" else 0.0,
                          device="cuda")
        args = (in_amp, smax, amp0, *AGC_COEF)
        g, amp = loops.agc_scan(*args)
        torch.cuda.synchronize()
        plain_ms = wall_ms(lambda: loops.agc_scan_ref(*args))
        g_ref, amp_ref = loops.agc_scan_ref(*args)
        same = same_bits(g, g_ref) and same_bits(amp, amp_ref)
        clipped = int((g_ref[:, 1:] < 0.5 * g_ref[:, :-1]).sum().item())
        if not (same and bool(torch.isfinite(g).all()) and clipped >= rows):
            raise AssertionError(
                f"agc_scan disagrees at {(rows, n, cplx, walk)}: bit-equal "
                f"{same}, max abs err {(g - g_ref).abs().max().item()}, "
                f"look-ahead hits {clipped}")
        agc_rows[(rows, n, cplx, walk)] = t = {
            "shape": [rows, n], "complex_input": cplx, "walk": walk,
            "bit_equal": same, "max_abs_err": 0.0,
            "ms": device_ms(lambda: loops.agc_scan(*args), 20,
                            "agc_scan_kernel"),
            "plain_ms": plain_ms,
            # |x|, suffix max and gain per step, the average in and out;
            # ~12 float32 operations per step
            **roofline(4 * (3 * rows * n + 2 * rows), 12 * rows * n)}
        log(f"agc_scan {(rows, n, cplx, walk)}: {t}; "
            f"{reckoned(n, AGC_CHAIN, AGC_CHAIN_PR5)}")

    pll_rows = {}
    pll_main = (1, 12500, "bounded")
    for rows, n, walk in [pll_main, (2, 25000, "bounded"),
                          (1, 12500, "general")]:
        args = pll_args(rng, rows, n, 0.0 if walk == "bounded" else 100.0)
        if pll_walk(args) != walk:
            raise AssertionError(f"pll_scan {(rows, n)}: a {pll_walk(args)} "
                                 f"row, want {walk}")
        got = loops.pll_scan(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = loops.pll_scan_ref(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check = held("pll_scan", got, want, f"{(rows, n)}, {walk} walk")
        lock = torch.angle(got[0][:, -100:] * torch.conj(args[0][:, -100:]))
        if not lock.abs().max().item() < 0.5:
            raise AssertionError(f"pll_scan {(rows, n)} did not lock: "
                                 f"{lock.abs().max().item()} rad")
        pll_rows[(rows, n, walk)] = t = {
            "shape": [rows, n], "walk": walk, **check,
            "ms": device_ms(lambda: loops.pll_scan(*args), 10,
                            "pll_scan_kernel"),
            "plain_ms": plain_ms,
            # complex64 in and out, the carries; ~60 operations per step
            # (atan2f, two wraps, cosf and sinf)
            **roofline(16 * rows * n + 16 * rows, 60 * rows * n)}
        chain = PLL_CHAIN if walk == "bounded" else PLL_CHAIN_PR4
        log(f"pll_scan {(rows, n, walk)}: {t}; "
            f"{reckoned(n, chain, PLL_CHAIN_PR4)}")

    def entry(name, replaces, main, rows, tol_key, tol):
        m = rows[main]
        return {
            "name": name, "route": "cuda",
            "source": "sdrtpu_torch/csrc/seq_loops.cu",
            # no Pallas kernel: the reference's lax.scan of this loop
            "replaces": replaces,
            "launches": None,  # filled in from its path's run
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            tol_key: tol,
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,  # no PyTorch call computes this recurrence
            "shape": m["shape"],
            "other_shapes": [v for k, v in rows.items() if k != main]}

    agc = entry("agc_scan", "sdrtpu/kernels/loops.py:185", agc_main,
                agc_rows, "bits", "equal")
    pll = entry("pll_scan", "sdrtpu/kernels/loops.py:79", pll_main,
                pll_rows, "bits", "equal")
    return [agc, pll]


def receiver_ddc_stages() -> list[tuple]:
    """(vfo, decimation, taps, input length) of every `DecimatingFir`
    stage the receiver path's per-VFO DDCs (am, usb, cw) run a block:
    what it hands `decim_fir`."""
    from sdrtpu_torch.apps.receiver import IQFrontend, VfoConfig

    fe = IQFrontend(RX_FS, {n: VfoConfig(o, m)
                            for n, (o, m) in RX_VFOS.items()},
                    spectrum=False, device="cpu")
    fe.bind(RX_BLOCK)
    out = []
    for name, vfo in fe.vfos.items():
        if name in fe._grouped_names():
            continue
        n = RX_BLOCK // fe.decimation
        for s in vfo.ddc.predecim.stages:
            out.append((name, s.decimation, s.taps, n))
            n //= s.decimation
    return out


def phase_decim_fir() -> dict:
    """decim_fir against the shift-and-add (`correlate_valid` of ``tail
    ++ x``) on the card, to the bit, at each of the receiver path's 13
    DDC stages; timed at the first stage (decimate by 8, 30 taps,
    2 000 000 complex64 samples) and at the am and cw DDCs' last ones,
    beside its bytes bound, the plain version and a yardstick the port
    never calls: cuDNN's strided ``conv1d`` over the real and imaginary
    planes (TF32 off).  Each timed call reads one of four inputs in
    turn, 64 MB for the first stage, more than the 50 MB L2: its read
    comes from device memory, as the bound assumes."""
    import torch.nn.functional as F

    from sdrtpu_torch.kernels import fir

    stages = receiver_ddc_stages()
    assert [(v, M, len(t)) for v, M, t, _ in stages] == [
        ("am", 8, 30), ("am", 8, 32), ("am", 5, 30), ("am", 2, 32),
        ("usb", 8, 30), ("usb", 5, 20), ("usb", 5, 30), ("usb", 2, 32),
        ("cw", 8, 30), ("cw", 8, 30), ("cw", 5, 20), ("cw", 5, 30),
        ("cw", 2, 32)], stages
    gen = torch.Generator(device="cuda").manual_seed(20)

    def iq(*shape):
        return torch.randn(shape, dtype=torch.complex64, device="cuda",
                           generator=gen)

    held_stages = []
    for vfo, M, taps, n in stages:
        tail, x = iq(len(taps) - 1), iq(n)
        h = torch.as_tensor(taps.astype(np.float32), device="cuda")
        got_tail, y = fir.decim_fir(tail, x, h, M)
        want_tail, want = fir.decim_fir_ref(tail, x, h, M)
        torch.cuda.synchronize()
        if not (torch.equal(y, want) and torch.equal(got_tail, want_tail)):
            raise AssertionError(
                f"decim_fir disagrees at {vfo} ({M}, {len(taps)}, {n}): "
                f"max_abs_err {(y - want).abs().max().item()}")
        held_stages.append([vfo, M, len(taps), n])
    log(f"decim_fir: the 13 receiver DDC stages bit-equal: {held_stages}")

    timed = {}
    ends = {"first": stages[0], "am_last": stages[3], "cw_last": stages[12]}
    for key, (vfo, M, taps, n) in ends.items():
        T = len(taps)
        h = torch.as_tensor(taps.astype(np.float32), device="cuda")
        w = h.view(1, 1, T)
        ins = [(iq(T - 1), iq(n)) for _ in range(4)]
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % len(ins)
            return ins[turn[0]]

        def library():
            tail, x = nxt()
            ext = torch.cat([tail, x])
            planes = torch.stack((ext.real, ext.imag))[:, None]
            out = F.conv1d(planes, w, stride=M)
            return torch.complex(out[0, 0], out[1, 0])

        A = n // M
        nbytes = 8 * (T - 1 + n) + 8 * A + 8 * (T - 1) + 4 * T
        fns = {"": lambda: fir.decim_fir(*nxt(), h, M),
               "plain_": lambda: fir.decim_fir_ref(*nxt(), h, M),
               "library_": library}
        t = timed[key] = {"vfo": vfo, "shape": [M, T, n],
                          **roofline(nbytes, 4 * A * T)}
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for name, fn in fns.items():
                t[name + "ms"] = device_ms(
                    fn, 20, "decim_fir_kernel" if name == "" else None)
                t[name + "event_ms"] = cuda_ms(fn, 50)
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
        t["ms_over_bound"] = t["ms"] / t["bound_ms"]
        log(f"decim_fir {key} {(M, T, n)}: {t}")
    first = timed["first"]
    return {
        "name": "decim_fir", "route": "cuda",
        "source": "sdrtpu_torch/csrc/decim_fir.cu",
        # no Pallas kernel: XLA fuses the reference's shift-and-add
        "replaces": None,
        "launches": None,  # filled in from the receiver path's run
        "max_abs_err": 0.0, "bits": "equal",
        "ms": first["ms"], "kernel_ms": first["ms"],
        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        "event_ms": first["event_ms"],
        "plain_event_ms": first["plain_event_ms"],
        "library_event_ms": first["library_event_ms"],
        "shape": first["shape"],
        "other_shapes": [timed["am_last"], timed["cw_last"]],
        "held_stages": held_stages,
    }


# The receiver path's deployment.  Every frequency is a multiple of 5 Hz,
# so one 2 000 000-sample block (200 ms) of the capture repeats without a
# seam and the stream is that block replayed.
RX_FS = 10_000_000.0
RX_VFOS = {  # name: (offset Hz, mode)
    "w0": (-3_200_000.0, "wfm"), "w1": (-1_100_000.0, "wfm"),
    "w2": (2_300_000.0, "wfm"), "n0": (600_000.0, "nfm"),
    "n1": (-2_000_000.0, "nfm"), "am": (1_400_000.0, "am"),
    "usb": (3_600_000.0, "usb"), "cw": (-4_100_000.0, "cw")}
# stations nobody listens to until the retunes
RX_SPARE = {"w2": (4_200_000.0, "wfm"), "usb": (-3_900_000.0, "usb")}
RX_BLOCK = 2_000_000  # the VFO set's block quantum, the Receiver's default
RX_BLOCKS = 16        # x 2 000 000 samples = 64 x 500 000
RX_CPU_BLOCKS = 2     # card vs CPU over the first 4 M samples
RX_SKIP = 400         # audio samples left out at the head of the stream
RX_AGC_RTOL = 2e-4    # of the peak, chains with an AGC (am, usb, cw)


def rx_tones(name: str, spare: bool = False) -> tuple[float, float]:
    """(left/mono tone, right tone) in Hz that a station carries."""
    i = list(RX_VFOS).index(name) + (8 if spare else 0)
    return 400.0 + 50.0 * i, 1500.0 + 50.0 * i


def rx_station(mode, offset, tones, fs, n):
    t = np.arange(n) / fs
    f1, f2 = tones
    if mode == "wfm":
        left, right = np.sin(2 * np.pi * f1 * t), np.sin(2 * np.pi * f2 * t)
        mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
        base = np.exp(1j * np.cumsum(2 * np.pi * 75000.0 * mpx / fs))
    elif mode == "nfm":
        base = np.exp(1j * np.cumsum(
            2 * np.pi * 2500.0 * np.sin(2 * np.pi * f1 * t) / fs))
    elif mode == "am":
        base = 1.0 + 0.5 * np.sin(2 * np.pi * f1 * t)
    elif mode == "usb":
        base = np.exp(2j * np.pi * f1 * t)   # a tone f1 above the carrier
    else:  # cw: the carrier itself, 20 Hz off the VFO
        base = np.exp(2j * np.pi * 20.0 * t)
    return 0.05 * base * np.exp(2j * np.pi * offset * t)


def receiver_capture(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = 1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for name, (off, mode) in RX_VFOS.items():
        x += rx_station(mode, off, rx_tones(name), RX_FS, n)
    for name, (off, mode) in RX_SPARE.items():
        x += rx_station(mode, off, rx_tones(name, spare=True), RX_FS, n)
    return x.astype(np.complex64)


def build_receiver(device, scan_batch=1, sinks=True, spectrum=True,
                   audio_sinks=None, baseband_sinks=None):
    """The receiver path's VFO set; ``audio_sinks`` in place of the
    collecting lists when given."""
    from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig

    fe = IQFrontend(RX_FS, {n: VfoConfig(o, m)
                            for n, (o, m) in RX_VFOS.items()},
                    fft_size=65536, fft_rate=20.0, device=device)
    audio = {n: [] for n in RX_VFOS}
    spec = []
    if audio_sinks is None and sinks:
        audio_sinks = {n: audio[n].append for n in audio}
    rx = Receiver(fe, audio_sinks=audio_sinks,
                  spectrum_sink=spec.append if spectrum and sinks else None,
                  baseband_sinks=baseband_sinks, scan_batch=scan_batch)
    return rx, audio, spec


def tone_db(a: np.ndarray, f: float, fs: float = 48000.0) -> float:
    """Level of the component at ``f`` Hz in ``a``, dB re full scale."""
    t = np.arange(a.shape[-1]) / fs
    w = np.hanning(a.shape[-1])
    c = np.sum(a * w * np.exp(-2j * np.pi * f * t)) / np.sum(w) * 2.0
    return 20.0 * np.log10(abs(c) + 1e-12)


def dominant_hz(a: np.ndarray, fs: float = 48000.0) -> float:
    spec = np.abs(np.fft.rfft(a * np.hanning(a.shape[-1])))
    spec[:4] = 0.0  # DC and the AGC's slow ripple
    return float(np.argmax(spec) * fs / a.shape[-1])


def rx_tone_checks(where: str, last: dict, retuned: bool) -> dict:
    """Each VFO's recovered tones on one block of the receiver path's
    audio (``last``: name -> (2, n)); the retuned VFOs (w2, usb) hear
    their spare stations when ``retuned``.  Raises on a miss."""
    tones = {}
    for name, (_, mode) in RX_VFOS.items():
        f1, f2 = rx_tones(name, spare=retuned and name in RX_SPARE)
        a = last[name]
        if mode == "wfm":
            tones[name] = [dominant_hz(a[0]), dominant_hz(a[1])]
            ok = abs(tones[name][0] - f1) < 6.0 and abs(tones[name][1] - f2) < 6.0
        else:
            expect = {"nfm": f1, "am": f1, "usb": f1 + 1400.0,
                      "cw": 820.0}[mode]
            tones[name] = [dominant_hz(a[0])]
            ok = abs(tones[name][0] - expect) < 6.0
        if not ok:
            raise AssertionError(f"{where}: VFO {name} ({mode}) recovered "
                                 f"{tones[name]}, sent {(f1, f2)}")
    return tones


def rx_audio_vs_cpu(where: str, card: dict, cpu: dict) -> dict:
    """Each VFO's card audio (``card``: name -> the first blocks) against
    the port on the CPU over the same blocks, past RX_SKIP samples:
    AUDIO_ATOL, RX_AGC_RTOL of the peak for the AGC chains.  Raises on a
    miss."""
    errs = {}
    for name, (_, mode) in RX_VFOS.items():
        got = np.concatenate(card[name], axis=-1)
        ref = np.concatenate(cpu[name], axis=-1)
        peak = float(np.abs(ref).max())
        err = float(np.abs(got - ref)[..., RX_SKIP:].max())
        tol = (AUDIO_ATOL if mode in ("wfm", "nfm")
               else RX_AGC_RTOL * max(peak, 1.0))
        errs[name] = {"max_abs_err": err, "tol": tol, "peak": peak}
        if not err <= tol:
            raise AssertionError(f"{where}: card audio vs CPU, VFO {name} "
                                 f"({mode}): {errs[name]}")
    return errs


def phase_receiver(card: str, rx_plans: dict,
                   profile_path: str | None = None) -> dict:
    """The generic receive path on the card, through `IQFrontend` and
    `Receiver.push`/`flush`.

    Launch counts, worked out from the code: each block launches
    chunk_poly once per fused group (2) and agc_scan once per AGC chain
    (am, usb, cw: 3; 2 while the am VFO runs nfm); `set_mode` runs the
    switched VFO alone twice on zeros (no chunk_poly; no agc_scan for the
    new nfm chain, 2 for the cached am chain's two replays).  mix_decimate and
    pll_scan are not on this path (the radio's pilot mode is
    "normalized").  decim_fir, counted apart from the seven: once per
    DDC stage, 13 a block."""
    from sdrtpu_torch.kernels import fir

    rx, audio, spec = build_receiver("cuda")
    fe = rx.frontend
    block = rx.block_len
    assert block == fe.block_multiple() == RX_BLOCK, block
    methods = {f"{r:.0f}": (names, ch.method)
               for r, (names, ch) in fe._groups.items()}
    assert methods == {"250000": (["w0", "w1", "w2"], "fft"),
                       "50000": (["n0", "n1"], "fft")}, methods
    # the shapes chunk_poly was held at are the ones this path launches
    launched = {f"{r:.0f}": (ch.fused.valid, ch.fused.ratio, ch.fused.nif,
                             ch.fused.n_chunks)
                for r, (_, ch) in fe._groups.items()}
    assert launched == rx_plans, (launched, rx_plans)
    x = receiver_capture(11, block)
    rx.warmup()

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    fir.decim_fir.launches = 0
    events = {6: lambda: (rx.retune("w2", RX_SPARE["w2"][0]),
                          rx.retune("usb", RX_SPARE["usb"][0])),
              9: lambda: rx.set_mode("am", "nfm"),
              11: lambda: rx.set_mode("am", "am")}
    switch_s = []
    for b in range(RX_BLOCKS):
        if b in events:
            out = events[b]()
            if isinstance(out, float):
                switch_s.append(out)
        rx.push(x)
    rx.flush()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches(chunk_poly=2 * RX_BLOCKS,
                             agc_scan=3 * (RX_BLOCKS - 2) + 2 * 2 + 2)
    if launches != want:
        raise AssertionError(f"receiver path launched {launches}, want {want}")
    # decim_fir: one a DDC stage, am 4, usb 4, cw 5 a block (3 for the am
    # VFO as nfm, blocks 9 and 10), and set_mode's two passes of the
    # switched VFO each way
    stages = {n: len(fe.vfos[n].ddc.predecim.stages)
              for n in ("am", "usb", "cw")}
    assert stages == {"am": 4, "usb": 4, "cw": 5}, stages
    fir_launches = fir.decim_fir.launches
    fir_want = 13 * (RX_BLOCKS - 2) + 12 * 2 + 2 * 3 + 2 * 4
    if fir_launches != fir_want:
        raise AssertionError(f"receiver path launched decim_fir "
                             f"{fir_launches} times, want {fir_want}")

    n_af = round(block * 48000 / RX_FS)
    for name, chunks_ in audio.items():
        assert len(chunks_) == RX_BLOCKS, (name, len(chunks_))
        for a in chunks_:
            assert a.shape == (2, n_af) and a.dtype == np.float32, a.shape
            assert np.isfinite(a).all(), name
    assert len(spec) == RX_BLOCKS and spec[0].shape == (4, 65536), (
        len(spec), spec[0].shape)
    assert max(s.max() for s in spec) > -60.0

    # what each VFO recovered, on its last block (after every event)
    tones = {}
    last = {n: v[-1] for n, v in audio.items()}
    for name, (_, mode) in RX_VFOS.items():
        f1, f2 = rx_tones(name, spare=name in RX_SPARE)
        a = last[name]
        if mode == "wfm":
            sep = min(tone_db(a[0], f1) - tone_db(a[0], f2),
                      tone_db(a[1], f2) - tone_db(a[1], f1))
            tones[name] = {"left_hz": dominant_hz(a[0]),
                           "right_hz": dominant_hz(a[1]),
                           "separation_db": sep}
            ok = (abs(dominant_hz(a[0]) - f1) < 6.0
                  and abs(dominant_hz(a[1]) - f2) < 6.0 and sep > 20.0)
        else:
            expect = {"nfm": f1, "am": f1, "usb": f1 + 1400.0,
                      "cw": 820.0}[mode]
            tones[name] = {"hz": dominant_hz(a[0]), "expected_hz": expect}
            ok = abs(dominant_hz(a[0]) - expect) < 6.0
        if not ok:
            raise AssertionError(f"receiver: VFO {name} ({mode}) recovered "
                                 f"{tones[name]}, sent {(f1, f2)}")
    # before the retune w2 and usb heard their first stations
    f1, _ = rx_tones("w2")
    assert abs(dominant_hz(audio["w2"][5][0]) - f1) < 6.0
    assert abs(dominant_hz(audio["usb"][5][0]) - rx_tones("usb")[0]
               - 1400.0) < 6.0
    # while switched to nfm, the am VFO hears an unmodulated-FM carrier
    assert audio["am"][10].shape == (2, n_af)

    # the same port on the CPU over the first blocks (before any event)
    cpu_rx, cpu_audio, cpu_spec = build_receiver("cpu")
    with recording("agc_scan") as calls:
        t0 = time.perf_counter()
        for _ in range(RX_CPU_BLOCKS):
            cpu_rx.push(x)
        cpu_rx.flush()
        cpu_s = time.perf_counter() - t0
    # the CPU's plain AGC calls launched again as the kernel, to the bit,
    # and timed at each of the path's three shapes (am, usb, cw)
    agc_check = hold_recorded("agc_scan", calls["agc_scan"],
                              "the receiver path")
    agc_check["at_path_shapes"] = [at_path_shape("agc_scan", a)
                                   for a, _ in calls["agc_scan"][:3]]
    errs = rx_audio_vs_cpu("receiver", {n: v[:RX_CPU_BLOCKS]
                                        for n, v in audio.items()}, cpu_audio)
    s_gpu = np.concatenate(spec[:RX_CPU_BLOCKS])
    s_cpu = np.concatenate(cpu_spec)
    live = s_cpu > s_cpu.max(axis=-1, keepdims=True) - 80.0
    s_err = float(np.abs(s_gpu - s_cpu)[live].max())
    if not s_err <= SPEC_DB_ATOL:
        raise AssertionError(f"receiver: card waterfall vs CPU: {s_err} dB")
    del cpu_rx, cpu_audio, cpu_spec

    # throughput: 5 passes of RX_BLOCKS blocks each way, sinks attached
    # (every block's audio and waterfall fetched to the host)
    timing = {}
    for batch in (1, 8):
        trx_, t_audio, _ = build_receiver("cuda", scan_batch=batch)
        trx_.warmup()
        trx_.push(x)  # the single first step of a batched receiver
        passes = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(RX_BLOCKS):
                trx_.push(x)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
        trx_.flush()
        assert sum(a.shape[-1] for a in t_audio["cw"]) == (
            (1 + 5 * RX_BLOCKS) * n_af)
        dt = float(np.median(passes))
        timing[batch] = {
            "ms_per_block": dt * 1e3 / RX_BLOCKS,
            "msps": RX_BLOCKS * block / dt / 1e6,
            "msps_passes": [RX_BLOCKS * block / t / 1e6 for t in passes],
            "real_time_factor": RX_BLOCKS * block / RX_FS / dt}
        del trx_, t_audio

    # the host alone: no sink, so nothing is fetched and push() returns
    # when the block's kernels are enqueued
    hrx, _, _ = build_receiver("cuda", sinks=False)
    hrx.warmup()
    hrx.push(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        hrx.push(x)
    host_ms = (time.perf_counter() - t0) * 1e3 / 8
    torch.cuda.synchronize()

    def four_blocks():
        for _ in range(4):
            hrx.push(x)

    prof, p_wall, busy_us = profiled(four_blocks)
    busy_ms_block = busy_us / 1e3 / 4
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) // 4
    if profile_path:
        os.makedirs(os.path.dirname(profile_path) or ".", exist_ok=True)
        with open(profile_path, "w") as fh:
            fh.write(f"{card}\nreceiver path: 4 blocks of {block}; wall "
                     f"{p_wall * 1e3:.3f} ms under the profiler; device busy "
                     f"{busy_us / 1e3:.3f} ms\n")
            fh.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40))
        log(f"profile -> {profile_path}")
    one = timing[1]
    return {
        "receiver": "10 Msps, 2 000 000-sample blocks (200 ms), waterfall "
                    "65536 @ 20 Hz, 8 VFOs: 3 wfm (fft group), 2 nfm (fft "
                    "group), am, usb, cw (per-VFO DDC)",
        "blocks": RX_BLOCKS, "samples": RX_BLOCKS * block,
        "groups": methods, "kernel_launches": launches,
        "decim_fir_launches": fir_launches,
        "set_mode_seconds": switch_s,
        "ms_per_block": one["ms_per_block"], "msps": one["msps"],
        "msps_passes": one["msps_passes"],
        "real_time_factor": one["real_time_factor"],
        "scan_batch_8": timing[8],
        "host_ms_per_block": host_ms,
        "device_busy_ms_per_block": busy_ms_block,
        "device_busy_share": busy_ms_block / one["ms_per_block"],
        "device_events_per_block": n_kernels,
        "recovered": tones,
        "audio_vs_cpu": errs, "audio_vs_cpu_blocks": RX_CPU_BLOCKS,
        "waterfall_vs_cpu_max_abs_db": s_err,
        "cpu_seconds_per_block": cpu_s / RX_CPU_BLOCKS,
        "kernel_check": agc_check,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }


def phase_pll(card: str) -> dict:
    """`BroadcastFm(pilot_mode="pll", rds_out=True)` over 8 blocks of
    12 500 samples at 250 kHz, card against CPU: pll_scan launches once
    per block and nothing else of the hand kernels runs."""
    from sdrtpu_torch.kernels.wfm import BroadcastFm

    fs, n, blocks = 250000.0, 12500, 8
    t = np.arange(blocks * n) / fs
    left, right = np.sin(2 * np.pi * 400 * t), np.sin(2 * np.pi * 1000 * t)
    mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
           + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t)
           + 0.05 * np.sin(2 * np.pi * 57000 * t)
           * np.sign(np.sin(2 * np.pi * 1187.5 * t)))
    rng = np.random.default_rng(13)
    x = (0.3 * np.exp(1j * np.cumsum(2 * np.pi * 75000.0 * mpx / fs))
         + 1e-4 * (rng.standard_normal(t.shape)
                   + 1j * rng.standard_normal(t.shape))).astype(np.complex64)
    kw = dict(samplerate=fs, stereo=True, low_pass=True, rds_out=True,
              pilot_mode="pll")
    gpu, cpu = BroadcastFm(device="cuda", **kw), BroadcastFm(device="cpu", **kw)
    sg, sc = gpu.init_state(), cpu.init_state()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = []
    t0 = time.perf_counter()
    with torch.inference_mode(), recording("pll_scan") as calls:
        for b in range(blocks):
            xb = torch.as_tensor(x[b * n:(b + 1) * n], device="cuda")
            sg, (a, rds) = gpu(sg, xb)
            outs.append((a, rds))
        torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches(pll_scan=blocks)
    if launches != want:
        raise AssertionError(f"pll path launched {launches}, want {want}")
    check = hold_pll_calls(calls["pll_scan"], "the pll path")
    a_err = r_err = 0.0
    with torch.inference_mode():
        for b in range(blocks):
            sc, (a_c, r_c) = cpu(sc, torch.as_tensor(x[b * n:(b + 1) * n]))
            a_g, r_g = outs[b]
            assert a_g.shape == (2, n) and r_g.shape == (n // 50,)
            skip = 1000 if b == 0 else 0  # the loop pulls in from its rest
            a_err = max(a_err, (a_g.cpu() - a_c)[:, skip:].abs().max().item())
            r_err = max(r_err, (r_g.cpu() - r_c).abs().max().item())
    if not (a_err <= AUDIO_ATOL and r_err <= AUDIO_ATOL):
        raise AssertionError(
            f"pll path: card vs CPU audio {a_err}, rds {r_err}")
    a_last = outs[-1][0].cpu().numpy()
    sep = min(tone_db(a_last[0], 400.0, fs) - tone_db(a_last[0], 1000.0, fs),
              tone_db(a_last[1], 1000.0, fs) - tone_db(a_last[1], 400.0, fs))
    assert sep > 20.0, f"pll path: stereo separation {sep} dB"
    phase_err = (sg["pll"][0].cpu() - sc["pll"][0]).abs().item()
    return {"pll_path": "BroadcastFm pilot_mode=pll rds_out, 8 blocks of "
                        "12 500 samples at 250 kHz",
            "kernel_launches": launches, "ms_per_block": gpu_s * 1e3 / blocks,
            "audio_vs_cpu_max_abs_err": a_err, "rds_vs_cpu_max_abs_err": r_err,
            "pll_phase_vs_cpu_rad": phase_err, "separation_db": sep,
            "kernel_check": check, "card": card}


def phase_ctcss(card: str) -> dict:
    """`RadioChain("nfm", ctcss_tone=12)` on 50 ms blocks (2 500 samples
    at 50 kHz, 25 detector steps each), card against CPU: the detector's
    booleans and tone must agree on every block, the tone must be found,
    and the time of the squelch op alone is read (its detector is a loop
    of torch ops, not a kernel)."""
    from sdrtpu_torch.apps.radio import RadioChain

    fs, n, blocks, want = 50000.0, 2500, 40, 12  # tone 12 = 100.0 Hz
    t = np.arange(blocks * n) / fs
    msg = np.sin(2 * np.pi * 1000.0 * t) + 0.15 * np.sin(2 * np.pi * 100.0 * t)
    x = (0.3 * np.exp(1j * np.cumsum(2 * np.pi * 2500.0 * msg / fs))).astype(
        np.complex64)
    gpu = RadioChain("nfm", ctcss_tone=want, device="cuda")
    cpu = RadioChain("nfm", ctcss_tone=want, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    a_err, opened = 0.0, None
    with torch.inference_mode():
        for b in range(blocks):
            xb = torch.as_tensor(x[b * n:(b + 1) * n])
            sg, ag = gpu(sg, xb.cuda())
            sc, ac = cpu(sc, xb)
            for key in ("var_ok", "mute", "tone"):
                if sg["ctcss"][key].item() != sc["ctcss"][key].item():
                    raise AssertionError(
                        f"ctcss: detector leaf {key} differs at block {b}")
            a_err = max(a_err, (ag.cpu() - ac).abs().max().item())
            if opened is None and not sg["ctcss"]["mute"].item():
                opened = b
        if RadioChain.ctcss_tone_detected(sg) != want or opened is None:
            raise AssertionError(
                f"ctcss: tone {RadioChain.ctcss_tone_detected(sg)}, "
                f"gate opened at block {opened}")
        if not a_err <= AUDIO_ATOL:
            raise AssertionError(f"ctcss: card vs CPU audio {a_err}")
        audio = torch.randn(2, n, device="cuda")
        st = sg["ctcss"]
        op_ms = []
        for _ in range(7):
            op_ms.append(wall_ms(lambda: gpu.ctcss(st, audio)))
    return {"ctcss": "RadioChain nfm + CtcssSquelch, 50 ms blocks of 2 500 "
                     "samples, 25 detector steps",
            "tone": want, "gate_opened_at_block": opened,
            "audio_vs_cpu_max_abs_err": a_err,
            "squelch_op_ms_per_block": float(np.median(op_ms)),
            "card": card}


# Meteor M2 LRPT: 72 ksym/s QPSK from 150 ksps (BASELINE config 4,
# examples/meteor_lrpt.py), 1 s blocks.
METEOR_FS = 150_000.0
METEOR_BLOCK = 150_000
METEOR_BLOCKS = 16        # 2.4 M samples, 1 152 000 symbols, 139 frames
METEOR_PREAMBLE = 3000    # QPSK symbols before the first frame
METEOR_PROFILED = 8       # first of the 4 blocks re-run under the profiler
VITERBI_PATH_STEPS = 88_448  # one block's 72 000 symbols + two frames' tail
RDS_FIXTURE = "tests/fixtures/wfm_stereo_rds_250k.wav"
RDS_BLOCK, RDS_BLOCKS = 25_000, 6  # the fixture's first 0.6 s


def qpsk_rrc(rng, nsym: int) -> np.ndarray:
    """QPSK at 72 ksym/s, RRC (beta 0.6) shaped to 150 ksps: 25/12
    samples a symbol, as examples/meteor_lrpt.py builds it."""
    tx = np.exp(1j * (rng.integers(0, 4, nsym) * np.pi / 2 + np.pi / 4))
    return shape_qpsk(tx)


def shape_qpsk(tx: np.ndarray) -> np.ndarray:
    import scipy.signal as sig

    from sdrtpu_torch.kernels import taps as tapsmod

    h = tapsmod.root_raised_cosine_rate(251, 0.6, 1.0, 25.0)
    n = len(tx) * 25 // 12
    # the filter's centre lands 125 up-samples (10 out) late
    return sig.upfirdn(h * 25.0, tx, 25, 12)[10:10 + n]


def bpsk_real(rng, nsym: int, sps: float) -> np.ndarray:
    """A BPSK-like real stream at ``sps`` samples a symbol (the RDS M&M's
    float mode)."""
    sym = rng.choice([-1.0, 1.0], nsym)
    t = np.arange(int(nsym * sps))
    x = np.convolve(sym[np.minimum((t / sps).astype(int), nsym - 1)],
                    np.ones(3) / 3, "same")
    return (x + 0.05 * rng.standard_normal(len(x))).astype(np.float32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (signed zeros too), where a NaN equals any NaN:
    the card's arithmetic returns its canonical NaN where PyTorch may
    keep another's payload."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        a, b = (a.masked_fill(na, 0).view(torch.int32),
                b.masked_fill(nb, 0).view(torch.int32))
    return torch.equal(a, b)


def finite_max(t: torch.Tensor) -> float:
    """The largest element of ``t``; 0 if it has none."""
    return t.max().item() if t.numel() else 0.0


def held(name: str, got, want, where) -> dict:
    """Hold a scan kernel's results ``got`` against its plain version's
    ``want`` (tuples as the wrappers return them, on any device):
    costas_scan within COSTAS_REL_TOL of the output's peak and
    COSTAS_PHASE_ATOL on the carried phase and frequency, NaN where the
    plain version has NaN and nowhere else; mm_scan (symbols, valid mask
    and carries), agc_scan (gains and final average), pll_scan (VCO
    phasor, phase and frequency) and viterbi_decode (bits and metrics)
    equal to the bit (`same_bits`).  Returns
    max_abs_err (and the carries' for costas_scan; both over the values
    that are not NaN) and whether all is bit-equal; raises on a
    disagreement, naming ``where``."""
    from sdrtpu_torch.kernels import loops

    got, want = [g.cpu() for g in got], [w.cpu() for w in want]
    out = {"bit_equal": all(same_bits(g, w) for g, w in zip(got, want))}
    if name == "costas_scan":
        nan = torch.isnan(want[0])
        same_nan = (torch.equal(torch.isnan(got[0]), nan)
                    and torch.equal(torch.isnan(got[1]), torch.isnan(want[1]))
                    and torch.equal(torch.isnan(got[2]), torch.isnan(want[2])))
        err = out["max_abs_err"] = (
            finite_max((got[0] - want[0]).abs()[~nan]) if same_nan
            else float("inf"))
        peak = finite_max(want[0].abs()[~nan])
        carry = out["carry_abs_err"] = max(
            torch.nan_to_num(loops._wrap_pi(got[1] - want[1]).abs()).max()
            .item(), torch.nan_to_num((got[2] - want[2]).abs()).max().item())
        ok = (same_nan and err <= COSTAS_REL_TOL * peak
              and carry <= COSTAS_PHASE_ATOL)
        out["nan_outputs"] = int(nan.sum())
        detail = (f"max_abs_err {err} (peak {peak}), carry err {carry}, "
                  f"NaN where the plain version has NaN: {same_nan}")
    else:
        ok = out["bit_equal"]
        out["max_abs_err"] = 0.0 if ok else float("inf")
        if name == "viterbi_decode":
            detail = f"{int((got[0] != want[0]).sum())} bits differ"
        else:
            detail = f"elements that differ: " + ", ".join(
                f"{int((g != w).sum())} of {g.numel()}"
                for g, w in zip(got, want))
        if name == "mm_scan":
            detail += (f"; valid {int(got[1].sum())} vs "
                       f"{int(want[1].sum())}, offset {got[2].tolist()} vs "
                       f"{want[2].tolist()}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{where}: {detail}")
    return out


@contextlib.contextmanager
def recording(*names):
    """While the ``with`` block runs, every call of the named kernel
    wrappers (looked up by their modules at call time) records its
    arguments and results: yields ``{name: [(args, out), ...]}``."""
    from sdrtpu_torch.fec import viterbi as tv
    from sdrtpu_torch.kernels import clock, loops

    mods = {"costas_scan": loops, "mm_scan": clock, "viterbi_decode": tv,
            "agc_scan": loops, "pll_scan": loops}
    saved = {name: getattr(mods[name], name) for name in names}
    calls = {name: [] for name in names}

    def recorder(name):
        def record(*args):
            out = saved[name](*args)
            calls[name].append((args, out))
            return out
        # a wrapper counts its launch on the name it is called by: the
        # recorder's while it is installed, handed on to the wrapper's
        # own count when it is taken out
        record.launches = 0
        return record

    recorders = {name: recorder(name) for name in names}
    for name in names:
        setattr(mods[name], name, recorders[name])
    try:
        yield calls
    finally:
        for name in names:
            setattr(mods[name], name, saved[name])
            saved[name].launches += recorders[name].launches


def hold_recorded(name: str, calls, where: str) -> dict:
    """Each recorded plain-version call of ``name`` launched again as its
    kernel on the card on the same inputs and held by `held`."""
    from sdrtpu_torch.fec import viterbi as tv
    from sdrtpu_torch.kernels import clock, loops

    fn = {"costas_scan": loops.costas_scan, "mm_scan": clock.mm_scan,
          "viterbi_decode": tv.viterbi_decode,
          "agc_scan": loops.agc_scan}[name]
    if not calls:
        raise AssertionError(f"{where}: the CPU run made no {name} call")
    if any(torch.is_tensor(a) and a.device.type != "cpu"
           for args, _ in calls for a in args):
        raise AssertionError(f"{where}: a recorded {name} call ran on the "
                             "card, not in the CPU run")
    checks = [held(name, fn(*(a.cuda() if torch.is_tensor(a) else a
                              for a in args)), out,
                   f"{where}'s inputs {tuple(args[0].shape)}")
              for args, out in calls]
    return {"shapes": [list(args[0].shape) for args, _ in calls],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "bit_equal": all(c["bit_equal"] for c in checks)}


def at_path_shape(name: str, args, reps: int = 20) -> dict:
    """A path's recorded call of mm_scan, agc_scan or pll_scan launched
    again on the card at its own shape and timed: device ms (profiler,
    ``reps`` launches), the plain version's wall time on the card (once;
    for mm_scan only where the call emits at most 10 000 symbols, for
    pll_scan never: `hold_pll_calls` times it over all of a path's
    calls), the steps (symbols for mm_scan); the reckoned chain of this
    design and of the kernel before its redesign (`*_CHAIN_PR5`,
    `PLL_CHAIN_PR4`) goes to the log only (`reckoned`)."""
    from sdrtpu_torch.kernels import clock, loops

    fn, ref = {"mm_scan": (clock.mm_scan, clock.mm_scan_ref),
               "agc_scan": (loops.agc_scan, loops.agc_scan_ref),
               "pll_scan": (loops.pll_scan, loops.pll_scan_ref)}[name]
    a = tuple(x.cuda() if torch.is_tensor(x) else x for x in args)
    out = fn(*a)
    if name == "mm_scan":
        steps, chains = int(out[1].sum().item()), (MM_CHAIN, MM_CHAIN_PR5)
    elif name == "agc_scan":
        steps, chains = a[0].shape[1], (AGC_CHAIN, AGC_CHAIN_PR5)
    else:
        steps, chains = a[0].shape[1], (PLL_CHAIN, PLL_CHAIN_PR4)
    with SmClocks() as clocks:
        ms = device_ms(lambda: fn(*a), reps, f"{name}_kernel")
    plain = (wall_ms(lambda: ref(*a)) if name == "agc_scan"
             or (name == "mm_scan" and steps <= 10_000) else None)
    row = {"shape": list(a[0].shape), "steps": steps, "ms": ms,
           "plain_ms": plain, "sm_clock_mhz": clocks.summary()}
    if name == "pll_scan":
        row["walk"] = pll_walk(a)
    log(f"{name} at a path's shape: {row}; {reckoned(steps, *chains)}")
    return row


def reckoned(steps: int, chain, chain_old) -> str:
    """The reckoned serial chain of this design and of the kernel's
    before its redesign, for the log (not a measurement)."""
    return (f"reckoned serial chain {serial_chain_ms(steps, chain):.4f} ms "
            f"(before the redesign: {serial_chain_ms(steps, chain_old):.4f} "
            "ms)")


def hold_pll_calls(calls, where: str) -> dict:
    """A path's recorded pll_scan launches on the card held by `held`
    against the plain version on the card on the same inputs: the calls'
    rows stacked into one run of the plain loop (its rows are
    independent), one row a call; and one call (the second, past the
    loop's pull-in, else the first) timed at the path's shape
    (`at_path_shape`)."""
    from sdrtpu_torch.kernels import loops

    if not calls:
        raise AssertionError(f"{where}: no pll_scan call")
    shapes = {tuple(args[0].shape) for args, _ in calls}
    coef = {tuple(args[3:]) for args, _ in calls}
    if len(shapes) != 1 or len(coef) != 1 or any(
            args[0].device.type != "cuda" for args, _ in calls):
        raise AssertionError(f"{where}: pll_scan calls of shapes {shapes}, "
                             f"coefficients {coef}, not all on the card")
    x, phase0, freq0 = (torch.cat([args[i] for args, _ in calls])
                        for i in range(3))
    got = [torch.cat([out[i] for _, out in calls]) for i in range(3)]
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = loops.pll_scan_ref(x, phase0, freq0, *calls[0][0][3:])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check = held("pll_scan", got, want,
                     f"{where}'s {len(calls)} calls {shapes.pop()}")
        timed = at_path_shape("pll_scan", calls[min(1, len(calls) - 1)][0])
    return {"calls": len(calls), "shape": list(calls[0][0][0].shape),
            "walks": pll_walk((x, phase0, freq0, *calls[0][0][3:])),
            **check, "plain_ms_all_calls_at_once": plain_ms,
            "at_path_shape": timed}


def costas_long_checks(coef) -> list[dict]:
    """costas_scan order 4 at 150 000 steps and at 150 001 (a ragged
    last tile), one row a launch, each held by `held` against the plain
    version run once on the CPU over all the rows (150 000 steps, then
    one more from its carries): the meteor path's block (a 100 Hz
    carrier); a carrier of 1/50 of the rate (the phase crosses +-pi every
    50 steps, ~3 000 one-turn wraps); the same from a phase of 100 rad,
    past the bounded walk's reach (sincosf and the wrap by the division
    on every step, ~3 000 of them the division's full path); one NaN
    sample half way; a phase of -0.0 over 16 zero samples.  Each
    timed (`device_ms`, `cuda_ms`)."""
    from sdrtpu_torch.kernels import loops

    rng = np.random.default_rng(29)
    n = METEOR_BLOCK + 1
    t = np.arange(n)
    rows = {"meteor": (100.0 / METEOR_FS, 0.3), "wrap-heavy": (1 / 50, 0.3),
            "wrap-heavy, general walk": (1 / 50, 100.0), "nan": (100.0 /
            METEOR_FS, 0.3), "phase -0.0": (100.0 / METEOR_FS, -0.0)}
    xs, ph0, fr0 = [], [], []
    for name, (cycles, phase0) in rows.items():
        x = np.exp(2j * np.pi * (rng.integers(0, 4, n) / 4 + cycles * t))
        x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        if name == "nan":
            x[n // 2] = np.nan
        if name == "phase -0.0":
            x[:16] = 0
        xs.append(x.astype(np.complex64))
        ph0.append(phase0)
        fr0.append(2 * np.pi * cycles if "wrap-heavy" in name else 0.0)
    x = torch.as_tensor(np.stack(xs))
    ph0 = torch.tensor(ph0, dtype=torch.float32)
    fr0 = torch.tensor(fr0, dtype=torch.float32)
    mode = loops.COSTAS_ORDER4
    t0 = time.perf_counter()
    y1, ph1, fr1 = loops.costas_scan_ref(x[:, :-1], ph0, fr0, *coef, mode)
    y2, ph2, fr2 = loops.costas_scan_ref(x[:, -1:], ph1, fr1, *coef, mode)
    plain_cpu_ms = (time.perf_counter() - t0) * 1e3
    want = {n - 1: (y1, ph1, fr1), n: (torch.cat([y1, y2], 1), ph2, fr2)}
    out = []
    for r, name in enumerate(rows):
        for steps in (n - 1, n):
            args = (x[r:r + 1, :steps].contiguous().cuda(),
                    ph0[r:r + 1].cuda(), fr0[r:r + 1].cuda(), *coef, mode)
            got = loops.costas_scan(*args)
            check = held("costas_scan", got,
                         [w[r:r + 1] for w in want[steps]],
                         f"{name}, {steps} steps")
            row = {"case": name, "shape": [1, steps], **check,
                   "ms": device_ms(lambda: loops.costas_scan(*args), 5,
                                   "costas_scan_kernel"),
                   "event_ms": cuda_ms(lambda: loops.costas_scan(*args), 5)}
            log(f"costas_scan {name} x {steps}: {row}")
            out.append(row)
    log(f"costas_scan long holds: the plain version over {len(rows)} rows "
        f"x {n} steps on the CPU took {plain_cpu_ms:.0f} ms")
    return out


# rate 1/R codes of each K the grid decodes (the K = 7, R = 2 code is
# CCSDS's, R = 4 DAB's mother code)
VITERBI_GRID_POLYS = {
    3: {2: (0o7, 0o5), 3: (0o5, 0o7, 0o7), 4: (0o5, 0o7, 0o7, 0o5)},
    5: {2: (0o27, 0o31), 3: (0o25, 0o33, 0o37), 4: (0o25, 0o27, 0o33, 0o37)},
    7: {2: (0o171, 0o133), 3: (0o133, 0o171, 0o145),
        4: (0o133, 0o171, 0o145, 0o133)}}
VITERBI_GRID_STEPS = (1, 1023, 1025, VITERBI_PATH_STEPS)


def viterbi_grid_checks() -> dict:
    """viterbi_decode at K in {3, 5, 7} x R in {2, 3, 4} x n in
    VITERBI_GRID_STEPS x rows in {1, 2, 4}: four rows of noisy soft
    symbols a (K, R, n), decoded once by the plain version on the CPU,
    and the kernel launched on the first 1, 2 and 4 of them, bits and
    final metrics held equal to the bit (`held`).  Each (K, R) timed at
    one row of VITERBI_PATH_STEPS."""
    from sdrtpu_torch.fec import viterbi as tv

    rng = np.random.default_rng(83)
    held_n, ms = 0, {}
    for K, codes in VITERBI_GRID_POLYS.items():
        for R, polys in codes.items():
            enc = tv.ConvEncoder(K, polys)
            dec = tv.ViterbiDecoder(K, polys, device="cpu")  # its tables
            for n in VITERBI_GRID_STEPS:
                soft = np.stack([enc.encode_to_soft(rng.integers(0, 2, n))
                                 for _ in range(4)])
                soft = soft + 0.8 * rng.standard_normal(soft.shape)
                sym = torch.as_tensor(soft.astype(np.float32).reshape(
                    4, n, R))
                want = tv.viterbi_decode_ref(sym, dec.exp_prev, dec.prev,
                                             dec.prev_bit)
                for rows in (1, 2, 4):
                    args = (sym[:rows].cuda(), dec.exp_prev, dec.prev,
                            dec.prev_bit)
                    held("viterbi_decode", tv.viterbi_decode(*args),
                         [w[:rows] for w in want], (K, R, n, rows))
                    held_n += 1
                    if n == VITERBI_PATH_STEPS and rows == 1:
                        ms[f"K={K}, R={R}"] = {
                            "ms": device_ms(
                                lambda: tv.viterbi_decode(*args), 5,
                                "viterbi_kernel"),
                            "event_ms": cuda_ms(
                                lambda: tv.viterbi_decode(*args), 5)}
            log(f"viterbi_decode grid K={K}, R={R}: held at n "
                f"{VITERBI_GRID_STEPS} x rows (1, 2, 4); "
                f"{ms[f'K={K}, R={R}']}")
    return {"held": held_n, "bit_equal": True, "steps": VITERBI_GRID_STEPS,
            "ms_at_path_steps": ms}


def phase_sync_kernels() -> list[dict]:
    """costas_scan, mm_scan and viterbi_decode against their plain
    PyTorch versions on the card, each timed beside the plain version.

    Held against the plain version on the card (it takes 200-1 100 us a
    step there, so these shapes are short): costas_scan order 2 at 500
    steps (the RDS loops' block), order 4 at 6 000, order 4 with the
    broken-modulation error at 6 000, order 8 at 2 000 and a 2-row batch
    at 2 000, within COSTAS_REL_TOL of the output's peak and
    COSTAS_PHASE_ATOL on the carries; mm_scan complex at 6 000 samples
    in and float at the RDS path's 500, symbols, mask and carries equal
    to the bit; viterbi_decode K=7
    CCSDS at 16 448 steps of noisy soft symbols and K=5 (0o27, 0o31) at
    2 000, bits and final metrics equal to the bit (`same_bits`).  Held
    against the plain version on the CPU: viterbi_decode at the meteor
    path's longest launch, 88 448 steps, one row and two, bits and
    metrics equal to the bit; mm_scan at the meteor path's 150 000
    samples in, equal to the bit; costas_scan order 4 at 150 000 and
    150 001 steps on five rows (`costas_long_checks`: the meteor block,
    wrap-heavy on both walks, a NaN, a phase of -0.0); viterbi_decode
    over K x R x n x rows (`viterbi_grid_checks`).  The identities the
    Costas kernel and the PLL's bounded walk rest on, over every float32,
    are tests/test_torch_sync_loops_cuda.py::
    test_phase_identities_hold_over_every_float32.  Timed alone at the meteor path's shapes: costas_scan at 150 000
    steps, mm_scan at 150 000 samples in (the meteor phase holds both,
    and viterbi_decode, on the path's own inputs of a whole block:
    ``path_check``), viterbi_decode at 88 448 steps.  ``ms`` is device
    time per launch (profiler), ``event_ms`` CUDA events over as many
    launches at the paths' shapes, ``plain_ms`` the plain version's wall
    time on the card, once.  Whether each check was bit-equal goes to
    the log; so does the reckoned serial bound (`serial_chain_ms`),
    which is not a measurement (this design's and the PR 5 kernel's)."""
    from sdrtpu_torch.fec import viterbi as tv
    from sdrtpu_torch.kernels import clock, loops
    from sdrtpu_torch.kernels.psk import MeteorDemod

    rng = np.random.default_rng(17)
    path = MeteorDemod(device="cuda")
    coef = path.costas._coefficients()

    def psk(rows, n, mode):
        order = 8 if mode == loops.COSTAS_ORDER8 else 4
        if mode == loops.COSTAS_BROKEN:
            ph = np.asarray(loops.BROKEN_PHASES)[rng.integers(0, 4, (rows, n))]
        else:
            ph = 2 * np.pi * rng.integers(0, order, (rows, n)) / order
        x = np.exp(1j * (ph + 2 * np.pi * 100.0 / METEOR_FS * np.arange(n)
                         + 0.7))
        x = x + 0.05 * (rng.standard_normal((rows, n))
                        + 1j * rng.standard_normal((rows, n)))
        return torch.as_tensor(x.astype(np.complex64), device="cuda")

    costas_rows = {}
    costas_main = (1, METEOR_BLOCK, loops.COSTAS_ORDER4)
    for rows, n, mode in [(1, 500, loops.COSTAS_ORDER2),
                          (1, 6000, loops.COSTAS_ORDER4),
                          (1, 6000, loops.COSTAS_BROKEN),
                          (1, 2000, loops.COSTAS_ORDER8),
                          (2, 2000, loops.COSTAS_ORDER4), costas_main]:
        x = psk(rows, n, mode)
        args = (x, torch.full((rows,), 0.3, device="cuda"),
                torch.zeros(rows, device="cuda"), *coef, mode)
        if (rows, n, mode) == costas_main:  # timed alone
            with SmClocks() as clocks:
                ms = device_ms(lambda: loops.costas_scan(*args), 5,
                               "costas_scan_kernel")
                event_ms = cuda_ms(lambda: loops.costas_scan(*args), 5)
            costas_rows[costas_main] = t = {
                "shape": [rows, n], "mode": mode, "ms": ms,
                "event_ms": event_ms, "sm_clock_mhz": clocks.summary(),
                **roofline(16 * rows * n + 16 * rows, 40 * rows * n)}
            log(f"costas_scan {costas_main}: {t}; "
                f"{reckoned(n, *costas_chains(mode))}")
            continue
        got = loops.costas_scan(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = loops.costas_scan_ref(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        costas_rows[(rows, n, mode)] = t = {
            "shape": [rows, n], "mode": mode,
            **held("costas_scan", got, want, (rows, n, mode)),
            "ms": device_ms(lambda: loops.costas_scan(*args), 20,
                            "costas_scan_kernel"),
            "plain_ms": plain_ms,
            # complex64 in and out and the carries; ~40 operations a step
            **roofline(16 * rows * n + 16 * rows, 40 * rows * n)}
        log(f"costas_scan {(rows, n, mode)}: {t}; "
            f"{reckoned(n, *costas_chains(mode))}")
        del x, got, want

    mm_rows = {}
    mm_main = (True, METEOR_BLOCK)
    for cplx, n in [(True, 6000), (False, 500), mm_main]:
        if cplx:
            mm = path.recov
            x = qpsk_rrc(rng, n * 12 // 25 + 1)[:n]
            x = x + 0.05 * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
        else:
            mm = clock.MuellerMuller(5000.0 / 1187.5, 1e-6, 0.01, 0.01,
                                     complex_mode=False, device="cuda")
            x = bpsk_real(rng, int(n / mm.omega) + 1, mm.omega)[:n]
        st = mm.init_state()
        ext = torch.cat([st["tail"], torch.as_tensor(
            x.astype(np.complex64 if cplx else np.float32),
            device="cuda")])[None].contiguous()
        args = (ext, mm._bank, n, mm.max_out(n), st["offset"].reshape(1),
                torch.stack([st["phase"], st["freq"], st["last_out"]])[None],
                torch.stack([st[k] for k in ("p1", "p2", "c1", "c2")])[None],
                float(np.float32(mm.omega * (1 - mm.omega_rel_limit))),
                float(np.float32(mm.omega * (1 + mm.omega_rel_limit))),
                float(np.float32(mm.omega_gain)),
                float(np.float32(mm.mu_gain)))
        item = 8 if cplx else 4
        if (cplx, n) == mm_main:  # timed alone, held on the CPU
            got = clock.mm_scan(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = clock.mm_scan_ref(*(a.cpu() if torch.is_tensor(a) else a
                                       for a in args))
            plain_cpu_ms = (time.perf_counter() - t0) * 1e3
            n_valid = int(got[1].sum().item())
            with SmClocks() as clocks:
                ms = device_ms(lambda: clock.mm_scan(*args), 5,
                               "mm_scan_kernel")
                event_ms = cuda_ms(lambda: clock.mm_scan(*args), 5)
            mm_rows[mm_main] = t = {
                "shape": [1, n], "complex": cplx, "symbols": n_valid,
                "slots": args[3],
                **held("mm_scan", got, want,
                       f"{(cplx, n)}, plain version on the cpu"),
                "ms": ms, "event_ms": event_ms,
                "sm_clock_mhz": clocks.summary(),
                "plain_cpu_ms": plain_cpu_ms,
                **roofline(item * (n + 7) + (item + 1) * args[3] + 4096,
                           40 * n_valid)}
            log(f"mm_scan {mm_main}: {t}; "
                f"{reckoned(n_valid, MM_CHAIN, MM_CHAIN_PR5)}")
            continue
        got = clock.mm_scan(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = clock.mm_scan_ref(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        n_valid = int(got[1].sum().item())
        mm_rows[(cplx, n)] = t = {
            "shape": [1, n], "complex": cplx, "symbols": n_valid,
            "slots": args[3], **held("mm_scan", got, want, (cplx, n)),
            "ms": device_ms(lambda: clock.mm_scan(*args), 20,
                            "mm_scan_kernel"),
            "plain_ms": plain_ms,
            # ext in, symbols and the mask out, the bank; ~40 operations a
            # symbol
            **roofline(item * (n + 7) + (item + 1) * args[3] + 4096,
                       40 * n_valid)}
        log(f"mm_scan {(cplx, n)}: {t}; "
            f"{reckoned(n_valid, MM_CHAIN, MM_CHAIN_PR5)}")
        del ext, got, want

    vit_rows = {}
    vit_main = (1, VITERBI_PATH_STEPS, 7)
    for rows, n, K, hold in [(1, 16_448, 7, "cuda"), (1, 2000, 5, "cuda"),
                             (1, VITERBI_PATH_STEPS, 7, "cpu"),
                             (2, VITERBI_PATH_STEPS, 7, "cpu")]:
        polys = (0o171, 0o133) if K == 7 else (0o27, 0o31)
        enc, dec = tv.ConvEncoder(K, polys), tv.ViterbiDecoder(K, polys,
                                                               device="cuda")
        soft = np.stack([enc.encode_to_soft(rng.integers(0, 2, n))
                         for _ in range(rows)])
        soft = soft + 0.7 * rng.standard_normal(soft.shape)
        sym = torch.as_tensor(soft.astype(np.float32).reshape(rows, n, 2),
                              device="cuda")
        args = (sym, dec.exp_prev, dec.prev, dec.prev_bit)
        got = tv.viterbi_decode(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = tv.viterbi_decode_ref(sym.to(hold), *args[1:])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check = held("viterbi_decode", got, want,
                     f"{(rows, n, K)}, plain version on the {hold}")
        with SmClocks() as clocks:
            reps = 5 if n >= 50_000 else 20
            ms = device_ms(lambda: tv.viterbi_decode(*args), reps,
                           "viterbi_kernel")
            event_ms = cuda_ms(lambda: tv.viterbi_decode(*args), reps)
        vit_rows[(rows, n, K)] = t = {
            "shape": [rows, n], "K": K, "ms": ms,
            "event_ms": event_ms, "sm_clock_mhz": clocks.summary(), **check,
            ("plain_ms" if hold == "cuda" else "plain_cpu_ms"): plain_ms,
            # soft symbols in, bits and metrics out; per step and state
            # two branch metrics (2 mul + add), two adds, a compare, a
            # select, a share of the max and the subtract: ~10
            **roofline(rows * n * 9 + rows * dec.S * 4,
                       rows * n * dec.S * 10)}
        log(f"viterbi_decode {(rows, n, K)}: {t}; "
            f"{reckoned(n, VITERBI_CHAIN, VITERBI_CHAIN_PR5)}")
        del got, want

    def entry(name, source, replaces, main, rows, tol):
        """The path's shape gives ``ms`` and the bound; ``plain_ms`` is
        the plain loop on the card (~13-60 launches a step) at the
        longest shape held there (``plain_shape``)."""
        m = rows[main]
        held = [r for r in rows.values() if "max_abs_err" in r]
        longest = max((r for r in held if "plain_ms" in r),
                      key=lambda r: r["shape"][0] * r["shape"][1])
        return {
            "name": name, "route": "cuda", "source": source,
            # no Pallas kernel: the reference's lax.scan of this loop
            "replaces": replaces,
            "launches": None,  # filled in from its path's run
            "max_abs_err": max(r["max_abs_err"] for r in held),
            **tol,
            "ms": m["ms"], "event_ms": m["event_ms"],
            "plain_ms": longest["plain_ms"],
            "plain_shape": longest["shape"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,  # no PyTorch call computes this recurrence
            "shape": m["shape"],
            "other_shapes": [v for k, v in rows.items() if k != main]}

    long_rows = costas_long_checks(coef)
    grid = viterbi_grid_checks()
    costas = entry("costas_scan", "sdrtpu_torch/csrc/sync_loops.cu",
                   "sdrtpu/kernels/loops.py:144", costas_main, costas_rows,
                   {"rel_tol": COSTAS_REL_TOL,
                    "carry_atol": COSTAS_PHASE_ATOL})
    costas["long_shapes"] = long_rows
    costas["max_abs_err"] = max([costas["max_abs_err"]]
                                + [r["max_abs_err"] for r in long_rows])
    viterbi = entry("viterbi_decode", "sdrtpu_torch/csrc/viterbi.cu",
                    "sdrtpu/fec/viterbi.py:128", vit_main, vit_rows,
                    {"bits": "equal"})
    viterbi["grid"] = grid
    mm = entry("mm_scan", "sdrtpu_torch/csrc/sync_loops.cu",
               "sdrtpu/kernels/clock.py:165", mm_main, mm_rows,
               {"bits": "equal"})
    return [costas, mm, viterbi]


def meteor_capture(seed: int):
    """examples/meteor_lrpt.py's burst at the path's length: a QPSK
    preamble, then CADUs of random CVCDUs from the port's `CcsdsEncoder`,
    then QPSK fill; RRC-shaped to 150 ksps; phase 0.7 rad, 100 Hz CFO,
    AWGN 0.05.  Returns (cvcdus, complex64 samples)."""
    from sdrtpu_torch.decoders.ccsds import CVCDU_BYTES, CcsdsEncoder

    rng = np.random.default_rng(seed)
    n = METEOR_BLOCKS * METEOR_BLOCK
    n_sym = n * 12 // 25
    frame_syms = 32 + 1024 * 8  # one CADU: 8 224 bits, 8 224 QPSK symbols
    n_frames = (n_sym - METEOR_PREAMBLE - 1000) // frame_syms
    cvs = [rng.integers(0, 256, CVCDU_BYTES).astype(np.uint8)
           for _ in range(n_frames)]
    soft = CcsdsEncoder().encode(cvs)
    frames = (soft[0::2] + 1j * soft[1::2]) / np.sqrt(2)

    def fill(k):
        return np.exp(1j * (rng.integers(0, 4, k) * np.pi / 2 + np.pi / 4))

    tx = np.concatenate([fill(METEOR_PREAMBLE), frames,
                         fill(n_sym - METEOR_PREAMBLE - len(frames))])
    x = shape_qpsk(tx)
    assert len(x) == n, len(x)
    x = x * np.exp(1j * (0.7 + 2 * np.pi * 100.0 * np.arange(n) / METEOR_FS))
    x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return cvs, x.astype(np.complex64)


def check_frames(frames, cvs, what: str) -> int:
    """Every CVCDU but at most the first two, payload-exact, in order,
    nothing else; returns how many were missed at the head."""
    skip = len(cvs) - len(frames)
    ok = 0 <= skip <= 2 and all(
        np.array_equal(f, c) for f, c in zip(frames, cvs[skip:]))
    if not ok:
        raise AssertionError(f"meteor {what}: {len(frames)} frames for "
                             f"{len(cvs)} sent, payload-exact and in order: "
                             f"{ok}")
    return skip


def expected_viterbi(blocks: int, lock_block: int, rotation: int) -> int:
    """viterbi_decode launches of a `QpskAmbiguityResolver` over
    ``blocks`` calls: both candidates on each block before the lock; on
    the lock block candidate 0, and candidate 1 after it when that is
    the one that locks; one a block after the lock."""
    return 2 * lock_block + 1 + rotation + (blocks - lock_block - 1)


@contextlib.contextmanager
def host_timers(acc: dict):
    """While the ``with`` block runs, adds the wall ms of each call of the
    meteor path's host stages to ``acc[key]`` and counts the calls in
    ``acc[key + "_calls"]``: "deframe" (`CcsdsDeframer.process`: the
    soft tail's cat, the Viterbi launch, the wait for it and the bits'
    copy, then ``_scan``), "scan" (``_scan``: the per-bit ASM search and
    the RS decodes) and "rs" (`rs_interleave_decode`)."""
    from sdrtpu_torch.decoders import ccsds

    saved = []
    for owner, attr, key in ((ccsds.CcsdsDeframer, "process", "deframe"),
                             (ccsds.CcsdsDeframer, "_scan", "scan"),
                             (ccsds, "rs_interleave_decode", "rs")):
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def timed(*a, _fn=fn, _key=key, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc[_key] = acc.get(_key, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                acc[_key + "_calls"] = acc.get(_key + "_calls", 0) + 1

        setattr(owner, attr, timed)
    try:
        yield acc
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def hold_costas_mm(costas_calls, mm_calls, plain_n: int = 6000) -> dict:
    """`costas_mm_scan` on the inputs of the meteor path's first block
    (its recorded plain Costas and M&M calls: 150 000 samples), held
    three ways, else raise: against `costas_scan` then `mm_scan` on the
    card, symbols, valid mask, every carry and the new tail equal to the
    bit; its Costas output and carries against the recorded plain Costas
    loop's, by `held`; its symbols, valid mask and carries against the
    plain M&M loop on the CPU over its own Costas output, equal to the
    bit.  Timed: the device ms of one launch of each of the three
    (profiler), the fused one by CUDA events too, and the two plain
    loops on the card over the row's first ``plain_n`` samples.  The
    contract's bound counts x, the turned samples, the symbols and mask
    once each and both loops' operations; the reckoned serial bound,
    max(Costas chain, M&M chain) plus the M&M walk of its last window,
    is not a measurement."""
    from sdrtpu_torch.kernels import clock, loops

    def card(t):
        return t.cuda().contiguous() if torch.is_tensor(t) else t

    (c_args, c_out), = costas_calls
    (m_args, _), = mm_calls
    x, ph0, fr0, alpha, beta, fmin, fmax, mode = map(card, c_args)
    ext, bank, n, n_out, off, fstate, cstate, *gains = map(card, m_args)
    tail = ext[:, :ext.shape[1] - n].contiguous()
    carries = [off, *(fstate[:, k].contiguous() for k in range(3)),
               *(cstate[:, k].contiguous() for k in range(4))]
    coef = (alpha, beta, fmin, fmax, mode)
    fused = (x, tail, ph0, fr0, *coef, bank, n_out, carries, *gains)
    got = clock.costas_mm_scan(*fused)
    y, ph, fr = loops.costas_scan(x, ph0, fr0, *coef)
    e = torch.cat([tail, y], dim=-1)
    syms, valid, o, f, c = clock.mm_scan(e, bank, n, n_out, off, fstate,
                                         cstate, *gains)
    want = (y, ph, fr, syms, valid, e[:, n:],
            (o - n, *f.unbind(1), *c.unbind(1)))
    torch.cuda.synchronize()
    differ = [k for k, (g, w) in enumerate(zip(
        list(got[:-1]) + list(got[-1]), list(want[:-1]) + list(want[-1])))
        if not same_bits(g.cpu(), w.cpu())]
    if differ:
        raise AssertionError(f"meteor: costas_mm_scan differs from "
                             f"costas_scan then mm_scan in outputs {differ}")
    costas_check = held("costas_scan", got[:3], c_out,
                        "the meteor path's first block, costas_mm_scan")
    g_y, g_ph, g_fr, g_syms, g_valid, g_tail, g_carries = (
        [t.cpu() for t in got[:-1]] + [[t.cpu() for t in got[-1]]])
    g_ext = torch.cat([tail.cpu(), g_y], dim=-1)
    with torch.inference_mode():
        plain = clock.mm_scan_ref(
            g_ext, bank.cpu(), n, n_out, off.cpu(), fstate.cpu(),
            cstate.cpu(), *gains)
    g_off, *g_rest = g_carries
    mm_check = held("mm_scan", (g_syms, g_valid, g_off + n,
                                torch.stack(g_rest[:3], 1),
                                torch.stack(g_rest[3:], 1)), plain,
                    "the meteor path's first block, costas_mm_scan's "
                    "M&M on its own Costas output")
    if not same_bits(g_tail, g_ext[:, n:]):
        raise AssertionError("meteor: costas_mm_scan's new tail is not "
                             "the last samples of its Costas output")
    xs = x[:, :plain_n].contiguous()
    n_out_s = int(np.ceil(plain_n * n_out / n)) + 2  # the block's slots

    def plain_loops():
        ys, *_ = loops.costas_scan_ref(xs, ph0, fr0, *coef)
        clock.mm_scan_ref(torch.cat([tail, ys], dim=-1), bank, plain_n,
                          n_out_s, off, fstate, cstate, *gains)

    n_valid = int(valid.sum())
    cmode = int(mode)
    window = int(np.ceil(2048 * n_valid / n))  # symbols in the last window
    return {
        "samples": n, "symbols": n_valid, "bit_equal_two_launches": True,
        "costas_vs_plain": costas_check, "mm_vs_plain": mm_check,
        "ms": device_ms(lambda: clock.costas_mm_scan(*fused), 5,
                        "costas_scan_into_mm_scan_kernel"),
        "costas_scan_ms": device_ms(lambda: loops.costas_scan(
            x, ph0, fr0, *coef), 5, "costas_scan_kernel"),
        "mm_scan_ms": device_ms(lambda: clock.mm_scan(
            e, bank, n, n_out, off, fstate, cstate, *gains), 5,
            "mm_scan_kernel"),
        "event_ms": cuda_ms(lambda: clock.costas_mm_scan(*fused), 5),
        "plain_ms": wall_ms(plain_loops), "plain_shape": [1, plain_n],
        **roofline(16 * n + 16 + 9 * n_out + 4096 + 2 * 8 * tail.shape[1],
                   40 * n + 40 * n_valid),
        "serial_bound_ms": max(
            serial_chain_ms(n, costas_chains(cmode)[0]),
            serial_chain_ms(n_valid, MM_CHAIN))
        + serial_chain_ms(window, MM_CHAIN)}


def costas_mm_entry(check: dict, launches: int, ms_on_path) -> dict:
    """The `kernels` line's entry of `costas_mm_scan`, from the meteor
    path's `hold_costas_mm` and its launches."""
    return {
        "name": "costas_mm_scan", "route": "cuda",
        "source": "sdrtpu_torch/csrc/sync_loops.cu",
        # the reference's lax.scans of the two loops, one after the other
        "replaces": ["sdrtpu/kernels/loops.py:144",
                     "sdrtpu/kernels/clock.py:165"],
        "launches": launches,
        "max_abs_err": max(check["costas_vs_plain"]["max_abs_err"],
                           check["mm_vs_plain"]["max_abs_err"]),
        "rel_tol": COSTAS_REL_TOL, "carry_atol": COSTAS_PHASE_ATOL,
        "mm_bits": "equal", "path_check": {k: check[k] for k in (
            "symbols", "bit_equal_two_launches", "costas_vs_plain",
            "mm_vs_plain", "costas_scan_ms", "mm_scan_ms")},
        "ms": check["ms"], "ms_on_path": ms_on_path,
        "event_ms": check["event_ms"], "plain_ms": check["plain_ms"],
        "plain_shape": check["plain_shape"],
        "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
        "serial_bound_ms": check["serial_bound_ms"],
        "library_ms": None,  # no PyTorch call computes these recurrences
        "shape": [1, check["samples"]]}


def phase_meteor(card: str, profile_path: str | None = None) -> dict:
    """The Meteor M2 LRPT receive path on the card, as
    examples/meteor_lrpt.py runs it: `MeteorDemod` (its defaults: the
    configuration's published parameters) on 16 blocks of 1 s, the valid
    symbols to `QpskAmbiguityResolver.process` (Viterbi on the card, ASM
    search and RS on the host) and to a `SoftSymbolWriter`; then the
    `.s` file read back and deframed once more.  The capture locks on
    rotation 0; its first two blocks turned by 90 degrees lock on
    rotation 1 and give the same frames.

    Launch counts, worked out from the code: one costas_mm_scan per
    block, which counts one costas_scan and one mm_scan; viterbi_decode
    as `expected_viterbi` from the block and rotation the resolver
    locked on; nothing else.

    Then the port on the CPU runs the first block (150 000 samples, the
    path's shape), its symbols and frames held against the card's; the
    inputs and outputs of its three plain versions are recorded and each
    kernel is launched on the card on those inputs and held against them
    (``kernel_checks``)."""
    import copy

    from sdrtpu_torch.decoders import ccsds
    from sdrtpu_torch.io.symbols import (SoftSymbolWriter, quantize_soft,
                                         read_soft_file)
    from sdrtpu_torch.kernels.psk import MeteorDemod

    t0 = time.perf_counter()
    cvs, x = meteor_capture(23)
    capture_s = time.perf_counter() - t0
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    s_path = os.path.join(out_dir, "meteor.s")

    acc = {}

    def run_blocks(state, resolver, x, first, last, writer=None, times=None):
        frames = []
        for b in range(first, last):
            before = dict(acc)
            t0 = time.perf_counter()
            xb = torch.as_tensor(x[b * METEOR_BLOCK:(b + 1) * METEOR_BLOCK],
                                 device="cuda")
            state, (syms, valid) = demod(state, xb)
            t1 = time.perf_counter()
            got = syms[valid]  # waits for the card
            t2 = time.perf_counter()
            new = resolver.process(got)
            t3 = time.perf_counter()
            if writer is not None:
                writer.write(got)
            frames += new
            if times is not None:
                spent = {k: acc.get(k, 0.0) - before.get(k, 0.0)
                         for k in ("deframe", "scan", "rs")}
                times.append({
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "demod_enqueue_ms": (t1 - t0) * 1e3,
                    "symbols_wait_ms": (t2 - t1) * 1e3,
                    "viterbi_wait_copy_ms": spent["deframe"] - spent["scan"],
                    "asm_search_ms": spent["scan"] - spent["rs"],
                    "rs_decode_ms": spent["rs"],
                    "resolver_other_ms": (t3 - t2) * 1e3 - spent["deframe"],
                    "soft_write_ms": (time.perf_counter() - t3) * 1e3,
                    "symbols": int(got.shape[0]), "frames": len(new),
                    "locked": resolver.locked, "first_symbols": got})
        return state, frames

    counters = kernel_counters()
    demod = MeteorDemod(device="cuda")
    resolver = ccsds.QpskAmbiguityResolver(device="cuda")
    state = demod.init_state()
    with host_timers(acc):
        for fn in counters.values():
            fn.launches = 0
        times, frames = [], []
        with SoftSymbolWriter(s_path) as writer, SmClocks() as run_clocks:
            state, frames = run_blocks(state, resolver, x, 0,
                                       METEOR_PROFILED, writer, times)
            snapshot = copy.deepcopy((state, resolver))
            state, more = run_blocks(state, resolver, x, METEOR_PROFILED,
                                     METEOR_BLOCKS, writer, times)
            frames += more
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        main_calls = acc["deframe_calls"]
        lock = next(b for b, t in enumerate(times) if t["locked"] is not None)
        want = expected_launches(
            costas_scan=METEOR_BLOCKS, mm_scan=METEOR_BLOCKS,
            costas_mm_scan=METEOR_BLOCKS,
            viterbi_decode=expected_viterbi(METEOR_BLOCKS, lock, 0))
        if resolver.locked != 0 or launches != want:
            raise AssertionError(
                f"meteor path locked rotation {resolver.locked} on block "
                f"{lock} and launched {launches}, want rotation 0 and {want}")
        skip = check_frames(frames, cvs, "direct")
        if [len(f) for f in resolver.frames] != [len(f) for f in frames]:
            raise AssertionError("meteor: the resolver's frame log differs")

        # the first two blocks turned by 90 degrees: the resolver tries
        # both candidates and locks on rotation 1, with the same frames
        x_rot = x[:2 * METEOR_BLOCK] * np.complex64(1j)
        for fn in counters.values():
            fn.launches = 0
        res_rot, times_rot = ccsds.QpskAmbiguityResolver(device="cuda"), []
        _, frames_rot = run_blocks(demod.init_state(), res_rot, x_rot, 0, 2,
                                   times=times_rot)
        torch.cuda.synchronize()
        launches_rot = {name: fn.launches for name, fn in counters.items()}
        n_first = times[0]["frames"] + times[1]["frames"]
        lock_rot = next((b for b, t in enumerate(times_rot)
                         if t["locked"] is not None), None)
        want_rot = expected_launches(
            costas_scan=2, mm_scan=2, costas_mm_scan=2,
            viterbi_decode=expected_viterbi(2, lock_rot or 0, 1))
        if (res_rot.locked != 1 or launches_rot != want_rot
                or len(frames_rot) != n_first or not all(
                    np.array_equal(a, b)
                    for a, b in zip(frames_rot, frames[:n_first]))):
            raise AssertionError(
                f"meteor, turned 90 degrees: locked rotation "
                f"{res_rot.locked}, launched {launches_rot} (want "
                f"{want_rot}), {len(frames_rot)} frames for {n_first}")

        # the .s round trip: read back, deframe in one call
        soft_syms = read_soft_file(s_path)
        for fn in counters.values():
            fn.launches = 0
        calls_before = acc["deframe_calls"]
        t0 = time.perf_counter()
        frames_s, res_s = ccsds.deframe_qpsk_symbols(soft_syms, device="cuda")
        torch.cuda.synchronize()
        s_trip_s = time.perf_counter() - t0
        launches_s = {name: fn.launches for name, fn in counters.items()}
        if launches_s != expected_launches(
                viterbi_decode=acc["deframe_calls"] - calls_before):
            raise AssertionError(f"meteor .s round trip launched {launches_s}")
        skip_s = check_frames(frames_s, cvs, ".s round trip")

    # where the time goes: 4 blocks again from the snapshot, profiled
    st_p, res_p = snapshot
    with SmClocks() as prof_clocks:
        prof, p_wall, busy_us = profiled(
            lambda: run_blocks(st_p, res_p, x, METEOR_PROFILED,
                               METEOR_PROFILED + 4))
    on_path = kernel_ms_per_launch(
        prof, ("costas_scan_into_mm_scan_kernel", "viterbi_kernel"))
    busy_ms_block = busy_us / 1e3 / 4
    steady = times[METEOR_PROFILED:METEOR_PROFILED + 4]
    wall_ms_block = float(np.median([t["ms"] for t in steady]))
    if profile_path:
        os.makedirs(os.path.dirname(profile_path) or ".", exist_ok=True)
        with open(profile_path, "w") as fh:
            fh.write(f"{card}\nmeteor path: 4 blocks of {METEOR_BLOCK}; wall "
                     f"{p_wall * 1e3:.3f} ms under the profiler; device busy "
                     f"{busy_us / 1e3:.3f} ms\n")
            fh.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=30))
        log(f"profile -> {profile_path}")

    # the port on the CPU over the first block, the plain versions'
    # inputs and outputs recorded
    with recording("costas_scan", "mm_scan", "viterbi_decode") as recorded:
        t0 = time.perf_counter()
        cpu_demod = MeteorDemod(device="cpu")
        with torch.inference_mode():  # less work per op in the plain loops
            _, (syms, valid) = cpu_demod(cpu_demod.init_state(),
                                         torch.as_tensor(x[:METEOR_BLOCK]))
            c = syms[valid]
            frames_cpu = ccsds.QpskAmbiguityResolver(device="cpu").process(c)
        cpu_s = time.perf_counter() - t0
    g, c = times[0]["first_symbols"].cpu().numpy(), c.numpy()
    m = min(len(g), len(c))
    close = float(np.isclose(g[:m], c[:m], atol=METEOR_SYM_ATOL).mean())
    byte_match = float((quantize_soft(g[:m]) == quantize_soft(c[:m])).mean())
    n0 = times[0]["frames"]
    if not (abs(len(g) - len(c)) <= 2 and close > METEOR_CLOSE_SHARE
            and byte_match > METEOR_BYTE_SHARE and len(frames_cpu) == n0
            and all(np.array_equal(a, b)
                    for a, b in zip(frames_cpu, frames[:n0]))):
        raise AssertionError(
            f"meteor: card vs CPU: {len(g)} vs {len(c)} symbols, close "
            f"{close}, .s bytes equal {byte_match}, {len(frames_cpu)} frames "
            f"for the card's {n0}")
    kernel_checks = {}
    for name, calls in recorded.items():
        # each recorded call again, its kernel on the card
        kernel_checks[name] = hold_recorded(name, calls, "the meteor path")
        log(f"meteor: {name} held on the path's inputs: "
            f"{kernel_checks[name]}")
    kernel_checks["costas_mm_scan"] = hold_costas_mm(
        recorded["costas_scan"], recorded["mm_scan"])
    log(f"meteor: costas_mm_scan on the path's inputs: "
        f"{kernel_checks['costas_mm_scan']}")

    total_s = sum(t["ms"] for t in times) / 1e3
    after = times[lock + 1:]
    split = ("demod_enqueue_ms", "symbols_wait_ms", "viterbi_wait_copy_ms",
             "asm_search_ms", "rs_decode_ms", "resolver_other_ms",
             "soft_write_ms")
    return {
        "meteor": "Meteor M2 LRPT: MeteorDemod defaults (72 ksym/s from 150 "
                  "ksps, RRC 33 taps beta 0.6, AGC 0.1, Costas bw 0.005, "
                  "omega gain 1e-6, mu gain 0.01), CCSDS K=7 r=1/2, "
                  f"RS(255,223) x 4; {METEOR_BLOCKS} blocks of "
                  f"{METEOR_BLOCK} samples",
        "blocks": METEOR_BLOCKS, "samples": METEOR_BLOCKS * METEOR_BLOCK,
        "frames_sent": len(cvs), "frames": len(frames),
        "frames_missed_at_head": skip,
        "s_round_trip_frames": len(frames_s),
        "s_round_trip_missed_at_head": skip_s,
        "s_round_trip_seconds": s_trip_s,
        "symbols": sum(t["symbols"] for t in times),
        "locked_rotation": resolver.locked, "locked_at_block": lock,
        "turned_90": {"blocks": 2, "locked_rotation": res_rot.locked,
                      "locked_at_block": lock_rot, "frames": len(frames_rot),
                      "kernel_launches": launches_rot},
        "rs_corrections": {"frames": len(resolver.rs_errors),
                           "total": int(sum(resolver.rs_errors)),
                           "max_per_frame": int(max(resolver.rs_errors)),
                           "mean_per_frame": float(np.mean(
                               resolver.rs_errors))},
        "kernel_launches": launches, "deframer_calls": main_calls,
        "s_round_trip_launches": launches_s,
        "ms_per_block": [t["ms"] for t in times],
        "median_ms_per_block_after_lock": float(np.median(
            [t["ms"] for t in after])),
        "real_time_factor": METEOR_BLOCKS * METEOR_BLOCK / METEOR_FS / total_s,
        "real_time_factor_after_lock": len(after) * METEOR_BLOCK / METEOR_FS
        / (sum(t["ms"] for t in after) / 1e3),
        # host clock around each part of a block, median over the blocks
        # after the lock; the two waits include the card's kernels
        "split_ms_per_block_after_lock": {
            k: float(np.median([t[k] for t in after])) for k in split},
        "rs_ms_per_frame_after_lock": sum(t["rs_decode_ms"] for t in after)
        / max(1, sum(t["frames"] for t in after)),
        "device_busy_ms_per_block": busy_ms_block,
        "device_busy_share": busy_ms_block / wall_ms_block,
        # each kernel's device ms per launch inside the profiled window
        "kernel_ms_on_path": on_path,
        "sm_clock_mhz": run_clocks.summary(),
        "profiled_sm_clock_mhz": prof_clocks.summary(),
        "card_vs_cpu": {"samples": METEOR_BLOCK, "symbols": [len(g), len(c)],
                        "close_share": close,
                        "s_bytes_equal_share": byte_match,
                        "frames": [n0, len(frames_cpu)],
                        "cpu_seconds": cpu_s},
        "kernel_checks": kernel_checks,
        "capture_seconds": capture_s,
        "card": card,
    }


def phase_rds(card: str) -> dict:
    """RDS on the card: the fixture's first 0.6 s through
    `BroadcastFm(pilot_mode="pll", rds_out=True)` in 6 blocks of 25 000,
    `RdsDemod` on each block's 500-sample tap, `RdsDecoder` on the valid
    bits: PI 0xF00D and PS "SDRTPU  " (tests/test_oracle_parity.py:
    304-305).  Launches: two costas_scan, one mm_scan and one pll_scan
    per block, nothing else."""
    from sdrtpu_torch.decoders.rds import RdsDecoder, RdsDemod
    from sdrtpu_torch.io.wav import read_iq_wav
    from sdrtpu_torch.kernels.wfm import BroadcastFm

    info, iq = read_iq_wav(RDS_FIXTURE)
    fm = BroadcastFm(75000.0, float(info.samplerate), rds_out=True,
                     pilot_mode="pll", device="cuda")
    demod, dec = RdsDemod(device="cuda"), RdsDecoder()
    sf, sd = fm.init_state(), demod.init_state()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode(), recording("pll_scan") as calls:
        for b in range(RDS_BLOCKS):
            xb = torch.as_tensor(iq[b * RDS_BLOCK:(b + 1) * RDS_BLOCK],
                                 device="cuda")
            sf, (_, tap) = fm(sf, xb)
            sd, (bits, valid) = demod(sd, tap)
            dec.process(bits[valid].cpu().numpy())
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches(costas_scan=2 * RDS_BLOCKS, mm_scan=RDS_BLOCKS,
                             pll_scan=RDS_BLOCKS)
    if launches != want:
        raise AssertionError(f"rds path launched {launches}, want {want}")
    if dec.pi_code != 0xF00D or dec.program_service_name != "SDRTPU  ":
        raise AssertionError(f"rds: PI {dec.pi_code} PS "
                             f"{dec.program_service_name!r}")
    return {"rds": "BroadcastFm pll + rds_out, RdsDemod, RdsDecoder on "
                   f"{RDS_FIXTURE}: 6 blocks of 25 000 samples at 250 kHz",
            "pi": f"{dec.pi_code:#06x}", "ps": dec.program_service_name,
            "kernel_launches": launches,
            "ms_per_block": wall * 1e3 / RDS_BLOCKS,
            "pll_check": hold_pll_calls(calls["pll_scan"], "the rds path"),
            "card": card}


# -- Viterbi rates 1/3 and 1/4, wider M&M banks, fp32 pinned against TF32,
# and the DAB, Falcon 9, KG-STV, M17 and RyFi chains

DAB_FRAMES = 10           # 0.96 s of mode I, 1 966 080 samples
DAB_JUNK = 5000           # samples ahead of the first null symbol
DAB_NOISE = 0.02          # AWGN per component, as tests/test_dab.py
DAB_EID, DAB_SID = 0xD1E5, 0xC0DE
FALCON_FRAMES = 64        # RS frames, each with two packets
FALCON_BLOCK = 60_000     # 10 ms at 6 Msps
FALCON_NOISE = 0.05
KG_FS = 4800.0            # tests/test_kg_sstv.py's rate, two frames
KG_BLOCKS = 4
M17_FS, M17_BAUD, M17_DEV = 48000.0, 4800.0, 2400.0  # examples/m17_voice.py
M17_STREAM_FRAMES = 16
M17_EXAMPLE_LOST = 1      # stream frames lost besides the LSF after the
                          # example's alternating preamble (ROADMAP Queue 3)
M17_BLOCK = 9600          # 200 ms at 48 kHz
RYFI_BAUD, RYFI_SPS = 20000.0, 4   # examples/ryfi_link.py's defaults
RYFI_ESN0_DB, RYFI_OFFSET_HZ, RYFI_PHASE = 8.0, 100.0, 0.7
RYFI_BLOCK = 16384        # the receive loop's block, as the example
RYFI_CPU_BLOCKS = 5       # the first idle frame and the first data frame


def viterbi_row(sym, dec, reps: int = 20) -> dict:
    """viterbi_decode at ``sym``'s shape: device ms (profiler), CUDA-event
    ms, the plain version's wall ms on the card (held bit-equal), the
    bound."""
    from sdrtpu_torch.fec import viterbi as tv

    args = (sym, dec.exp_prev, dec.prev, dec.prev_bit)
    got = tv.viterbi_decode(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tv.viterbi_decode_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows, n, R = sym.shape
    out = {"shape": [rows, n], "K": dec.K, "R": R,
           **held("viterbi_decode", got, want, f"{(rows, n, R, dec.K)}"),
           "ms": device_ms(lambda: tv.viterbi_decode(*args), reps,
                           "viterbi_kernel"),
           "event_ms": cuda_ms(lambda: tv.viterbi_decode(*args), reps),
           "plain_ms": plain_ms,
           # soft symbols in, bits and metrics out; per step and state two
           # branch metrics (R mul, R - 1 add), two adds, a compare, a
           # select, a share of the max and the subtract
           **roofline(rows * n * (4 * R + 1) + rows * dec.S * 4,
                      rows * n * dec.S * (2 * (2 * R - 1) + 6))}
    pr5 = (VITERBI_CHAIN_PR5[0] + 4 * (R - 2), 0)  # its metrics on the chain
    log(f"viterbi_decode {(rows, n, R, dec.K)}: {out}; "
        f"{reckoned(n, VITERBI_CHAIN, pr5)}")
    return out


def phase_rates_and_banks() -> dict:
    """viterbi_decode at R = 3 and 4 with K = 7 and 5, and mm_scan at the
    wider banks (16 taps x 256 phases, 8 x 1024, 32 x 1600: above the
    default 48 KB of shared memory), each against its plain version on
    the card: bits and metrics equal (Viterbi), valid slots and offsets
    equal, symbols equal to the bit (M&M; `held`).
    Returns the rows for the kernels line."""
    from sdrtpu_torch.fec import viterbi as tv
    from sdrtpu_torch.kernels import clock

    rng = np.random.default_rng(61)
    dab = (0o133, 0o171, 0o145, 0o133)
    vit = []
    for K, polys, rows, n in [(7, dab, 1, 2000), (5, dab, 1, 2000),
                              (7, dab[:3], 1, 2000), (5, dab[:3], 2, 1500)]:
        enc = tv.ConvEncoder(K, polys)
        dec = tv.ViterbiDecoder(K, polys, device="cuda")
        soft = np.stack([enc.encode_to_soft(rng.integers(0, 2, n))
                         for _ in range(rows)])
        soft = soft + 0.8 * rng.standard_normal(soft.shape)
        sym = torch.as_tensor(soft.astype(np.float32).reshape(
            rows, n, len(polys)), device="cuda")
        vit.append(viterbi_row(sym, dec))
    mm = []
    for cplx, n, taps, phases in [(True, 3000, 16, 256),
                                  (False, 3000, 16, 256),
                                  (True, 3000, 8, 1024),
                                  (False, 2000, 32, 1600)]:
        omega = 25.0 / 12.0 if cplx else 5000.0 / 1187.5
        m = clock.MuellerMuller(omega, 1e-6, 0.01, 0.01, complex_mode=cplx,
                                interp_phase_count=phases,
                                interp_tap_count=taps, device="cuda")
        if cplx:
            x = qpsk_rrc(rng, n * 12 // 25 + 1)[:n]
        else:
            x = bpsk_real(rng, int(n / omega) + 1, omega)[:n]
        st = m.init_state()
        ext = torch.cat([st["tail"], torch.as_tensor(
            x.astype(np.complex64 if cplx else np.float32),
            device="cuda")])[None].contiguous()
        args = (ext, m._bank, n, m.max_out(n), st["offset"].reshape(1),
                torch.stack([st["phase"], st["freq"], st["last_out"]])[None],
                torch.stack([st[k] for k in ("p1", "p2", "c1", "c2")])[None],
                float(np.float32(m.omega * (1 - m.omega_rel_limit))),
                float(np.float32(m.omega * (1 + m.omega_rel_limit))),
                float(np.float32(m.omega_gain)), float(np.float32(m.mu_gain)))
        got = clock.mm_scan(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = clock.mm_scan_ref(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        item = 8 if cplx else 4
        n_valid = int(got[1].sum().item())
        row = {"shape": [1, n], "complex": cplx, "taps": taps,
               "phases": phases, "bank_bytes": phases * taps * 4,
               "symbols": n_valid,
               **held("mm_scan", got, want, (cplx, n, taps, phases)),
               "ms": device_ms(lambda: clock.mm_scan(*args), 20,
                               "mm_scan_kernel"),
               "plain_ms": plain_ms,
               **roofline(item * (n + taps - 1) + (item + 1) * args[3]
                          + phases * taps * 4,
                          (2 * taps + 30) * n_valid)}
        # the pairwise sum is log2(taps) adds deep, 3 of them in MM_CHAIN
        extra = taps.bit_length() - 4
        log(f"mm_scan wide bank {(cplx, n, taps, phases)}: {row}; "
            + reckoned(n_valid, (MM_CHAIN[0] + extra, 0),
                       (MM_CHAIN_PR5[0] + extra, 0)))
        mm.append(row)
        del ext, got, want
    return {"viterbi_decode": vit, "mm_scan": mm}


def phase_tf32(card: str) -> dict:
    """With TF32 turned on globally (``set_float32_matmul_precision
    ("high")``, ``cudnn.allow_tf32``) the port's pinned contractions at
    the flagship's shapes give the bits they give with the default flags:
    the alias fold of a 500 000-sample block (8 VFOs), the 317-tap pilot
    FIR (banded-Toeplitz matmuls) over the 8 VFOs' IF block and the
    24/125 audio resampler over their two audio planes.  The caller's
    flags are set again afterwards."""
    pipe, x_host = build_flagship("cuda")
    fused = pipe.channelizer.fused
    pilot = pipe.demod.pilot_fir
    resamp = pipe.audio_resamp.resamp
    assert pilot.method == "mm" and len(pilot.taps) == 317, (
        pilot.method, len(pilot.taps))
    rng = np.random.default_rng(32)
    x = torch.as_tensor(x_host, device="cuda")
    n_if = pipe.channelizer.out_len(pipe.block_len)
    mpx = torch.as_tensor(rng.standard_normal((8, n_if)).astype(np.float32),
                          device="cuda")
    audio = torch.as_tensor(rng.standard_normal((2, 8, n_if)).astype(
        np.float32), device="cuda")
    fns = {
        "alias fold (fft channelizer, 8 VFOs, 500 000 samples)":
            lambda: fused(fused.init_state(), x)[1],
        f"pilot FIR ({len(pilot.taps)} taps, 8 x {n_if})":
            lambda: pilot(pilot.init_state(), mpx)[1],
        f"audio resampler ({resamp.interp}/{resamp.decim}, 2 x 8 x {n_if})":
            lambda: resamp(resamp.init_state(), audio)[1],
    }
    assert not torch.backends.cuda.matmul.allow_tf32
    want = {k: fn() for k, fn in fns.items()}
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        got = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        still = (torch.get_float32_matmul_precision(),
                 torch.backends.cudnn.allow_tf32)
        a = mpx[:, :4096].contiguous()
        unpinned = a @ a.T  # the same product outside the helper: TF32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    if still != ("high", True):
        raise AssertionError(f"tf32: the caller's flags became {still}")
    differ = [k for k in fns if not torch.equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"tf32: {differ} changed with TF32 on")
    # the flags did reach cuBLAS: the same product outside the helper
    # changed, else the phase tested nothing
    if torch.equal(unpinned, a @ a.T):
        raise AssertionError("tf32: the unpinned product did not change "
                             "with TF32 on; the flags did not switch cuBLAS")
    return {"tf32": "TF32 on globally; the port's contractions pinned to "
                    "float32 give the default bits",
            "held_bit_equal": list(fns),
            "unpinned_matmul_changed": True,
            "card": card}


def _dab_fibs(frame: int) -> np.ndarray:
    from sdrtpu_torch.decoders import dab

    fibs = [dab.build_fib([dab.make_fig_0_0(DAB_EID, cif_count=frame),
                           dab.make_fig_1_0(DAB_EID, "SDRTPU ENSEMBLE")]),
            dab.build_fib([dab.make_fig_1_1(DAB_SID, "TPU RADIO 1")])]
    fibs += [dab.build_fib([])] * (dab.FIBS_PER_FRAME - len(fibs))
    return np.stack(fibs)


def dab_capture(seed: int):
    """DAB_FRAMES consecutive mode-I frames after DAB_JUNK samples of the
    last frame's tail, a null symbol after them, AWGN.  Each frame's FIC
    carries 12 FIBs (FIG 0/0 with the frame's CIF count, the ensemble
    label, the service label); its MSC symbols are seeded random dibits.
    Returns (fibs per frame, dibits per frame, complex64 samples)."""
    from sdrtpu_torch.decoders import dab

    rng = np.random.default_rng(seed)
    mod = dab.DabModulator()
    fibs, dibits, frames = [], [], []
    for f in range(DAB_FRAMES):
        fibs.append(_dab_fibs(f))
        d = np.concatenate([mod.fic_to_symbols(fibs[-1]), rng.integers(
            0, 4, (dab.NUM_SYMS - 1 - dab.FIC_SYMS, dab.CARRIERS))])
        dibits.append(d)
        frames.append(mod.modulate_frame(d))
    x = np.concatenate([frames[-1][-DAB_JUNK:], *frames,
                        np.zeros(dab.NULL, np.complex64)])
    x = x + DAB_NOISE * (rng.standard_normal(x.size)
                         + 1j * rng.standard_normal(x.size))
    return fibs, dibits, x.astype(np.complex64)


def phase_dab(card: str) -> dict:
    """DAB transmission mode I (EN 300 401; 2.048 Msps, 2048-point FFT,
    1536 carriers, 76 symbols, 2656-sample null) on the card: per frame
    `find_null` on the host (over a window from 2 000 samples before the
    expected start), `demod_frame` on the card (one batched FFT, the
    carrier gather, the differential product, the slice), `decode_fic`
    (depuncture on the card, the four codewords as the four rows of ONE
    rate-1/4 K=7 `viterbi_decode` launch, CRC on the host).  Launches:
    viterbi_decode one a frame, nothing else.  Then the port on the CPU
    over the first frame: the same dibits and FIBs, its plain Viterbi's
    inputs held against the kernel; the kernel timed at the frame's
    shape; 3 frames again under the profiler for the busy share."""
    from sdrtpu_torch.decoders import dab

    t0 = time.perf_counter()
    fibs_sent, dibits_sent, x = dab_capture(71)
    capture_s = time.perf_counter() - t0
    dem = dab.DabDemodulator(device="cuda")

    def run(n_frames):
        starts, out, ms = [], [], []
        start = dem.find_null(x[:DAB_JUNK + dab.FRAME + dab.NULL])
        for f in range(n_frames):
            t0 = time.perf_counter()
            if f:
                lo = starts[-1] + dab.FRAME - 2000
                start = lo + dem.find_null(x[lo:lo + 2000 + dab.FRAME
                                             + dab.NULL])
            frame = torch.as_tensor(x[start:start + dab.FRAME], device="cuda")
            d = dem.demod_frame(frame)
            fibs, ok = dem.decode_fic(d)
            ms.append((time.perf_counter() - t0) * 1e3)
            starts.append(start)
            out.append((d, fibs, ok))
        return starts, out, ms

    run(1)  # warm-up: cuFFT plan, kernel load
    torch.cuda.synchronize()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    starts, out, ms = run(DAB_FRAMES)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches(viterbi_decode=DAB_FRAMES)
    if launches != want:
        raise AssertionError(f"dab path launched {launches}, want {want}")
    if starts != [DAB_JUNK + f * dab.FRAME for f in range(DAB_FRAMES)]:
        raise AssertionError(f"dab: frames found at {starts}")
    n_ok = sum(int(ok.sum()) for _, _, ok in out)
    equal = sum(int((got == sent).all(axis=1).sum())
                for (_, got, _), sent in zip(out, fibs_sent))
    if n_ok != 12 * DAB_FRAMES or equal != 12 * DAB_FRAMES:
        raise AssertionError(f"dab: {n_ok} FIBs pass CRC, {equal} equal, "
                             f"of {12 * DAB_FRAMES}")
    for f, (_, got, _) in enumerate(out):
        figs = dab.parse_figs(got[0]) + dab.parse_figs(got[1])
        if ({"type": (0, 0), "eid": DAB_EID, "change": 0, "cif_count": f}
                not in figs
                or [g["label"].strip() for g in figs if g["type"] == (1, 0)
                    and g["eid"] == DAB_EID] != ["SDRTPU ENSEMBLE"]
                or [g["label"].strip() for g in figs if g["type"] == (1, 1)
                    and g["sid"] == DAB_SID] != ["TPU RADIO 1"]):
            raise AssertionError(f"dab frame {f}: FIGs {figs}")
    wrong = sum(int((d.cpu().numpy() != sent).sum())
                for (d, _, _), sent in zip(out, dibits_sent))
    # the port on the CPU over the first frame
    with recording("viterbi_decode") as calls:
        cpu = dab.DabDemodulator(device="cpu")
        t0 = time.perf_counter()
        d_cpu = cpu.demod_frame(x[DAB_JUNK:DAB_JUNK + dab.FRAME])
        fibs_cpu, ok_cpu = cpu.decode_fic(d_cpu)
        cpu_s = time.perf_counter() - t0
    if not (torch.equal(d_cpu, out[0][0].cpu())
            and np.array_equal(fibs_cpu, out[0][1]) and ok_cpu.all()):
        raise AssertionError("dab: the card's first frame differs from the "
                             "CPU's")
    check = hold_recorded("viterbi_decode", calls["viterbi_decode"],
                          "the dab path")
    args = calls["viterbi_decode"][0][0]
    path_row = viterbi_row(args[0].cuda(), dem.viterbi)
    with SmClocks() as clocks:
        prof, p_wall, busy_us = profiled(lambda: run(3))
    on_path = kernel_ms_per_launch(prof, ("viterbi_kernel", "fft"))
    ms_frame = float(np.median(ms))
    return {
        "dab": "DAB mode I (EN 300 401): 2.048 Msps, 2048-point FFT, 1536 "
               "carriers, 76 symbols, 2656-sample null; FIC rate-1/4 K=7 "
               f"punctured; {DAB_FRAMES} frames after {DAB_JUNK} junk "
               f"samples, AWGN {DAB_NOISE}",
        "frames": DAB_FRAMES, "samples": int(x.size),
        "frame_starts_ok": True, "fibs_crc_ok": n_ok, "fibs_equal": equal,
        "msc_dibits_wrong": wrong, "kernel_launches": launches,
        "viterbi_launch_shape": path_row["shape"] + [4],
        "ms_per_frame": ms, "median_ms_per_frame": ms_frame,
        "real_time_factor": 96.0 / ms_frame,
        "wall_s": wall,
        "device_busy_share": busy_us / 1e3 / (p_wall * 1e3),
        "device_busy_ms_per_frame": busy_us / 1e3 / 3,
        "kernel_ms_on_path": on_path,
        "sm_clock_mhz": clocks.summary(),
        "card_vs_cpu": {"frame": 0, "dibits_equal": True,
                        "fibs_equal": True, "cpu_seconds": cpu_s},
        "kernel_check": check, "viterbi_at_path_shape": path_row,
        "capture_seconds": capture_s, "card": card,
    }


def falcon_capture(seed: int):
    """FALCON_FRAMES RS frames of the Falcon 9 downlink at the published
    rates (6 Msps, 2 MHz deviation, 3.5714 Mbaud, sps 1.68): each frame
    a 4-byte header (counter, pointer 0) and two packets, a telemetry
    packet and a GPS text packet, ASM-framed and NRZ; the FM phase
    accumulated sample by sample at t = k / fs; AWGN.  Padded to whole
    blocks.  Returns (packets sent, complex64 samples)."""
    from sdrtpu_torch.decoders import falcon9 as f9

    rng = np.random.default_rng(seed)

    def packet(pkt_id, payload):
        n = 10 + len(payload)
        return bytes([((n - 2) >> 8) & 0x0F, (n - 2) & 0xFF]
                     ) + pkt_id.to_bytes(8, "big") + payload

    sent, bits = [], [rng.integers(0, 2, 400).astype(np.uint8)]
    for i in range(FALCON_FRAMES):
        tlm = b"TLM %04d " % i + bytes(rng.integers(0, 256, 300,
                                                    dtype=np.uint8))
        gps = b"GPS WEEK 2300 FRAME %04d" % i
        body = packet(f9.PKT_TLM, tlm) + packet(f9.PKT_GPS_TEXT[0], gps)
        sent += [(f9.PKT_TLM, tlm), (f9.PKT_GPS_TEXT[0], gps)]
        counter = 1000 + i
        hdr = bytes([(counter >> 13) & 0x3F, (counter >> 5) & 0xFF,
                     (counter & 0x1F) << 3, 0])
        data = np.frombuffer(hdr + body.ljust(f9.FRAME_DATA_LEN, b"\0"),
                             np.uint8)
        fbits = np.unpackbits(f9.rs_frame_encode(data))
        bits += [f9._ASM_PATTERN, fbits,
                 np.zeros(f9.FRAME_BITS - fbits.size, np.uint8)]
    bits.append(rng.integers(0, 2, 2000).astype(np.uint8))
    nrz = 2.0 * np.concatenate(bits) - 1.0
    n = int(len(nrz) * f9.SAMPLERATE / f9.BAUDRATE)
    n = -(-n // FALCON_BLOCK) * FALCON_BLOCK
    k = np.arange(n)
    sym = nrz[np.minimum((k * f9.BAUDRATE / f9.SAMPLERATE).astype(np.int64),
                         len(nrz) - 1)]
    x = np.exp(1j * np.cumsum(2 * np.pi * f9.DEVIATION / f9.SAMPLERATE * sym))
    x = x + FALCON_NOISE * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
    return sent, x.astype(np.complex64)


def phase_falcon9(card: str) -> dict:
    """The Falcon 9 telemetry downlink at its published rates
    (`Falcon9Decoder` defaults) on the card: per block `FalconDemod`
    (`Quadrature`, float M&M: one mm_scan launch) and the sliced bits to
    the host, then the ASM search, the dual-basis RS and the packets on
    the host; the host clock splits each block into the card wait
    (enqueue, M&M, bits' copy) and the RS decode.  Every frame seen, 0
    RS failures, the packets those sent; the port on the CPU over the
    first block gives the same packets, and its plain M&M's inputs are
    held against the kernel, which is timed at that block's shape."""
    from sdrtpu_torch.decoders import falcon9 as f9
    from sdrtpu_torch.kernels import clock

    t0 = time.perf_counter()
    sent, x = falcon_capture(72)
    capture_s = time.perf_counter() - t0
    blocks = x.size // FALCON_BLOCK
    rs_ms = [0.0]
    rs_decode = f9.rs_frame_decode

    def timed_rs(*a):
        t0 = time.perf_counter()
        try:
            return rs_decode(*a)
        finally:
            rs_ms[0] += (time.perf_counter() - t0) * 1e3

    def run(dec, first, last, times=None):
        pk = []
        for b in range(first, last):
            rs_ms[0] = 0.0
            t0 = time.perf_counter()
            bits = dec.bits(x[b * FALCON_BLOCK:(b + 1) * FALCON_BLOCK])
            t1 = time.perf_counter()
            pk += dec.packets(bits)
            t2 = time.perf_counter()
            if times is not None:
                times.append({"ms": (t2 - t0) * 1e3,
                              "card_wait_ms": (t1 - t0) * 1e3,
                              "rs_decode_ms": rs_ms[0],
                              "host_other_ms": (t2 - t1) * 1e3 - rs_ms[0]})
        return pk

    run(f9.Falcon9Decoder(device="cuda"), 0, 1)  # warm-up
    torch.cuda.synchronize()
    counters = kernel_counters()
    dec = f9.Falcon9Decoder(device="cuda")
    f9.rs_frame_decode = timed_rs
    try:
        for fn in counters.values():
            fn.launches = 0
        times = []
        pk = run(dec, 0, blocks, times)
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        f9.rs_frame_decode = rs_decode
    want = expected_launches(mm_scan=blocks)
    if launches != want:
        raise AssertionError(f"falcon9 path launched {launches}, want {want}")
    got = [(p.pkt_id, p.payload) for p in pk]
    if (dec.deframer.frames_seen != FALCON_FRAMES or dec.rs_failures
            or got != sent):
        raise AssertionError(
            f"falcon9: {dec.deframer.frames_seen} frames of {FALCON_FRAMES},"
            f" {dec.rs_failures} RS failures, {len(got)} packets of "
            f"{len(sent)}, equal {got == sent}")
    first = len(run(f9.Falcon9Decoder(device="cuda"), 0, 1))
    with recording("mm_scan") as calls:
        t0 = time.perf_counter()
        pk_cpu = run(f9.Falcon9Decoder(device="cpu"), 0, 1)
        cpu_s = time.perf_counter() - t0
    if [(p.pkt_id, p.payload) for p in pk_cpu] != got[:first]:
        raise AssertionError("falcon9: the CPU's first block differs")
    check = hold_recorded("mm_scan", calls["mm_scan"], "the falcon9 path")
    args = tuple(a.cuda() if torch.is_tensor(a) else a
                 for a in calls["mm_scan"][0][0])
    n_valid = int(calls["mm_scan"][0][1][1].sum())
    with SmClocks() as clocks:
        # 20 launches: a trace of 5 has held none of them (PERF.md §7)
        mm_ms = device_ms(lambda: clock.mm_scan(*args), 20, "mm_scan_kernel")
        mm_event_ms = cuda_ms(lambda: clock.mm_scan(*args), 20)
    path_row = {"shape": list(args[0].shape), "complex": False,
                "symbols": n_valid, "ms": mm_ms, "event_ms": mm_event_ms,
                "ns_per_symbol": mm_ms * 1e6 / n_valid,
                "plain_cpu_ms": cpu_s * 1e3, "sm_clock_mhz": clocks.summary(),
                **roofline(4 * args[0].shape[1] + 5 * args[3] + 4096,
                           46 * n_valid)}
    log(f"mm_scan at the falcon9 block: {path_row}; "
        f"{reckoned(n_valid, MM_CHAIN, MM_CHAIN_PR5)}")
    dec_p = f9.Falcon9Decoder(device="cuda")
    prof, p_wall, busy_us = profiled(lambda: run(dec_p, 0, 2))
    on_path = kernel_ms_per_launch(prof, ("mm_scan_kernel",))
    total_s = sum(t["ms"] for t in times) / 1e3
    signal_s = x.size / f9.SAMPLERATE
    split = ("card_wait_ms", "rs_decode_ms", "host_other_ms")
    return {
        "falcon9": "Falcon 9 downlink (falcon9_decoder/src/main.cpp): 6 Msps,"
                   " 2 MHz deviation, 3.5714 Mbaud, ASM 0x1ACFFC1D, "
                   "RS(255,239) x 5 dual basis; "
                   f"{FALCON_FRAMES} frames, {blocks} blocks of "
                   f"{FALCON_BLOCK}, AWGN {FALCON_NOISE}",
        "frames_sent": FALCON_FRAMES, "frames": dec.deframer.frames_seen,
        "rs_failures": dec.rs_failures, "packets": len(got),
        "packets_equal": True, "kernel_launches": launches,
        "ms_per_block": [t["ms"] for t in times],
        "median_ms_per_block": float(np.median([t["ms"] for t in times])),
        "real_time_factor": signal_s / total_s,
        "split_ms_per_block": {k: float(np.median([t[k] for t in times]))
                               for k in split},
        "rs_ms_per_frame": sum(t["rs_decode_ms"] for t in times)
        / FALCON_FRAMES,
        "device_busy_share": busy_us / 1e3 / (p_wall * 1e3),
        "kernel_ms_on_path": on_path,
        "card_vs_cpu": {"block": 0, "packets_equal": True,
                        "cpu_seconds": cpu_s},
        "kernel_check": check, "mm_scan_at_path_shape": path_row,
        "capture_seconds": capture_s, "card": card,
    }


def phase_kg_sstv(card: str) -> dict:
    """KG-STV at tests/test_kg_sstv.py's 4800 Hz with its two frames, from
    the port's modulators: `KgSstvDecoder` on the card in KG_BLOCKS
    blocks (one mm_scan a block, one viterbi_decode a frame), then on
    the CPU: the payloads those sent and the CPU's; the CPU's plain M&M
    and Viterbi calls launched again as the kernels on the card and
    held."""
    from sdrtpu_torch.decoders import kg_sstv as kg
    from sdrtpu_torch.kernels import mod

    rng = np.random.default_rng(73)
    payloads = [bytes(rng.integers(0, 256, 6, dtype=np.uint8))
                for _ in range(2)]
    pre = (rng.integers(0, 2, 120) * 2.0 - 1.0).astype(np.float32)
    syms = np.concatenate([pre] + [kg.encode_frame(p) for p in payloads]
                          + [pre[:60]])
    interp = mod.RrcInterpolator(int(KG_FS / kg.BAUDRATE), 31, kg.RRC_ALPHA,
                                 dtype=torch.float32, device="cuda")
    fm = mod.QuadratureMod(kg.DEVIATION, KG_FS, device="cuda")
    _, x = fm(fm.init_state(), interp(interp.init_state(),
                                      torch.as_tensor(syms, device="cuda"))[1])
    x = x.cpu().numpy()
    chunks = np.array_split(x, KG_BLOCKS)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    dec = kg.KgSstvDecoder(KG_FS, device="cuda")
    t0 = time.perf_counter()
    got = sum((dec.process(c) for c in chunks), [])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches(mm_scan=KG_BLOCKS, viterbi_decode=len(payloads))
    with recording("mm_scan", "viterbi_decode") as calls:
        cpu = kg.KgSstvDecoder(KG_FS, device="cpu")
        got_cpu = sum((cpu.process(c) for c in chunks), [])
    if launches != want or got != payloads or got_cpu != payloads:
        raise AssertionError(f"kg_sstv: launched {launches} (want {want}),"
                             f" card {got}, CPU {got_cpu}, sent {payloads}")
    checks = {name: hold_recorded(name, calls[name], "the kg_sstv path")
              for name in ("mm_scan", "viterbi_decode")}
    checks["mm_scan"]["at_path_shape"] = at_path_shape(
        "mm_scan", calls["mm_scan"][0][0])
    dec_p = kg.KgSstvDecoder(KG_FS, device="cuda")
    prof, p_wall, busy_us = profiled(
        lambda: [dec_p.process(c) for c in chunks])
    on_path = kernel_ms_per_launch(prof, ("mm_scan_kernel", "viterbi_kernel"))
    return {"kg_sstv": f"KG-STV 1200 baud at {KG_FS:.0f} Hz, two frames, "
                       f"{KG_BLOCKS} blocks",
            "frames": len(got), "payloads_equal": True, "cpu_equal": True,
            "kernel_launches": launches, "kernel_checks": checks,
            "ms_per_block": wall * 1e3 / KG_BLOCKS,
            "real_time_factor": x.size / KG_FS / wall,
            "device_busy_share": busy_us / 1e3 / (p_wall * 1e3),
            "kernel_ms_on_path": on_path,
            "card": card}


def m17_capture(seed: int, preamble: str):
    """examples/m17_voice.py's synthesis at 48 kHz, 4800 baud, 2400 Hz
    deviation, its GFSK (RRC 41 taps, beta 0.5): a 480-dibit preamble,
    an LSF and M17_STREAM_FRAMES stream frames whose LICH chunks carry
    the LSF.  ``preamble``: "example", the example's alternating +3/-3
    (what transmitters send), or "random", seeded random dibits.  The
    voice bits are codec2 frames of the example's tone program when
    libcodec2 is present, else seeded random bits.  Returns (voice bits
    per frame, codec2 bytes or None, complex64 samples padded to whole
    blocks)."""
    from sdrtpu_torch.decoders import codec2, m17
    from sdrtpu_torch.kernels.mod import GfskMod

    rng = np.random.default_rng(seed)
    c2 = None
    if codec2.Codec2.available():
        t = np.arange(M17_STREAM_FRAMES * 320) / 8000.0
        prog = (5000 * np.sin(2 * np.pi * 250 * t)
                * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.int16)
        c2 = codec2.Codec2(codec2.MODE_3200).encode(prog)
        voices = [np.unpackbits(np.frombuffer(c2[i * 16:(i + 1) * 16],
                                              np.uint8))
                  for i in range(M17_STREAM_FRAMES)]
    else:
        voices = [rng.integers(0, 2, 128).astype(np.uint8)
                  for _ in range(M17_STREAM_FRAMES)]
    lsf = m17.lsf_content_bits("N0CALL", "SP5WWP")
    frames = [m17.encode_lsf_frame("N0CALL", "SP5WWP")] + [
        m17.encode_stream_frame(fn, voices[fn], lich_chunk=lsf[
            (fn % 6) * 40:(fn % 6 + 1) * 40], chunk_idx=fn % 6)
        for fn in range(M17_STREAM_FRAMES)]
    pre = (np.tile(np.array([0, 1, 1, 1], np.uint8), 240)
           if preamble == "example"
           else rng.integers(0, 2, 960).astype(np.uint8))
    bits = np.concatenate([pre] + frames + [np.zeros(96, np.uint8)])
    table = {(0, 1): 1.0, (0, 0): 1 / 3, (1, 0): -1 / 3, (1, 1): -1.0}
    syms = np.array([table[(int(a), int(b))] for a, b in bits.reshape(-1, 2)],
                    np.float32)
    sps = int(M17_FS / M17_BAUD)
    gm = GfskMod(sps, M17_DEV, M17_FS, rrc_tap_count=4 * sps + 1,
                 rrc_beta=0.5, device="cuda")
    x = gm(gm.init_state(), torch.as_tensor(syms, device="cuda"))[1]
    x = x.cpu().numpy()
    pad = -x.size % M17_BLOCK
    return voices, c2, np.concatenate([x, np.zeros(pad, np.complex64)])


def m17_receive(x, device):
    """examples/m17_voice.py's receive chain, block by block: `Gfsk`
    (omega gain 1e-4, mu gain 0.08), the 4FSK slicer and `M17BitSync`."""
    from sdrtpu_torch.decoders import m17
    from sdrtpu_torch.kernels.psk import Gfsk

    sps = int(M17_FS / M17_BAUD)
    dem = Gfsk(M17_BAUD, M17_FS, M17_DEV, rrc_tap_count=4 * sps + 1,
               rrc_beta=0.5, omega_gain=1e-4, mu_gain=0.08, device=device)
    sync = m17.M17BitSync(device=device)
    st, out = dem.init_state(), []
    with torch.inference_mode():
        for b in range(x.size // M17_BLOCK):
            st, (s, v) = dem(st, torch.as_tensor(
                x[b * M17_BLOCK:(b + 1) * M17_BLOCK], device=device))
            out += sync.process(m17.slice_4fsk(s[v].cpu().numpy()))
    return out, sync


def phase_m17(card: str) -> dict:
    """M17 voice at 48 kHz: `Gfsk` on the card (one mm_scan a block), the
    frame layer on the host with its K=5 rate-1/2 Viterbi on the card
    (one viterbi_decode a frame decoded).  Two transmissions:

    - "example", examples/m17_voice.py's own (the alternating preamble):
      the M&M's timing error is zero on an alternating pattern, so it
      acquires only from the LSF on, and the LSF and stream frame 0 are
      lost, in the reference too (ROADMAP Queue 3).  What the example
      holds: every later stream frame's number and voice bits, and the
      LSF's callsigns from the LICH chunks; with libcodec2, the voice
      decoded to 8 kHz audio;
    - "random", a random-dibit preamble: the LSF itself and all stream
      frames, and the LSF again from the LICH chunks.

    Each equal to what was sent and to the port on the CPU, whose plain
    M&M and Viterbi calls are launched again as the kernels on the card
    and held."""
    from sdrtpu_torch.decoders import m17

    def flat(rs):
        return [(t, p if t == "lsf" else (p[0], p[1].tolist()))
                for t, p in rs]

    def run(preamble):
        voices, c2, x = m17_capture(74, preamble)
        blocks = x.size // M17_BLOCK
        has_lsf = preamble == "random"
        lost = 0 if has_lsf else M17_EXAMPLE_LOST  # stream frames lost
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res, sync = m17_receive(x, "cuda")
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        want = expected_launches(mm_scan=blocks,
                                 viterbi_decode=has_lsf + M17_STREAM_FRAMES
                                 - lost)
        with recording("mm_scan", "viterbi_decode") as calls:
            res_cpu, sync_cpu = m17_receive(x, "cpu")
        lsf = res[0][1] if res and res[0][0] == "lsf" else None
        lich = sync.decoder.lsf_from_lich()
        frames = [(t, (p[0], p[1].tolist())) for t, p in res
                  if t == "stream"]
        ok = (launches == want and flat(res) == flat(res_cpu)
              and lich == sync_cpu.decoder.lsf_from_lich()
              and lich is not None and lich["crc_ok"]
              and (lich["dst"], lich["src"]) == ("N0CALL", "SP5WWP")
              and [t for t, _ in res] == ["lsf"] * has_lsf
              + ["stream"] * len(frames)
              and (lsf is None or lsf == lich)
              and frames == [("stream", (fn, voices[fn].tolist()))
                             for fn in range(lost, M17_STREAM_FRAMES)])
        if not ok:
            raise AssertionError(
                f"m17 ({preamble} preamble): launched {launches} (want "
                f"{want}), {[(t, p if t == 'lsf' else p[0]) for t, p in res]},"
                f" LICH {lich}, CPU equal {flat(res) == flat(res_cpu)}")
        checks = {name: hold_recorded(name, calls[name],
                                      f"the m17 path ({preamble})")
                  for name in ("mm_scan", "viterbi_decode")}
        checks["mm_scan"]["at_path_shape"] = at_path_shape(
            "mm_scan", calls["mm_scan"][0][0])
        audio = None
        if c2 is not None and preamble == "example":
            pcm = m17.M17Vocoder().vocode([p for t, p in res
                                           if t == "stream"])
            if pcm.size != len(frames) * 320:
                raise AssertionError(f"m17: {pcm.size} audio samples")
            audio = {"samples": int(pcm.size),
                     "rms": float(np.sqrt(np.mean(pcm ** 2)))}
        return x, blocks, {
            "lsf_frame": {k: lsf[k] for k in ("dst", "src", "crc_ok")}
            if lsf else "lost",
            "lsf_from_lich": {k: lich[k] for k in ("dst", "src", "crc_ok")},
            "stream_frames": [frames[0][1][0], frames[-1][1][0]],
            "voice_bits_equal": True, "cpu_equal": True,
            "vocoder": audio or ("libcodec2 absent: not run"
                                 if c2 is None else "not run"),
            "kernel_launches": launches, "kernel_checks": checks,
            "ms_per_block": wall * 1e3 / blocks,
            "real_time_factor": x.size / M17_FS / wall}

    x, blocks, example = run("example")
    _, _, random_pre = run("random")
    prof, p_wall, busy_us = profiled(lambda: m17_receive(x, "cuda"))
    on_path = kernel_ms_per_launch(prof, ("mm_scan_kernel", "viterbi_kernel"))
    return {"m17": "M17 at 48 kHz, 4800 baud, 2400 Hz deviation "
                   "(examples/m17_voice.py): LSF + "
                   f"{M17_STREAM_FRAMES} stream frames, {blocks} blocks "
                   f"of {M17_BLOCK}; the example's preamble, then a "
                   "random one",
            **example, "random_preamble": random_pre,
            "device_busy_share": busy_us / 1e3 / (p_wall * 1e3),
            "kernel_ms_on_path": on_path,
            "card": card}


def phase_ryfi(card: str) -> dict:
    """The RyFi link of examples/ryfi_link.py at its defaults (20 kbaud,
    4 samples a symbol, Es/N0 8 dB, 100 Hz offset, 0.7 rad): an idle
    frame, three sends (the example's three packets, one of 1 500 bytes
    spanning two frames), an idle frame, then one block of noise; the
    port's transmitter; `RyfiReceiver` on the card in blocks of 16 384
    (`Psk`: one costas_scan and one mm_scan a block; one viterbi_decode
    a deframed frame, counted at the codec).  Every frame sent is
    deframed; the packets are those sent; every frame after the first
    decodes (the loops lock during the first idle frame, which may fail
    its RS decode).  Then the receiver on the CPU over the first
    RYFI_CPU_BLOCKS blocks (the first idle frame and the first data
    frame): the same packets and frame counts as the card's over those
    blocks, and its plain Costas, M&M and Viterbi calls launched again
    as the kernels on the card and held."""
    from sdrtpu_torch.decoders import ryfi

    rng = np.random.default_rng(75)
    fs = RYFI_BAUD * RYFI_SPS
    payloads = [b"hello over the air",
                bytes(rng.integers(0, 256, 1500).astype(np.uint8)),
                b"last packet"]
    tx = ryfi.RyfiTransmitter(RYFI_BAUD, fs, device="cuda")
    parts = [tx.idle()] + [tx.send([p]) for p in payloads] + [tx.idle()]
    n_frames = sum(p.size for p in parts) // (ryfi.TOTAL_FRAME_SYMS
                                              * RYFI_SPS)
    bb = np.concatenate(parts)
    es = np.mean(np.abs(bb) ** 2) * RYFI_SPS
    sigma = np.sqrt(es / 10 ** (RYFI_ESN0_DB / 10) / 2)
    bb = np.concatenate([bb, np.zeros(RYFI_BLOCK, np.complex64)])
    t = np.arange(bb.size) / fs
    y = (bb * np.exp(1j * (RYFI_PHASE + 2 * np.pi * RYFI_OFFSET_HZ * t))
         + sigma * (rng.standard_normal(bb.size)
                    + 1j * rng.standard_normal(bb.size))).astype(np.complex64)
    blocks = y.size // RYFI_BLOCK

    def counted(rx):
        """Count the frames the deframer hands the codec."""
        deframed = [0]
        decode_soft = rx.codec.decode_soft

        def count(soft):
            deframed[0] += 1
            return decode_soft(soft)

        rx.codec.decode_soft = count
        return deframed

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    rx = ryfi.RyfiReceiver(RYFI_BAUD, fs, device="cuda")
    deframed = counted(rx)
    t0 = time.perf_counter()
    got, per_block = [], []
    for b in range(blocks):
        got.append(rx.process(y[b * RYFI_BLOCK:(b + 1) * RYFI_BLOCK]))
        per_block.append((rx.frames_decoded, rx.frames_failed))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches(costas_scan=blocks, mm_scan=blocks,
                             viterbi_decode=n_frames)
    if (launches != want or sum(got, []) != payloads
            or deframed[0] != n_frames
            or rx.frames_decoded + rx.frames_failed != n_frames
            or rx.frames_decoded < n_frames - 1):
        raise AssertionError(
            f"ryfi: launched {launches} (want {want}), {deframed[0]} frames"
            f" deframed, {rx.frames_decoded} decoded, {rx.frames_failed} "
            f"failed of {n_frames}, packets equal {sum(got, []) == payloads}")
    with recording("costas_scan", "mm_scan", "viterbi_decode") as calls:
        cpu = ryfi.RyfiReceiver(RYFI_BAUD, fs, device="cpu")
        t0 = time.perf_counter()
        got_cpu = sum((cpu.process(y[b * RYFI_BLOCK:(b + 1) * RYFI_BLOCK])
                       for b in range(RYFI_CPU_BLOCKS)), [])
        cpu_s = time.perf_counter() - t0
    card_first = sum(got[:RYFI_CPU_BLOCKS], [])
    if (got_cpu != card_first or not got_cpu
            or (cpu.frames_decoded, cpu.frames_failed)
            != per_block[RYFI_CPU_BLOCKS - 1]):
        raise AssertionError(
            f"ryfi: over the first {RYFI_CPU_BLOCKS} blocks the CPU gave "
            f"{len(got_cpu)} packets and (decoded, failed) "
            f"{(cpu.frames_decoded, cpu.frames_failed)}, the card "
            f"{len(card_first)} and {per_block[RYFI_CPU_BLOCKS - 1]}")
    checks = {name: hold_recorded(name, calls[name], "the ryfi path")
              for name in ("costas_scan", "mm_scan", "viterbi_decode")}
    checks["mm_scan"]["at_path_shape"] = at_path_shape(
        "mm_scan", calls["mm_scan"][0][0])
    rx_p = ryfi.RyfiReceiver(RYFI_BAUD, fs, device="cuda")
    prof, p_wall, busy_us = profiled(
        lambda: [rx_p.process(y[b * RYFI_BLOCK:(b + 1) * RYFI_BLOCK])
                 for b in range(4)])
    on_path = kernel_ms_per_launch(
        prof, ("costas_scan_kernel", "mm_scan_kernel", "viterbi_kernel"))
    return {"ryfi": "RyFi QPSK (examples/ryfi_link.py defaults): "
                    f"{RYFI_BAUD:.0f} baud, sps {RYFI_SPS}, Es/N0 "
                    f"{RYFI_ESN0_DB} dB, {RYFI_OFFSET_HZ} Hz, {RYFI_PHASE} "
                    f"rad; {n_frames} frames, {blocks} blocks of "
                    f"{RYFI_BLOCK}",
            "frames_sent": n_frames, "frames_deframed": deframed[0],
            "frames_decoded": rx.frames_decoded,
            "frames_failed": rx.frames_failed,
            "rs_errors": rx.rs_errors, "packets_equal": True,
            "kernel_launches": launches, "kernel_checks": checks,
            "card_vs_cpu": {"blocks": RYFI_CPU_BLOCKS,
                            "packets_equal": True,
                            "frame_counts_equal": True,
                            "cpu_seconds": cpu_s},
            "ms_per_block": wall * 1e3 / blocks,
            "real_time_factor": y.size / fs / wall,
            "device_busy_share": busy_us / 1e3 / (p_wall * 1e3),
            "kernel_ms_on_path": on_path,
            "card": card}


# The paging, VOR, ATV, live, rtl_tcp and scanner paths.
PAGING_FS, PAGING_BAUD, PAGING_DEV = 24000.0, 1200.0, 4500.0
PAGING_BLOCK = 4800        # 200 ms
PAGES = [  # (address, text, numeric, frame): distinct addresses and frames
    (0x1F4, "RF OK", False, 1), (0x2A5F8, "0123456789", True, 3),
    (0x12345, "HELLO PAGER", False, 2), (0x0BEEF, "*U-][ 42", True, 5),
    (0x54321, "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789 END",
     False, 6), (0x3FFF8, "911", True, 7), (0x00208, "TEST42", False, 0),
    (0x1C0DE, "5551234567", True, 4), (0x2BEE0, "SDR PAGE 9 OF 10", False, 1),
    (0x3A5A0, "10-4", True, 2)]
VOR_FS = 25000.0
VOR_BEARINGS = (0.0, 45.0, 137.5, 270.0, 359.0)  # tests/test_vor.py:10
VOR_BLOCKS = 4             # of 1 s
ATV_FRAMES = 4             # one PAL frame (625 lines x 945 samples) a block
ATV_FS = 625 * 945 * 25.0  # 14.765 625 Msps
ATV_LINES_ATOL = 1e-4      # card vs CPU, as tests/test_torch_atv.py
# the active region vs the image sent: the gather interpolates at the
# estimated sub-sample phase (within ~0.02 sample of the true one), so a
# pixel step of up to 0.9 moves by up to ~0.02
ATV_ACTIVE_ATOL = 0.05
LIVE_SECONDS = 8.0         # 80 M samples, 320 MB of i16 on the wire
LIVE_PROFILED_SECONDS = 4.0  # the profiled paced session (busy share)
LIVE_CHUNK_S = 0.02        # the sender's 20 ms chunks
RTL_FS = 2_400_000.0       # an RTL-SDR's usual rate
RTL_SECONDS = 5.0
RTL_OFFSET = 300_000.0


def phase_paging(card: str) -> dict:
    """POCSAG over tests/test_pocsag.py:63-87's RF chain, from the port's
    transmitter on the card: ten pages (alpha and numeric, distinct
    addresses and frames) -> `GfskMod` -> `Gfsk` (float mm_scan, one
    launch a block of PAGING_BLOCK) -> `PocsagDecoder` (host), every page
    the one sent; the port on the CPU decodes the same pages and its
    plain mm_scan calls are launched again as the kernel and held.  FLEX
    and HRPT are host layers: their frames from `build_flex_frame` /
    `build_frame`, handed over as tensors on the card, come back."""
    from sdrtpu_torch.decoders import flex, hrpt, pocsag
    from sdrtpu_torch.kernels import mod, psk

    sps = int(PAGING_FS / PAGING_BAUD)
    bits = np.concatenate([pocsag.build_transmission(
        a, t, pocsag.MESSAGE_NUMERIC if num else pocsag.MESSAGE_ALPHA, f)
        for a, t, num, f in PAGES] + [np.zeros(32, np.uint8)])
    sym = 1.0 - 2.0 * bits.astype(np.float32)  # 0 -> +dev, 1 -> -dev
    kw = dict(rrc_tap_count=2 * sps + 1, rrc_beta=0.9)
    tx = mod.GfskMod(sps, PAGING_DEV, PAGING_FS, device="cuda", **kw)
    x = tx(tx.init_state(), torch.as_tensor(sym, device="cuda"))[1].cpu()
    blocks = list(torch.split(x, PAGING_BLOCK))

    def receive(device, timed=False):
        rx = psk.Gfsk(PAGING_BAUD, PAGING_FS, PAGING_DEV, omega_gain=1e-4,
                      mu_gain=0.05, device=device, **kw)
        dec = pocsag.PocsagDecoder()
        st = rx.init_state()
        t0 = time.perf_counter()
        for b in blocks:
            st, (syms, valid) = rx(st, b.to(device))
            dec.process(syms[valid] < 0)  # to the host here
        dec.flush()
        return dec.messages, time.perf_counter() - t0

    counters = kernel_counters()
    receive("cuda")  # warm-up
    for fn in counters.values():
        fn.launches = 0
    msgs, wall = receive("cuda")
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches(mm_scan=len(blocks))
    sent = [((a & ~7) | f, t) for a, t, _, f in PAGES]
    got = [(a, t) for a, _, t in msgs]
    # a numeric page's last codeword is padded with "0" digits
    ok = (len(got) == len(sent) and all(
        ga == sa and gt.startswith(st) and (num or gt == st)
        for (ga, gt), (sa, st), (_, _, num, _) in zip(got, sent, PAGES)))
    if launches != want or not ok:
        raise AssertionError(f"paging: launched {launches} (want {want}); "
                             f"decoded {got}, sent {sent}")
    with recording("mm_scan") as calls:
        msgs_cpu, cpu_s = receive("cpu")
    if msgs_cpu != msgs:
        raise AssertionError(f"paging: CPU decoded {msgs_cpu}, card {msgs}")
    check = hold_recorded("mm_scan", calls["mm_scan"], "the paging path")
    check["at_path_shape"] = at_path_shape("mm_scan", calls["mm_scan"][0][0])
    prof, p_wall, busy_us = profiled(lambda: receive("cuda"))

    flex_msgs = [(0x12345, "HELLO FLEX"), (0x0BEEF, "SDR ON THE CARD")]
    fdec = flex.FlexDecoder()
    fbits = torch.as_tensor(flex.build_flex_frame(2, 77, flex_msgs),
                            device="cuda")
    fgot = [(m.address, m.text) for m in fdec.process(fbits)]
    img = np.random.default_rng(31).integers(0, 1024, (5, 2048)).astype(
        np.uint16)
    frame = hrpt.build_frame(img)
    hframes = hrpt.HrptDeframer().process(
        torch.as_tensor(hrpt.unpack_words(frame), device="cuda"))
    if fgot != flex_msgs or len(hframes) != 1 or not np.array_equal(
            hrpt.avhrr_lines(hframes[0]), img):
        raise AssertionError(f"paging: FLEX {fgot}, HRPT {len(hframes)} "
                             "frames from tensors on the card")
    seconds = x.numel() / PAGING_FS
    return {"paging": f"POCSAG {PAGING_BAUD:.0f} baud at {PAGING_FS:.0f} "
                      f"sps, {PAGING_DEV:.0f} Hz deviation, {len(PAGES)} "
                      f"pages, {len(blocks)} blocks of {PAGING_BLOCK}",
            "pages": len(got), "pages_equal": True, "cpu_equal": True,
            "kernel_launches": launches, "kernel_check": check,
            "flex_frames_equal": True, "hrpt_frames_equal": True,
            "ms_per_block": wall * 1e3 / len(blocks),
            "real_time_factor": seconds / wall,
            "device_busy_share": busy_us / 1e3 / (p_wall * 1e3),
            "cpu_seconds": cpu_s, "card": card}


def angle_deg(a: float, b: float) -> float:
    """The angle between two bearings, in degrees."""
    d = abs(a - b) % 360.0
    return min(d, 360.0 - d)


def phase_vor(card: str) -> dict:
    """VOR bearings (tests/test_vor.py:10's five) at 25 kHz, VOR_BLOCKS
    blocks of 1 s each, `VorReceiver` on the card and on the CPU: every
    bearing within 2 degrees of the one sent, the card's within 0.01
    degree of the CPU's; no hand kernel."""
    from sdrtpu_torch.decoders import vor

    n = int(VOR_FS)
    counters = kernel_counters()
    rows, walls = [], []
    for bearing in VOR_BEARINGS:
        x = vor.synthesize_vor(bearing, VOR_FS, seconds=VOR_BLOCKS)
        rc = vor.VorReceiver(VOR_FS, device="cuda")
        rh = vor.VorReceiver(VOR_FS, device="cpu")
        sc, sh = rc.init_state(), rh.init_state()
        rc(sc, torch.as_tensor(x[:n], device="cuda"))  # warm-up
        for fn in counters.values():
            fn.launches = 0
        got = []
        for b in range(VOR_BLOCKS):
            blk = x[b * n:(b + 1) * n]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc, (dc, ac) = rc(sc, torch.as_tensor(blk, device="cuda"))
            dc = float(dc)
            walls.append(time.perf_counter() - t0)
            sh, (dh, _) = rh(sh, torch.as_tensor(blk))
            got.append({"card_deg": dc, "cpu_deg": float(dh),
                        "error_deg": angle_deg(dc, bearing),
                        "card_vs_cpu_deg": angle_deg(dc, float(dh)),
                        "amplitude": float(ac)})
        launches = {name: fn.launches for name, fn in counters.items()}
        if launches != expected_launches() or any(
                g["error_deg"] >= 2.0 or g["card_vs_cpu_deg"] >= 0.01
                for g in got):
            raise AssertionError(f"vor: bearing {bearing}: {got}, "
                                 f"launched {launches}")
        rows.append({"sent_deg": bearing, "blocks": got})
    ms = float(np.median(walls)) * 1e3
    return {"vor": f"VOR at {VOR_FS:.0f} Hz, {len(VOR_BEARINGS)} bearings x "
                   f"{VOR_BLOCKS} blocks of 1 s",
            "bearings": rows,
            "max_error_deg": max(g["error_deg"] for r in rows
                                 for g in r["blocks"]),
            "max_card_vs_cpu_deg": max(g["card_vs_cpu_deg"] for r in rows
                                       for g in r["blocks"]),
            "kernel_launches": expected_launches(),
            "ms_per_block": ms, "real_time_factor": 1e3 / ms, "card": card}


def atv_cadence() -> np.ndarray:
    """tests/test_atv.py::test_interlaced_field_assembly's 625-line PAL
    cadence: an even field, an odd field, the next even field."""
    from sdrtpu_torch.decoders import atv

    def line(kind, value=0.5):
        row = np.zeros(atv.LINE_SIZE, np.float32)
        if kind == "video":
            row[:atv.SYNC_LEN] = atv.SYNC_LEVEL
            row[atv.ACTIVE_START:] = value
        elif kind == "short":
            row[:35] = atv.SYNC_LEVEL
        elif kind == "long":
            row[:atv.LINE_SIZE - 25] = atv.SYNC_LEVEL
        return row

    even_seq, odd_seq = [0, 1, 1, 2, 2, 2, 1, 1], [1, 1, 1, 2, 2, 1, 1, 1]
    kind = {0: "video", 1: "short", 2: "long"}
    lines = [line("video", 0.1)] * 4
    lines += [line(kind[c]) for c in even_seq]
    lines += [line("video", 0.25)] * 305
    lines += [line(kind[c]) for c in odd_seq]
    lines += [line("video", 0.75)] * 304
    lines += [line(kind[c]) for c in even_seq]
    return np.stack(lines)


def phase_atv(card: str) -> dict:
    """ATV at full PAL width: `synthesize_atv` of a seeded image, 625
    lines of 945 samples a frame (14.77 Msps), ATV_FRAMES frames, one
    frame a block through `AtvVideoDemod` + `AtvLineSync` on the card and
    on the CPU: lines within ATV_LINES_ATOL, the active region the image
    sent; the frame assembler fed the reference test's 625-line cadence
    (a tensor on the card) returns its frame; no hand kernel."""
    from sdrtpu_torch.decoders import atv

    L, rows = atv.LINE_SIZE, 625
    rng = np.random.default_rng(14)
    img = rng.uniform(0.1, 0.9, (ATV_FRAMES * rows, 256))
    img[:, :24] = 1.0  # a white bar: the 99th percentile is white
    x = atv.synthesize_atv(img)
    n = rows * L
    active = atv.SYNC_LEN + 30
    want = np.stack([np.interp(np.linspace(0, img.shape[1] - 1, L - active),
                               np.arange(img.shape[1]), r) for r in img])
    counters = kernel_counters()
    demod = atv.AtvVideoDemod()
    sync_c = atv.AtvLineSync(device="cuda")
    sync_h = atv.AtvLineSync(device="cpu")
    sync_c(sync_c.init_state(), demod((), torch.as_tensor(
        x[:n], device="cuda"))[1])  # warm-up
    for fn in counters.values():
        fn.launches = 0
    sc, sh = sync_c.init_state(), sync_h.init_state()
    lines_err = act_err = 0.0
    card_ms, frame_ms, phases = [], [], []
    asm = atv.AtvFrameAssembler()
    for f in range(ATV_FRAMES):
        blk = x[f * n:(f + 1) * n]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, video = demod((), torch.as_tensor(blk, device="cuda"))
        sc, lines_c = sync_c(sc, video)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        asm.process(lines_c)  # the host's share: fetch, classify, place
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        card_ms.append((t1 - t0) * 1e3)
        phases.append(float(atv.line_phase(video)))
        _, video_h = demod((), torch.as_tensor(blk))
        sh, lines_h = sync_h(sh, video_h)
        lc = lines_c.cpu().numpy()
        lines_err = max(lines_err, float(np.abs(lc - lines_h.numpy()).max()))
        # the carried tail delays the lines by one: line r of the output
        # is line r - 1 of the block (line 0, the last of the one before)
        act_err = max(act_err, float(np.abs(
            lc[1:, active:] - want[f * rows:(f + 1) * rows - 1]).max()))
    launches = {name: fn.launches for name, fn in counters.items()}
    frames = atv.AtvFrameAssembler().process(
        torch.as_tensor(atv_cadence(), device="cuda"))
    ok = (len(frames) >= 1 and abs(frames[-1][0:500:2].mean() - 0.25) < 0.02
          and abs(frames[-1][1:500:2].mean() - 0.75) < 0.02)
    if (launches != expected_launches() or lines_err > ATV_LINES_ATOL
            or act_err > ATV_ACTIVE_ATOL or not ok):
        raise AssertionError(
            f"atv: lines vs CPU {lines_err}, active region vs image "
            f"{act_err}, assembler frames {len(frames)}, launched "
            f"{launches}")
    ms = float(np.median(frame_ms))
    return {"atv": f"PAL {rows} lines x {L} samples ({ATV_FS / 1e6:.3f} "
                   f"Msps), {ATV_FRAMES} frames, one a block",
            "lines_vs_cpu_max_abs_err": lines_err,
            "lines_tol": ATV_LINES_ATOL,
            "active_vs_image_max_abs_err": act_err,
            "active_tol": ATV_ACTIVE_ATOL,
            "line_phase": phases, "assembler_frames": len(frames),
            "kernel_launches": launches,
            "card_ms_per_frame": float(np.median(card_ms)),
            "ms_per_frame": ms, "real_time_factor": 40.0 / ms, "card": card}


def logged_paced_backend():
    """A `PacedNullBackend` that also notes the stream position (s of
    audio) of each underrun."""
    from sdrtpu_torch.io.audio_sink import PacedNullBackend

    class Logged(PacedNullBackend):
        def __init__(self):
            super().__init__(48000.0)
            self.underrun_at: list[float] = []

        def write(self, packet):
            before = self.underruns
            super().write(packet)
            if self.underruns != before:
                self.underrun_at.append(self.frames_written / self.samplerate)

    return Logged()


def live_checks(where, run, sender, launches, want, sinks,
                pump=None) -> dict:
    """The live path's common checks; returns what they measured.
    ``pump``: the `NetworkSource` that must have read through the native
    pump and dropped nothing (None for rtl_tcp, whose reader is Python)."""
    underrun_at = {n: s.sink.backend.underrun_at for n, s in sinks.items()}
    late = {n: [t for t in v if t > 1.0] for n, v in underrun_at.items()}
    problems = []
    if run["pushed"] != sender.total_samples:
        problems.append(f"pushed {run['pushed']} of "
                        f"{sender.total_samples} sent")
    if pump is not None and pump.readers != ["native"]:
        problems.append(f"readers {pump.readers}")
    if pump is not None and pump.dropped_bytes:
        problems.append(f"dropped {pump.dropped_bytes} bytes")
    if any(late.values()):
        problems.append(f"underruns after the first second {late}")
    if launches != want:
        problems.append(f"launched {launches}, want {want}")
    if problems:
        raise AssertionError(f"{where}: " + "; ".join(problems))
    return {"underruns_at_s": underrun_at}


def phase_live(card: str, receiver_msps: float) -> dict:
    """The live edge on the card: a transmitter process's
    `IqExporter("tcp-client")` over loopback into `NetworkSource("tcp")`
    (i16, the native pump), the receiver
    path's VFO set (`build_receiver`, 2 000 000-sample blocks), each VFO
    into an `AudioSink` on the paced headless backend, played out on its
    own thread; LIVE_SECONDS of the receiver capture's i16 bytes (one
    block's, computed once and replayed) sent in 20 ms chunks paced to
    real time.  Then the same bytes unpaced, a short paced session under
    the profiler for the card's busy share (the latency and the
    real-time factor come from the unprofiled one), and the rtl_tcp
    case."""
    from sdrtpu_torch.apps import live_radio as live
    from sdrtpu_torch.io.audio_sink import AudioSink
    from sdrtpu_torch.io.net import NetworkSource, iq_to_bytes
    from torch.profiler import ProfilerActivity, profile

    x = receiver_capture(11, RX_BLOCK)  # 200 ms; replays without a seam
    wire = iq_to_bytes(x, "i16")
    chunk = int(RX_FS * LIVE_CHUNK_S)

    t_phase = time.perf_counter()

    def mark(what):
        log(f"live: {what} at {time.perf_counter() - t_phase:.1f} s")

    def session(seconds: float, paced: bool, profiled: bool = False):
        n_chunks = int(round(seconds / LIVE_CHUNK_S))
        blocks = n_chunks * chunk // RX_BLOCK
        src = NetworkSource("tcp", "127.0.0.1", 0)
        first, last, received = {}, {}, []
        sinks = {}
        if paced:
            # jitter buffer: half a block of audio (the receiver hands
            # its sinks one 200 ms block at a time)
            lat = int(np.ceil(0.5 * RX_BLOCK / RX_FS * 48000 / 512))
            sinks = {n: live.PlayoutSink(AudioSink(
                48000.0, backend=logged_paced_backend(), latency_packets=lat))
                for n in RX_VFOS}

        def tap(name):
            def sink(a):
                first.setdefault(name, [])
                if len(first[name]) < RX_CPU_BLOCKS:
                    first[name].append(a)
                last[name] = a
                if paced:
                    sinks[name](a)
            return sink

        def keep(b):
            if len(received) < RX_CPU_BLOCKS:
                received.append(np.array(b))

        rx, _, _ = build_receiver(
            "cuda", audio_sinks={n: tap(n) for n in RX_VFOS},
            baseband_sinks=[keep])
        rx.warmup()
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        # unpaced: as fast as the receiver takes it, at most two blocks
        # ahead (the pump drops what its ring cannot hold, as a live
        # source must, so an unbounded sender would measure drops)
        sender = live.Transmitter(wire, chunk, n_chunks, RX_FS,
                                  connect=("127.0.0.1", src.port),
                                  window=None if paced else 2 * RX_BLOCK)
        seen = {"lag": None}

        def on_push(pushed):
            sender.consumed.value = pushed
            if sender.done.is_set() and seen["lag"] is None:
                seen["lag"] = sender.total_samples - pushed

        # the interpreter's collector pauses over the run: generation,
        # ms, start on the host's monotonic clock
        pauses = []

        def gc_pause(phase, info):
            if phase == "start":
                seen["gc_t0"] = time.monotonic()
            else:
                pauses.append((info["generation"],
                               (time.monotonic() - seen["gc_t0"]) * 1e3,
                               seen["gc_t0"]))

        gc.callbacks.append(gc_pause)
        # a profiled run is traced from before the first send to after
        # the last block (the profiler's start and stop stall the
        # interpreter for long enough to overflow the pump's ring)
        prof = None
        if profiled:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        run_t0 = time.monotonic()
        sender.start()
        run = live.stream(src, rx, sender.total_samples,
                          timeout_s=3 * seconds + 60, on_push=on_push)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        gc.callbacks.remove(gc_pause)
        # the sinks play their last block out before the profiler stops
        # (its stop holds the interpreter while it gathers the trace) and
        # before the transmitter's exit is awaited: their close writes
        # the last part packet, which is late if the close is
        for s in sinks.values():
            s.close()
        sender.join(30.0)
        busy_us = None
        if profiled:
            prof.stop()
            busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
        src.close()
        if seen["lag"] is None:
            seen["lag"] = sender.total_samples - run["pushed"]
        # pauses over 20 ms, each with its start in s after the first
        # sample: only one between the first push and the sinks' last
        # packet can delay a packet
        long = [(g, ms, t - run["t_first"]) for g, ms, t in pauses if ms > 20]
        seen["collector_pauses"] = {
            "count": len(pauses),
            "max_ms": max((ms for _, ms, _ in pauses), default=0.0),
            "over_20_ms_gen_ms_at_s": long}
        kind = ("profiled " if profiled else "") + ("paced" if paced
                                                    else "unpaced")
        mark(f"{kind} session ({blocks} blocks), first sample "
             f"{run['t_first'] - run_t0:.1f} s after the transmitter's start,"
             f" collector {seen['collector_pauses']}")
        want = expected_launches(chunk_poly=2 * blocks, agc_scan=3 * blocks)
        checks = live_checks(f"live {kind}", run, sender, launches, want,
                             sinks, pump=src)
        # paced, the receive backlog when the last chunk is sent is at
        # most a block (unpaced, the sender runs up to two ahead)
        if paced and seen["lag"] > RX_BLOCK:
            raise AssertionError(
                f"live {kind}: {seen['lag']} samples behind when the sender "
                "finished (more than one block)")
        elapsed = run["t_end"] - run["t_first"]
        rec = {"blocks": blocks, "samples_sent": sender.total_samples,
               "samples_received": run["pushed"], "reader": src.readers,
               "dropped_bytes": src.dropped_bytes,
               "behind_at_last_send_samples": seen["lag"],
               "kernel_launches": launches,
               "collector_pauses": seen["collector_pauses"]}
        if paced:
            lat = live.latencies(sender, sinks["w0"].arrivals, RX_BLOCK)
            rec.update({
                "real_time_factor": run["pushed"] / RX_FS / elapsed,
                "push_busy_share": run["push_s"] / elapsed,
                "latency_ms_median": float(np.median(lat)) * 1e3,
                "latency_ms_p95": float(np.percentile(lat, 95)) * 1e3,
                "audio_latency_packets":
                    sinks["w0"].sink.backend.latency * 48000 / 512,
                "underruns": {n: s.sink.backend.underruns
                              for n, s in sinks.items()},
                **checks})
        else:
            rec["msps"] = (run["pushed"] / (run["t_end"] - sender.log[0][1])
                           / 1e6)
        if profiled:
            rec["device_busy_share"] = busy_us / 1e6 / elapsed
            rec["device_busy_ms_per_block"] = busy_us / 1e3 / blocks
        assert rx.block_len == RX_BLOCK, rx.block_len
        return rec, first, last, received

    paced_rec, first, last, received = session(LIVE_SECONDS, paced=True)
    tones = rx_tone_checks("live", last, retuned=False)
    # the port on the CPU over the first received blocks
    cpu_rx, cpu_audio, _ = build_receiver("cpu", spectrum=False)
    with recording("agc_scan") as calls:
        for b in received:
            cpu_rx.push(b)
        cpu_rx.flush()
    errs = rx_audio_vs_cpu("live", first, cpu_audio)
    agc_check = hold_recorded("agc_scan", calls["agc_scan"],
                              "the live path")
    del cpu_rx, cpu_audio, first, last, received
    mark("card vs CPU")

    # the same bytes unpaced: socket -> pump -> conversion -> receiver
    unpaced, *_ = session(LIVE_SECONDS, paced=False)
    unpaced["receiver_phase_push_only_msps"] = receiver_msps
    # the card's busy share, from a short paced session under the profiler
    profiled, *_ = session(LIVE_PROFILED_SECONDS, paced=True, profiled=True)
    # the command line's own selftest (1 Msps, one WFM VFO, 3 s), its
    # record to the log
    with contextlib.redirect_stdout(sys.stderr):
        rc = live.main(["--selftest", "3", "--device", "cuda"])
    if rc != 0:
        raise AssertionError("python -m sdrtpu_torch.apps.live_radio "
                             "--selftest 3 failed")
    mark("live_radio --selftest 3")
    return {"live": f"network IQ (i16, loopback TCP, native pump) -> receiver "
                    f"({RX_FS / 1e6:.0f} Msps, 8 VFOs, {RX_BLOCK}-sample "
                    f"blocks) -> 8 paced audio sinks, {LIVE_SECONDS:.0f} s in "
                    f"{LIVE_CHUNK_S * 1e3:.0f} ms chunks",
            "kernel_launches": paced_rec["kernel_launches"],
            "paced": paced_rec, "recovered": tones,
            "audio_vs_cpu": errs, "audio_vs_cpu_blocks": RX_CPU_BLOCKS,
            "kernel_check": agc_check,
            "unpaced": unpaced, "profiled_paced": profiled,
            "cli_selftest": "OK", "rtl_tcp": phase_rtl_tcp(), "card": card}


def phase_rtl_tcp() -> dict:
    """A fake rtl_tcp server (tests/test_io_extras.py:16's header and
    command protocol) streaming RTL_SECONDS of u8 IQ at 2.4 Msps, paced
    to real time, into `RtlTcpClient` -> `Receiver` (one stereo WFM VFO)
    -> a paced `AudioSink`: every sample, no underrun after the first
    second, the station's tones, card vs CPU on the first two blocks; no
    hand kernel on this path (a lone VFO's own DDC)."""
    import struct

    from sdrtpu_torch.apps import live_radio as live
    from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig
    from sdrtpu_torch.io.audio_sink import AudioSink
    from sdrtpu_torch.io.net import bytes_to_iq, iq_to_bytes
    from sdrtpu_torch.io.rtl_tcp import RtlTcpClient

    n = int(RTL_FS * RTL_SECONDS)
    wire = iq_to_bytes(live.make_station(RTL_FS, RTL_OFFSET, n), "u8")
    chunk = int(RTL_FS * LIVE_CHUNK_S)

    def build(device, sinks):
        fe = IQFrontend(RTL_FS, {"v0": VfoConfig(RTL_OFFSET, "wfm")},
                        spectrum=False, device=device)
        return Receiver(fe, audio_sinks=sinks)

    sink = live.PlayoutSink(AudioSink(48000.0, backend=logged_paced_backend(),
                                      latency_packets=10))
    audio = []

    def tap(a):
        audio.append(a)
        sink(a)

    rx = build("cuda", {"v0": tap})
    rx.warmup()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    # the server: dongle info (tuner type 5, R820T; 29 gain steps), then
    # the samples paced to real time
    sender = live.Transmitter(wire, chunk, n // chunk, RTL_FS, fmt="u8",
                              header=b"RTL0" + struct.pack(">II", 5, 29)
                              ).start()
    cli = RtlTcpClient("127.0.0.1", sender.port)
    cli.set_sample_rate(RTL_FS)
    cli.set_frequency(100e6)
    run = live.stream(cli, rx, sender.total_samples,
                      timeout_s=3 * RTL_SECONDS + 60)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    sink.close()  # before the wait for the transmitter's exit, as live's
    sender.join(30.0)
    cli.close()
    checks = live_checks("rtl_tcp", run, sender, launches,
                         expected_launches(), {"v0": sink})
    left, right = dominant_hz(audio[-2][0]), dominant_hz(audio[-2][1])
    if abs(left - 440.0) > 6.0 or abs(right - 1200.0) > 6.0:
        raise AssertionError(f"rtl_tcp: recovered {left}, {right} Hz")
    # the port on the CPU over the first two blocks of the same bytes
    cpu_audio = []
    cpu_rx = build("cpu", {"v0": cpu_audio.append})
    cpu_rx.push(bytes_to_iq(wire[:4 * rx.block_len], "u8"))
    cpu_rx.flush()
    err = float(np.abs(np.concatenate(audio[:2], axis=-1)
                       - np.concatenate(cpu_audio, axis=-1))[..., RX_SKIP:]
                .max())
    if not err <= AUDIO_ATOL:
        raise AssertionError(f"rtl_tcp: card vs CPU audio {err}")
    lat = live.latencies(sender, sink.arrivals, rx.block_len)
    elapsed = run["t_end"] - run["t_first"]
    return {"rtl_tcp": f"fake rtl_tcp server, u8 at {RTL_FS / 1e6:.1f} Msps, "
                       f"one stereo WFM VFO, {RTL_SECONDS:.0f} s paced",
            "block_len": rx.block_len, "samples_sent": sender.total_samples,
            "samples_received": run["pushed"], "kernel_launches": launches,
            "recovered_hz": [left, right], "audio_vs_cpu_max_abs_err": err,
            "real_time_factor": run["pushed"] / RTL_FS / elapsed,
            "push_busy_share": run["push_s"] / elapsed,
            "latency_ms_median": float(np.median(lat)) * 1e3,
            "latency_ms_p95": float(np.percentile(lat, 95)) * 1e3,
            "underruns": sink.sink.backend.underruns, **checks}


def phase_scanner(card: str) -> dict:
    """examples/band_scanner.py's selftest through the port's
    `apps.band_scanner.scan` on the card: 1 Msps, two NFM stations among
    silent channels, the example's scanner settings; both stations found
    and recorded, each WAV's dominant tone its station's; no hand kernel
    (a lone NFM VFO's own DDC)."""
    import shutil

    from sdrtpu_torch.apps import band_scanner as bs
    from sdrtpu_torch.io import wav

    fs = 1_000_000.0
    iq = bs.selftest_band(fs)
    out_dir = os.path.join("build", "chip_smoke", "scan")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = bs.scan(iq, fs, out_dir, -400_000.0, 400_000.0, 100_000.0, -40.0,
                  device="cuda", log=log)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    recorded = {}
    for (f0, tone, *_), path in zip(bs.SELFTEST_STATIONS,
                                    sorted(res["paths"], key=lambda p: int(
                                        os.path.basename(p)[4:-6]))):
        info, data = wav.read_wav(path)
        hz = dominant_hz(data[:, 0])
        recorded[os.path.basename(path)] = {"frames": int(data.shape[0]),
                                            "dominant_hz": hz,
                                            "station_tone_hz": tone}
        if (info.channels != 2 or data.shape[0] <= 4800
                or abs(hz - tone) > 6.0):
            raise AssertionError(f"scanner: {path}: {recorded}")
    if (res["hits"] != sorted(round(f0) for f0, *_ in bs.SELFTEST_STATIONS)
            or len(res["paths"]) != 2 or launches != expected_launches()):
        raise AssertionError(f"scanner: hits {res['hits']}, recordings "
                             f"{res['paths']}, launched {launches}")
    return {"scanner": "1 Msps, two NFM stations among silent channels, "
                       "scan -400..400 kHz every 100 kHz at -40 dB",
            "hits_hz": res["hits"], "recordings": recorded,
            "block_len": res["block_len"], "kernel_launches": launches,
            "seconds": wall, "real_time_factor": iq.size / fs / wall,
            "card": card}


REMOTE_BLOCKS = 24          # receiver blocks of 2 000 000 in the first
                            # session: 4.8 s of the capture
REMOTE_PROFILED_BLOCKS = 10  # the second session (zstd where there is
                             # one), under the CUDA-only profiler
REMOTE_CENTER = 100_000_000.0  # the frequency rigctl sees at offset 0
# control events, each before the receiver block of that index: the
# rigctl and web retunes run on their own threads over the next pushes;
# the two demodulator switches are joined before the block is pushed,
# so each block's launches are known
REMOTE_RETUNES_AT, REMOTE_NFM_AT, REMOTE_AM_AT = 6, 12, 16
NET_SECONDS = 2.0           # of each fake's station
NET_CHUNK_S = 0.02          # the fakes' 20 ms messages
SPY_FS, SPY_OFFSET = 2_500_000.0, 300_000.0       # int16 IQ, a WFM station
HERMES_FS, HERMES_OFFSET = 384_000.0, 50_000.0    # the top rate code, AM
HERMES_TONE = 700.0
# tests/test_flex_spectran_rigctl.py's stream: 99-101 MHz, 2 Msps float32
SPECTRAN_FS, SPECTRAN_OFFSET, SPECTRAN_TONE = 2_000_000.0, 200_000.0, 1000.0


class Job(threading.Thread):
    """A control client on a thread of its own; `finish` waits for it and
    re-raises what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.error, self.result = fn, None, None

    def run(self):
        try:
            self.result = self.fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by join
            self.error = e

    def finish(self, timeout=60.0):
        self.join(timeout)
        if self.is_alive():
            raise AssertionError(f"{self.fn.__name__} did not finish")
        if self.error is not None:
            raise self.error
        return self.result


def start_server(path: str, log_lines: list) -> tuple:
    """``python -m sdrtpu_torch.apps.server`` on ``path`` in a process of
    its own, on a loopback port it picks; returns (process, port).  Its
    standard error is kept in ``log_lines`` by a reader thread."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrtpu_torch.apps.server", "--input", path,
         "--addr", "127.0.0.1", "--port", "0", "--max-seconds", "900"],
        stderr=subprocess.PIPE, text=True)
    port = None
    t0 = time.monotonic()
    while port is None and time.monotonic() - t0 < 120.0:
        line = proc.stderr.readline()
        if not line:
            break
        log_lines.append(line.rstrip())
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        port = int(m.group(1)) if m else None
    if port is None:
        proc.kill()
        raise AssertionError(f"remote: the server did not start: {log_lines}")
    threading.Thread(target=lambda: log_lines.extend(
        ln.rstrip() for ln in proc.stderr), daemon=True).start()
    return proc, port


def wire_checks(where: str, packets: list, cap: np.ndarray,
                block: int) -> dict:
    """The server's blocks are the capture looped: find where the first
    one starts, then hold every packet to the wire decode of that block
    of the loop (the server compresses whole blocks; the last packet may
    be cut) and to the capture within one int16 step of its scale (the
    block's peak component clips from 32768 to 32767 steps) and two
    float32 ulps of it (the decode's product)."""
    from sdrtpu_torch.io import compression

    n = len(cap)
    step = np.gcd(block, n)
    head = packets[0][:64]
    starts = np.arange(0, n, step)
    err = np.abs(cap[(starts[:, None] + np.arange(64)) % n] - head).max(axis=1)
    pos0 = int(starts[np.argmin(err)])
    worst = 0.0
    for k, p in enumerate(packets):
        seg = cap[(pos0 + k * block + np.arange(block)) % n]
        want = compression.decompress(compression.compress(
            seg, compression.PCM_TYPE_I16))[:len(p)]
        if not np.array_equal(p, want):
            raise AssertionError(f"{where}: packet {k} is not the looped "
                                 f"capture's block at {pos0 + k * block}")
        scale = float(np.abs(np.stack([seg.real, seg.imag])).max())
        dev = float(np.abs(np.stack([(p - seg[:len(p)]).real,
                                     (p - seg[:len(p)]).imag])).max())
        bound = scale / 32768.0 + 2 * float(np.spacing(np.float32(scale)))
        if dev > bound:
            raise AssertionError(f"{where}: packet {k} is {dev} off the "
                                 f"capture (one step and two ulps {bound})")
        worst = max(worst, dev / scale * 32768.0)
    return {"start_sample": pos0, "packets": len(packets),
            "max_dev_int16_steps": worst}


def phase_remote(card: str) -> dict:
    """The SDR++ server/client split with the receiver on the card: the
    port's `apps/server.py` `main` serves the receiver capture (an int16
    IQ WAV) from a process of its own; the port's `SdrppClient` (i16)
    feeds the receiver path's VFO set (`build_receiver`) on the card.
    Before START: the SmGui menu round trip and the sample rate.  In
    mid stream, each from a thread of its own: a `RigctlServer` ``F``
    that moves the per-VFO usb channel onto its spare station (``f``
    reads it back), `SpectrumWebServer` ``/spectrum.json``,
    ``/status.json`` and a ``/tune`` that moves the grouped w2 channel
    onto its spare, and `RadioInterface` (through `ModuleComManager`,
    with `receiver_rebuild`) switching the am VFO to nfm and back.  Then
    a second session, zstd-compressed where this machine has zstd, under
    the profiler for the card's busy share."""
    import urllib.request

    from sdrtpu_torch.apps import module_com as mc_mod
    from sdrtpu_torch.apps.rigctl_client import RigctlProtocolClient
    from sdrtpu_torch.apps.rigctl_server import RigctlServer
    from sdrtpu_torch.apps.waterfall import WaterfallView
    from sdrtpu_torch.apps.webview import SpectrumWebServer
    from sdrtpu_torch.io import compression, smgui, wav
    from sdrtpu_torch.io import server_protocol as sp
    from torch.profiler import ProfilerActivity, profile

    block = 65536  # the server's default
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "remote_capture.wav")
    wav.write_iq_wav(path, int(RX_FS), receiver_capture(11, RX_BLOCK),
                     "int16")
    _, cap = wav.read_iq_wav(path)  # what the server serves
    server_log: list[str] = []
    proc, port = start_server(path, server_log)
    rig = web = None
    try:
        cli = sp.SdrppClient("127.0.0.1", port)
        # before START: the remote menu and the rate
        widgets = cli.get_ui()
        combo = next(w for w in widgets if w.step == smgui.STEP_COMBO)
        assert combo.label == "##sdrtpu_server_src_sel", combo.label
        assert smgui.split_combo_items(combo.operands[2].s) == [
            "File", "Network"] and combo.operands[1].i == 0
        t0 = time.perf_counter()
        widgets = cli.ui_action("##sdrtpu_server_src_sel",
                                smgui.Elem.integer(1))
        ui_ms = (time.perf_counter() - t0) * 1e3
        labels = [w.label for w in widgets]
        redraw = [w for w in cli.get_ui() if w.step == smgui.STEP_COMBO]
        if not ("##sdrtpu_net_port" in labels
                and redraw[0].operands[1].i == 1):
            raise AssertionError(f"remote: the source combo's action is not "
                                 f"in the next draw: {labels}")
        cli.ui_action("##sdrtpu_server_src_sel", smgui.Elem.integer(0))
        rate = cli.get_samplerate()
        if rate != RX_FS:
            raise AssertionError(f"remote: GET_SAMPLERATE {rate}")
        cli.set_sample_type(compression.PCM_TYPE_I16)

        rx, audio, _ = build_receiver("cuda")
        fe = rx.frontend
        view = WaterfallView(fft_size=65536, height=8, view_width=1024)
        rx.spectrum_sink = view.push
        rx.warmup()
        rig = RigctlServer(
            "127.0.0.1", 0,
            get_freq=lambda: REMOTE_CENTER + fe.vfos["usb"].cfg.offset_hz,
            set_freq=lambda f: rx.retune("usb", f - REMOTE_CENTER))
        web = SpectrumWebServer(view, receiver=rx)
        mc = mc_mod.ModuleComManager()
        mc.register_interface("radio", "Radio", mc_mod.RadioInterface(
            rx, "am", mc_mod.receiver_rebuild(rx, "am")))
        rt: dict = {}

        def get_json(what):
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{web.port}{what}", timeout=30) as r:
                body = json.loads(r.read())
            return body, (time.perf_counter() - t0) * 1e3

        def rigctl_retune():
            c = RigctlProtocolClient("127.0.0.1", rig.port)
            want = REMOTE_CENTER + RX_SPARE["usb"][0]
            t0 = time.perf_counter()
            code = c.set_freq(want)
            rt["rigctl_F_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            back = c.get_freq()
            rt["rigctl_f_ms"] = (time.perf_counter() - t0) * 1e3
            c.close()
            if code != 0 or back != want:
                raise AssertionError(f"rigctl: RPRT {code}, f read {back}, "
                                     f"want {want}")

        def web_session():
            spec, rt["spectrum_json_ms"] = get_json("/spectrum.json")
            db = np.asarray(spec["db"])
            floor = float(np.median(db))
            peaks = {}
            for name, (off, _) in list(RX_VFOS.items()) + [
                    (n + "_spare", v) for n, v in RX_SPARE.items()]:
                px = int((off + RX_FS / 2) / RX_FS * len(db))
                peaks[name] = float(db[max(px - 2, 0):px + 3].max()) - floor
            if min(peaks.values()) < 20.0:
                raise AssertionError(f"webview: station peaks over the floor "
                                     f"{peaks} dB")
            rt["spectrum_peaks_db_over_floor"] = peaks
            body, rt["tune_ms"] = get_json(
                f"/tune?vfo=w2&offset={RX_SPARE['w2'][0]:.0f}")
            st, rt["status_json_ms"] = get_json("/status.json")
            if not (body == {"ok": True} and st["samplerate"] == RX_FS
                    and st["vfos"]["w2"]["offset"] == RX_SPARE["w2"][0]
                    and {n: v["mode"] for n, v in st["vfos"].items()}
                    == {n: m for n, (_, m) in RX_VFOS.items()}):
                raise AssertionError(f"webview: /tune {body}, status {st}")

        def switch(mode):
            def radio_set_mode():
                t0 = time.perf_counter()
                mc.call_interface("Radio", mc_mod.RADIO_IFACE_CMD_SET_MODE,
                                  mc_mod.RADIO_IFACE_MODES.index(mode))
                rt.setdefault("set_mode_ms", []).append(
                    (time.perf_counter() - t0) * 1e3)
                if fe.vfos["am"].radio.mode != mode:
                    raise AssertionError(f"SET_MODE {mode}: the am VFO runs "
                                         f"{fe.vfos['am'].radio.mode}")
            return radio_set_mode

        jobs = {}

        def on_block(b):
            if b == REMOTE_RETUNES_AT:
                jobs["rig"] = Job(rigctl_retune)
                jobs["web"] = Job(web_session)
                jobs["rig"].start()
                jobs["web"].start()
            if b == REMOTE_NFM_AT - 3:
                jobs.pop("rig").finish()
                jobs.pop("web").finish()
            if b in (REMOTE_NFM_AT, REMOTE_AM_AT):
                job = Job(switch("nfm" if b == REMOTE_NFM_AT else "am"))
                job.start()
                job.finish()

        def session(n_blocks, on_block=None):
            """Read baseband and push it a block at a time; returns the
            packets as received and the timings."""
            packets, pend, pend_n, push_ms, b = [], [], 0, [], 0
            need = n_blocks * RX_BLOCK
            got, t_first = 0, None
            while got < need:
                iq = cli.recv_baseband(timeout=30.0)
                if iq is None:
                    raise AssertionError("remote: the server stopped sending")
                if t_first is None:
                    t_first = time.monotonic()
                iq = iq[:need - got]
                packets.append(iq)
                got += len(iq)
                pend.append(iq)
                pend_n += len(iq)
                if pend_n < RX_BLOCK:
                    continue
                x = np.concatenate(pend)
                while len(x) >= RX_BLOCK:
                    if on_block is not None:
                        on_block(b)
                    t0 = time.perf_counter()
                    rx.push(x[:RX_BLOCK])
                    push_ms.append((time.perf_counter() - t0) * 1e3)
                    x, b = x[RX_BLOCK:], b + 1
                pend, pend_n = [x], len(x)
            t_end = time.monotonic()
            cli.stop()
            rx.flush()
            torch.cuda.synchronize()
            return packets, {"samples": got, "seconds": t_end - t_first,
                             "push_ms": push_ms}

        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        cli.start()
        packets, timing = session(REMOTE_BLOCKS, on_block)
        launches = {name: fn.launches for name, fn in counters.items()}
        n_nfm = REMOTE_AM_AT - REMOTE_NFM_AT
        want = expected_launches(
            chunk_poly=2 * REMOTE_BLOCKS,
            agc_scan=3 * (REMOTE_BLOCKS - n_nfm) + 2 * n_nfm + 2)
        if launches != want:
            raise AssertionError(f"remote: launched {launches}, want {want}")
        wire = wire_checks("remote", packets, cap, block)
        if wire["start_sample"] != 0:
            raise AssertionError(f"remote: the stream began at sample "
                                 f"{wire['start_sample']}")
        head = np.concatenate(packets[:RX_CPU_BLOCKS * RX_BLOCK // block + 1])
        rx_blocks = [head[k * RX_BLOCK:(k + 1) * RX_BLOCK]
                     for k in range(RX_CPU_BLOCKS)]
        del packets, head
        for name, chunks_ in audio.items():
            assert len(chunks_) == REMOTE_BLOCKS, (name, len(chunks_))
        # the tones: before the retunes, after every event, and the am VFO
        # while it ran nfm (its AM station's tone gone) and after
        before = rx_tone_checks("remote, before the retunes",
                                {n: v[REMOTE_RETUNES_AT - 1]
                                 for n, v in audio.items()}, retuned=False)
        after = rx_tone_checks("remote, after every event",
                               {n: v[-1] for n, v in audio.items()},
                               retuned=True)
        f_am = rx_tones("am")[0]
        am_db = {"am_before": tone_db(audio["am"][REMOTE_NFM_AT - 1][0], f_am),
                 "nfm": max(tone_db(a[0], f_am) for a in
                            audio["am"][REMOTE_NFM_AT:REMOTE_AM_AT]),
                 "am_after": tone_db(audio["am"][-1][0], f_am)}
        if not (am_db["nfm"] < min(am_db["am_before"], am_db["am_after"])
                - 30.0):
            raise AssertionError(f"remote: the am VFO's {f_am} Hz tone "
                                 f"around the nfm switch: {am_db} dB")
        # the same port on the CPU over the first blocks
        cpu_rx, cpu_audio, _ = build_receiver("cpu", spectrum=False)
        with recording("agc_scan") as calls:
            for x in rx_blocks:
                cpu_rx.push(x)
            cpu_rx.flush()
        errs = rx_audio_vs_cpu("remote", {n: v[:RX_CPU_BLOCKS]
                                          for n, v in audio.items()},
                               cpu_audio)
        agc_check = hold_recorded("agc_scan", calls["agc_scan"],
                                  "the remote path")
        agc_check["at_path_shapes"] = [at_path_shape("agc_scan", a)
                                       for a, _ in calls["agc_scan"][:3]]
        del cpu_rx, cpu_audio, rx_blocks
        cli.close()

        # the second session: zstd where there is one, profiled.  The
        # server takes a client once the last one's connection has ended
        for _ in range(100):
            cli = sp.SdrppClient("127.0.0.1", port)
            try:
                cli._sock.settimeout(5.0)
                if cli.get_samplerate() == RX_FS:
                    break
            except (ConnectionError, OSError):
                cli.close()
                time.sleep(0.05)
        cli._sock.settimeout(None)
        cli.set_sample_type(compression.PCM_TYPE_I16)
        zstd_calls = [0]
        unpatched = sp.compression.zstd_decompress
        if compression.HAVE_ZSTD:
            cli.set_compression(True)
            zstd = "on"

            def counted(data):
                zstd_calls[0] += 1
                return unpatched(data)

            sp.compression.zstd_decompress = counted
        else:
            zstd = ("skipped: no zstd on this machine (neither the "
                    "zstandard module nor libzstd)")
            log(f"remote: second session without compression, zstd {zstd}")
        for fn in counters.values():
            fn.launches = 0
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        try:
            cli.start()
            packets2, timing2 = session(REMOTE_PROFILED_BLOCKS)
        finally:
            prof.stop()
            sp.compression.zstd_decompress = unpatched
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        launches2 = {name: fn.launches for name, fn in counters.items()}
        want2 = expected_launches(chunk_poly=2 * REMOTE_PROFILED_BLOCKS,
                                  agc_scan=3 * REMOTE_PROFILED_BLOCKS)
        if launches2 != want2:
            raise AssertionError(f"remote, second session: launched "
                                 f"{launches2}, want {want2}")
        wire2 = wire_checks("remote, second session", packets2, cap, block)
        if compression.HAVE_ZSTD and zstd_calls[0] != len(packets2):
            raise AssertionError(f"remote: {zstd_calls[0]} of "
                                 f"{len(packets2)} packets were zstd")
        cli.close()
    finally:
        for srv in (rig, web):
            if srv is not None:
                srv.close()
        proc.kill()
        proc.wait(30)
    s1 = timing["samples"]
    return {"remote": f"sdrtpu_torch.apps.server (file source, a process of "
                      f"its own, {block}-sample i16 blocks) -> SdrppClient -> "
                      f"receiver ({RX_FS / 1e6:.0f} Msps, 8 VFOs, {RX_BLOCK}-"
                      f"sample blocks); rigctl, webview and RadioInterface "
                      f"mid stream",
            "blocks": REMOTE_BLOCKS, "samples_received": s1, "wire": wire,
            "kernel_launches": launches,
            "received_msps": s1 / timing["seconds"] / 1e6,
            "real_time_factor": s1 / RX_FS / timing["seconds"],
            "push_ms_per_block_median": float(np.median(timing["push_ms"])),
            "push_ms_per_block_max": float(np.max(timing["push_ms"])),
            "round_trip_ms": {"ui_action": ui_ms, **rt},
            "recovered_before_retunes": before, "recovered": after,
            "am_tone_db": am_db,
            "audio_vs_cpu": errs, "audio_vs_cpu_blocks": RX_CPU_BLOCKS,
            "kernel_check": agc_check,
            "second_session": {
                "zstd": zstd, "blocks": REMOTE_PROFILED_BLOCKS,
                "wire": wire2, "kernel_launches": launches2,
                "real_time_factor": (timing2["samples"] / RX_FS
                                     / timing2["seconds"]),
                "device_busy_share": busy_us / 1e6 / timing2["seconds"],
                "device_busy_ms_per_block": (busy_us / 1e3
                                             / REMOTE_PROFILED_BLOCKS)},
            "server_log": server_log[-5:], "card": card}


# -- the netclients path: the fakes' wire, made the same in both processes --

def net_station(kind: str) -> np.ndarray:
    """NET_SECONDS of one station at its client's rate and offset."""
    from sdrtpu_torch.apps import live_radio

    if kind == "spy":  # stereo WFM, 440 Hz left, 1200 Hz right
        return live_radio.make_station(SPY_FS, SPY_OFFSET,
                                       int(SPY_FS * NET_SECONDS))
    fs, off = ((HERMES_FS, HERMES_OFFSET) if kind == "hermes"
               else (SPECTRAN_FS, SPECTRAN_OFFSET))
    n = int(fs * NET_SECONDS)
    if kind == "hermes":
        n = -(-n // 126) * 126  # whole USB packets
    t = np.arange(n) / fs
    rng = np.random.default_rng({"hermes": 21, "spectran": 22}[kind])
    if kind == "hermes":
        base = 0.4 * (1.0 + 0.5 * np.sin(2 * np.pi * HERMES_TONE * t))
    else:
        base = 0.5 * np.exp(1j * np.cumsum(
            2 * np.pi * 2500.0 * np.sin(2 * np.pi * SPECTRAN_TONE * t) / fs))
    x = base * np.exp(2j * np.pi * off * t) + 1e-3 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def net_wire(kind: str) -> list:
    """The fake's messages: SpyServer int16 IQ bodies, Hermes USB packets,
    Spectran float32 chunk payloads (20 ms each; Hermes 126 samples)."""
    from sdrtpu_torch.io import hermes

    x = net_station(kind)
    if kind == "hermes":
        return [hermes.build_usb_packet(x[k:k + 126], seq=k // 126)
                for k in range(0, len(x), 126)]
    fs = SPY_FS if kind == "spy" else SPECTRAN_FS
    per = int(fs * NET_CHUNK_S)
    inter = np.empty(2 * len(x), np.float32)
    inter[0::2], inter[1::2] = x.real, x.imag
    if kind == "spy":
        inter = np.clip(np.rint(inter * 32767.0), -32768, 32767).astype(
            np.int16)
    return [inter[2 * k:2 * (k + per)].tobytes()
            for k in range(0, len(x), per)]


def _serve_spyserver(sock, bodies):
    import struct

    from sdrtpu_torch.io import spyserver as ss

    conn, _ = sock.accept()
    conn.settimeout(120.0)
    f = conn.makefile("rb")
    ctype, size = struct.unpack("<II", f.read(8))
    f.read(size)  # HELLO
    hdr = struct.Struct("<IIIII")
    conn.sendall(hdr.pack(ss.PROTOCOL_VERSION, ss.MSG_DEVICE_INFO, 0, 0, 48)
                 + struct.pack("<12I", 2, 1, int(SPY_FS), int(SPY_FS), 0, 1,
                               30, 24_000_000, 1_766_000_000, 12, 0, 0))
    while True:  # settings until the stream is enabled
        ctype, size = struct.unpack("<II", f.read(8))
        setting, value = struct.unpack("<II", f.read(size))
        if setting == ss.SETTING_STREAMING_ENABLED and value:
            break
    t0 = time.monotonic()
    for k, body in enumerate(bodies):
        wait = t0 + k * NET_CHUNK_S - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        conn.sendall(hdr.pack(ss.PROTOCOL_VERSION, ss.MSG_INT16_IQ,
                              ss.STREAM_TYPE_IQ, k, len(body)) + body)
    with contextlib.suppress(OSError, struct.error):
        while True:  # until the client stops the stream
            ctype, size = struct.unpack("<II", f.read(8))
            if struct.unpack("<II", f.read(size)) == (
                    ss.SETTING_STREAMING_ENABLED, 0):
                break
    conn.close()


def _serve_hermes(sock, packets):
    _, addr = sock.recvfrom(2048)  # the client's start
    t0 = time.monotonic()
    k = 0
    while k < len(packets):
        due = int((time.monotonic() - t0) * HERMES_FS / 126) + 1
        while k < min(due, len(packets)):
            sock.sendto(packets[k], addr)
            k += 1
        time.sleep(0.005)
    sock.settimeout(5.0)
    with contextlib.suppress(OSError):
        while sock.recvfrom(2048)[0][3] != 0:  # until the client's stop
            pass


def _serve_spectran(sock, payloads):
    conn, _ = sock.accept()
    conn.settimeout(120.0)
    req = b""
    while b"\r\n\r\n" not in req:
        req += conn.recv(4096)
    conn.sendall(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n")
    meta = json.dumps({"startFrequency": 99_000_000,
                       "endFrequency": 101_000_000,
                       "sampleFrequency": int(SPECTRAN_FS)}).encode() + b"\n"
    t0 = time.monotonic()
    for k, p in enumerate(payloads):
        wait = t0 + k * NET_CHUNK_S - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        body = meta + bytes([0x1E]) + p
        conn.sendall(hex(len(body))[2:].encode() + b"\r\n" + body + b"\r\n")
    conn.sendall(b"0\r\n\r\n")
    conn.close()


def _netclient_fakes(ports, done):
    """The netclients path's three fake servers, in a process of its own:
    a SpyServer (int16 IQ), a Hermes (UDP USB packets) and a Spectran HTTP
    stream, each streaming its station once, paced to real time."""
    import socket

    socks = {}
    for kind, stype in (("spy", socket.SOCK_STREAM),
                        ("hermes", socket.SOCK_DGRAM),
                        ("spectran", socket.SOCK_STREAM)):
        s = socket.socket(socket.AF_INET, stype)
        s.bind(("127.0.0.1", 0))
        s.settimeout(300.0)
        if stype == socket.SOCK_STREAM:
            s.listen(1)
        socks[kind] = s
    wires = {kind: net_wire(kind) for kind in socks}
    ports.put({kind: s.getsockname()[1] for kind, s in socks.items()})
    serve = {"spy": _serve_spyserver, "hermes": _serve_hermes,
             "spectran": _serve_spectran}
    threads = [threading.Thread(target=serve[k], args=(socks[k], wires[k]),
                                daemon=True) for k in socks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    done.set()


def phase_netclients(card: str) -> dict:
    """The other network sources into the receiver on the card: one
    spawned process serves a SpyServer (int16 at 2.5 Msps, a stereo WFM
    station), a Hermes (384 kHz, an AM station: `agc_scan`) and a Spectran
    HTTP stream (float32 at 2 Msps, an NFM station), NET_SECONDS each,
    paced; the port's `SpyServerClient`, `HermesClient` and
    `SpectranHttpClient` each feed a `Receiver` with one VFO on the card,
    one after the other.  The IQ each received must be bit-equal to the
    same wire bytes decoded by the client's own decoding on the host."""
    import multiprocessing as mp
    import socket

    from sdrtpu_torch.apps import live_radio as live
    from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig
    from sdrtpu_torch.io import hermes, spectran_http, spyserver

    ctx = mp.get_context("spawn")
    ports_q, done = ctx.Queue(), ctx.Event()
    proc = ctx.Process(target=_netclient_fakes, args=(ports_q, done),
                       daemon=True)
    proc.start()
    out = {}
    try:
        wires = {kind: net_wire(kind) for kind in ("spy", "hermes",
                                                   "spectran")}
        decoded = {
            "spy": np.concatenate([spyserver.decode_iq(
                spyserver.MSG_INT16_IQ, b) for b in wires["spy"]]),
            "hermes": np.concatenate([hermes.parse_usb_packet(p)
                                      for p in wires["hermes"]]),
            "spectran": np.concatenate([spectran_http.decode_iq(p)
                                        for p in wires["spectran"]])}
        ports = ports_q.get(timeout=300.0)
        cfg = {"spy": (SPY_FS, SPY_OFFSET, "wfm"),
               "hermes": (HERMES_FS, HERMES_OFFSET, "am"),
               "spectran": (SPECTRAN_FS, SPECTRAN_OFFSET, "nfm")}
        for kind, (fs, off, mode) in cfg.items():
            audio, received = [], []
            fe = IQFrontend(fs, {"v0": VfoConfig(off, mode)}, spectrum=False,
                            device="cuda")
            rx = Receiver(fe, audio_sinks={"v0": audio.append},
                          baseband_sinks=[lambda b: received.append(
                              np.array(b))])
            rx.warmup()
            counters = kernel_counters()
            for fn in counters.values():
                fn.launches = 0
            if kind == "spy":
                src = spyserver.SpyServerClient("127.0.0.1", ports["spy"])
                if src.wait_device_info(30.0) is None:
                    raise AssertionError("spyserver: no device info")
                src.set_frequency(100e6)
                src.start_stream(spyserver.FORMAT_INT16)
            elif kind == "hermes":
                src = hermes.HermesClient(("127.0.0.1", ports["hermes"]))
                # room for 1.3 s of packets, should the reader wait
                src._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                     4 << 20)
                src.start()
                src.set_samplerate(int(HERMES_FS))
                src.set_frequency(7.1e6)
            else:
                src = spectran_http.SpectranHttpClient("127.0.0.1",
                                                       ports["spectran"])
            total = len(decoded[kind])
            run = live.stream(src, rx, total, timeout_s=3 * NET_SECONDS + 60)
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            if kind == "spy":
                src.stop_stream()
            src.close()
            got = np.concatenate(received)
            blocks = -(-total // rx.block_len)
            want = expected_launches(agc_scan=blocks if mode == "am" else 0)
            problems = []
            if not np.array_equal(got, decoded[kind]):
                problems.append(f"received {len(got)} samples of {total}, "
                                "not the wire's decode")
            if launches != want:
                problems.append(f"launched {launches}, want {want}")
            tail = np.concatenate(audio, axis=-1)[:, -48000:]
            tones = [dominant_hz(tail[0]), dominant_hz(tail[1])]
            expect = {"wfm": [440.0, 1200.0], "am": [HERMES_TONE],
                      "nfm": [SPECTRAN_TONE]}[mode]
            if any(abs(t - e) > 6.0 for t, e in zip(tones, expect)):
                problems.append(f"recovered {tones}, sent {expect}")
            if problems:
                raise AssertionError(f"netclients {kind}: " + "; ".join(
                    problems))
            elapsed = run["t_end"] - run["t_first"]
            check = None
            if mode == "am":
                # the first block's AGC through the same VFO on the CPU,
                # its plain calls launched again as the kernel and timed
                cpu_rx = Receiver(IQFrontend(fs, {"v0": VfoConfig(off, mode)},
                                             spectrum=False, device="cpu"),
                                  audio_sinks={"v0": lambda a: None})
                with recording("agc_scan") as calls:
                    cpu_rx.push(got[:rx.block_len])
                check = hold_recorded("agc_scan", calls["agc_scan"],
                                      f"the netclients path ({kind})")
                check["at_path_shape"] = at_path_shape(
                    "agc_scan", calls["agc_scan"][0][0])
            out[kind] = {"mode": mode, "samplerate": fs,
                         "kernel_check": check,
                         "block_len": rx.block_len, "samples": total,
                         "kernel_launches": launches,
                         "recovered_hz": tones[:len(expect)],
                         "real_time_factor": total / fs / elapsed,
                         "push_busy_share": run["push_s"] / elapsed}
            log(f"netclients: {kind} done, {out[kind]}")
        if not done.wait(60.0):
            raise AssertionError("netclients: the fakes did not finish")
    finally:
        proc.join(30.0)
        if proc.is_alive():
            proc.terminate()
            proc.join(10.0)
    launches = {name: sum(r["kernel_launches"][name] for r in out.values())
                for name in kernel_counters()}
    return {"netclients": f"one process of fakes -> SpyServer (int16, "
                          f"{SPY_FS / 1e6} Msps, WFM), Hermes (UDP, "
                          f"{HERMES_FS / 1e3:.0f} kHz, AM), Spectran HTTP "
                          f"(float32, {SPECTRAN_FS / 1e6:.0f} Msps, NFM), "
                          f"{NET_SECONDS:.0f} s each, paced -> one-VFO "
                          f"receivers on the card",
            "kernel_launches": launches, **out, "card": card}

# -- multichip and tooling ---------------------------------------------------

MULTICHIP_PLANS = {  # name: (VFOs, input rate, global block, blocks)
    "flagship": (8, 10_000_000.0, 500_000, 8),
    "vfo64": (64, 50_000_000.0, 2_500_000, 6),  # BASELINE config 5
}
MULTICHIP_SKIP = 3      # blocks 0-2: the filter-fill transient
MULTICHIP_ATOL = 1e-4   # sharded vs unsharded audio, tests/test_shard.py:270
MULTICHIP_SCALING_REPS = 10  # best of: host time spreads 2x between calls


def all_cards() -> list[str]:
    """nvidia-smi's name and power limit of every card on the machine."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def multichip_capture(offsets, fs, n, device) -> torch.Tensor:
    """One stereo FM station at each offset (as `stereo_capture`), made in
    float64 on the card, handed back on the host as complex64: the global
    capture every rank's call takes."""
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    x = torch.zeros(n, dtype=torch.complex128, device=device)
    for i, fc in enumerate(offsets):
        left = torch.sin(2 * np.pi * (400 + 150 * i) * t)
        right = torch.sin(2 * np.pi * (900 + 150 * i) * t)
        mpx = (0.45 * (left + right) + 0.1 * torch.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * torch.sin(2 * np.pi * 38000 * t))
        phase = torch.cumsum(2 * np.pi * 75000.0 * mpx / fs, 0)
        x += 0.1 * torch.exp(1j * (2 * np.pi * fc * t + phase))
    return x.to(torch.complex64).cpu()


def multichip_rank(n_ranks: int) -> dict:
    """One rank of the multichip phase (its NCCL group joined, its card
    set): each plan of `MULTICHIP_PLANS` through `ShardedWbfmPipeline`,
    block by block, with chunk_poly's launches counted around the run and
    the collectives' bytes read from the mesh; rank 0 holds the gathered
    audio against the unsharded pipeline on its card; then the weak-
    scaling times (one rank's share of the work, unsharded, against the
    sharded call)."""
    from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline
    from sdrtpu_torch.shard.flagship import ShardedWbfmPipeline
    from sdrtpu_torch.shard.mesh import (all_gather, make_mesh,
                                         shard_channel_state)
    from sdrtpu_torch.shard.multihost import scaling_efficiency

    n_time = 2 if (n_ranks >= 4 and n_ranks % 2 == 0) else 1
    n_channel = n_ranks // n_time
    mesh = make_mesh(n_channel, n_time)
    dev = mesh.device
    out = {"rank": mesh.rank, "coords": [mesh.index("channel"),
                                         mesh.index("time")],
           "card": torch.cuda.get_device_name(dev), "plans": {}}
    for name, (n_vfo, fs, block, n_blocks) in MULTICHIP_PLANS.items():
        offsets = np.linspace(-0.4 * fs, 0.4 * fs, n_vfo)
        x = multichip_capture(offsets, fs, n_blocks * block, dev)
        sh = ShardedWbfmPipeline(offsets, fs, block, mesh, skip_rotator=True)
        state = shard_channel_state(mesh, sh.init_state(), n_vfo)
        before = dict(mesh.traffic)
        audio, block_ms = [], []
        torch.cuda.synchronize(dev)
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        with torch.inference_mode():
            for b in range(n_blocks):
                t0 = time.perf_counter()
                state, a = sh(state, x[b * block:(b + 1) * block])
                torch.cuda.synchronize(dev)
                block_ms.append((time.perf_counter() - t0) * 1e3)
                audio.append(a)
        launches = {k: fn.launches for k, fn in counters.items()}
        if launches != expected_launches(chunk_poly=n_blocks):
            raise AssertionError(f"multichip {name}: rank {mesh.rank} "
                                 f"launched {launches}, want chunk_poly "
                                 f"{n_blocks} and nothing else")
        res = {"chunk_poly_launches": launches["chunk_poly"],
               "block_ms": block_ms,
               "ms_per_block": float(np.median(block_ms[1:])),
               "bytes_per_block": {k: (mesh.traffic[k] - before[k])
                                   / n_blocks for k in mesh.traffic}}
        with torch.inference_mode():
            got = all_gather(mesh, torch.stack(audio), "channel", dim=2)
            if mesh.rank == 0:
                pipe = WbfmMultiVfoPipeline(
                    offsets, fs, block, channelizer_method="fft",
                    skip_rotator=True, device=dev)
                st_u, errs = pipe.init_state(), []
                for b in range(n_blocks):
                    st_u, ref = pipe(st_u, x[b * block:(b + 1) * block].to(
                        dev))
                    errs.append(float((got[b] - ref).abs().max()))
                assert tuple(got.shape[1:]) == tuple(ref.shape) == (
                    2, n_vfo, pipe.out_len(block)), (got.shape, ref.shape)
                res["max_abs_err_by_block"] = errs
                res["max_abs_err"] = max(errs[MULTICHIP_SKIP:])
                if not res["max_abs_err"] < MULTICHIP_ATOL:
                    raise AssertionError(
                        f"multichip {name}: sharded vs unsharded audio "
                        f"{errs} (blocks >= {MULTICHIP_SKIP} must be within "
                        f"{MULTICHIP_ATOL})")
                del pipe, st_u
            # weak scaling: one rank's share (its channel rows, its time
            # span) unsharded on its card, against the sharded call
            c_local, span = n_vfo // n_channel, block // n_time
            one = WbfmMultiVfoPipeline(offsets[:c_local], fs, span,
                                       channelizer_method="fft",
                                       skip_rotator=True, device=dev)
            st1, x1, xn = one.init_state(), x[:span], x[:block]
            res["scaling"] = scaling_efficiency(
                lambda: one(st1, x1.to(dev)), lambda: sh(state, xn),
                (), (), n_ranks, reps=MULTICHIP_SCALING_REPS)
        out["plans"][name] = res
        del sh, state, audio, got, one, st1, x
        torch.cuda.empty_cache()
    return out


def phase_multichip() -> dict:
    """The sharded flagship over every card present, one NCCL process a
    card (on one card: one process, a (1, 1) mesh, no collective).  Both
    plans of `MULTICHIP_PLANS` must hold the unsharded pipeline's audio
    within MULTICHIP_ATOL after the transient, with chunk_poly launched
    once a block on every rank."""
    from sdrtpu_torch.shard.multihost import run_processes

    n = torch.cuda.device_count()
    cards = all_cards()
    workdir = os.path.join("build", "chip_smoke", "multichip")
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_processes(multichip_rank, n, workdir, args=(n,),
                          device="cuda", timeout=600)
    n_time = 2 if (n >= 4 and n % 2 == 0) else 1
    line = {"path": "multichip", "ranks": n, "mesh": [n // n_time, n_time],
            "cards": cards, "halo_crossed_cards": n_time > 1,
            "seconds": time.perf_counter() - t0, "plans": {}}
    if n_time == 1:
        line["note"] = ("no halo crossed a card: the time axis has one rank"
                        + ("" if n > 1 else ", and the mesh one card"))
    for name, (n_vfo, fs, block, n_blocks) in MULTICHIP_PLANS.items():
        per = [r["plans"][name] for r in ranks]
        line["plans"][name] = {
            "vfos": n_vfo, "fs": fs, "global_block": block,
            "blocks": n_blocks,
            "max_abs_err": per[0]["max_abs_err"],
            "max_abs_err_by_block": per[0]["max_abs_err_by_block"],
            "chunk_poly_launches_per_rank": [p["chunk_poly_launches"]
                                             for p in per],
            "ms_per_block_per_rank": [p["ms_per_block"] for p in per],
            "block_ms_per_rank": [[round(v, 3) for v in p["block_ms"]]
                                  for p in per],
            # summed over the ranks: what crossed between cards a block
            "halo_bytes_per_block": sum(p["bytes_per_block"]["halo"]
                                        for p in per),
            "allgather_bytes_per_block": sum(
                p["bytes_per_block"]["allgather"] for p in per),
            "allreduce_bytes_per_block": sum(
                p["bytes_per_block"]["allreduce"] for p in per),
            "scaling": per[0]["scaling"],
            "t1_tN_per_rank": [[p["scaling"]["t_single"],
                                p["scaling"]["t_sharded"]] for p in per],
        }
        log(f"multichip {name}: {json.dumps(line['plans'][name])}")
    return line


TOOLING_FFT_N = 65536


def phase_tooling(card: str) -> dict:
    """The port's measurement tooling on the card: `measure_op` of the
    flagship's FftDecimatorChain and of a 317-tap `Fir` at 500 000
    samples, `measure_hbm_peak` (it raises above 105 % of the data
    sheet's 3.35 TB/s), `profile_flagship` of the 8-VFO flagship against
    the H100's peaks (every stage's ``hbm_util`` at most 1.05), and
    `four_step_fft` against ``torch.fft.fft`` at N = 65 536."""
    from sdrtpu_torch.benchmark import measure_op
    from sdrtpu_torch.kernels import taps as tapsmod
    from sdrtpu_torch.kernels.fftspec import four_step_fft
    from sdrtpu_torch.kernels.fir import Fir

    pipe, x = build_flagship("cuda")
    chain = pipe.channelizer.fused
    pilot = tapsmod.band_pass(18750.0, 19250.0, 3000.0, 250000.0,
                              odd_tap_count=True)
    assert len(pilot) == 317, len(pilot)
    fir = Fir(2.0 * np.real(pilot), dtype=torch.complex64, device="cuda")
    ops = {"fft_decimator_chain": measure_op(chain, (pipe.block_len,)),
           "fir_317": measure_op(fir, (500_000,))}
    hbm = rooflib.measure_hbm_peak()
    prof = rooflib.profile_flagship(pipe, x)
    over = {k: v["hbm_util"] for k, v in prof["stages"].items()
            if v.get("hbm_util", 0.0) > 1.05}
    if over:
        raise AssertionError(f"profile_flagship: hbm_util above 1.05: {over}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(TOOLING_FFT_N, dtype=torch.complex64, device="cuda",
                    generator=gen)
    want, got = torch.fft.fft(z), four_step_fft(z)
    fft = {"n": TOOLING_FFT_N,
           "max_abs_err_of_peak": float((got - want).abs().max()
                                        / want.abs().max()),
           "four_step_ms": device_ms(lambda: four_step_fft(z), 20),
           "torch_fft_ms": device_ms(lambda: torch.fft.fft(z), 20)}
    if not fft["max_abs_err_of_peak"] < 1e-4:
        raise AssertionError(f"four_step_fft: {fft}")
    return {"path": "tooling", "card": card, "measure_op": ops,
            "hbm_stream_read_gbps": hbm,
            "hbm_share_of_data_sheet": hbm / rooflib.H100_PEAKS["hbm_gbps"],
            "profile_flagship": prof, "four_step_fft": fft}


def main(argv) -> int:
    t_start = time.perf_counter()
    paths = {}

    def done(what):
        log(f"phase {what}: done at {time.perf_counter() - t_start:.1f} s")
        if what.endswith(" path") and what[:-5] in paths:
            log(json.dumps(paths[what[:-5]]))

    dev = phase_device()
    built = phase_build()
    plan_pipe, _ = build_flagship("cpu")
    fused = plan_pipe.channelizer.fused
    # the fft path launches chunk_poly once per sub-window of blocks
    rx_plans = receiver_plans()
    kernels = phase_kernels((fused.valid, fused.ratio, fused.nif,
                             fused.n_chunks * plan_pipe._subk(256)), rx_plans,
                            multichip_plans())
    kernels.append(phase_mix_decimate(built["mix_decimate"]))
    done("build and K1/K2 checks")
    paths["multichip"] = phase_multichip()
    done("multichip path")
    paths["tooling"] = phase_tooling(dev["card"])
    done("tooling")
    kernels += phase_seq_loops()
    done("seq loops")
    kernels.append(phase_decim_fir())
    done("decim_fir")
    kernels += phase_sync_kernels()
    done("sync kernels")
    wider = phase_rates_and_banks()
    done("viterbi rates and mm_scan banks")
    profile_path = (argv[argv.index("--profile") + 1]
                    if "--profile" in argv else None)
    for method, kernel in (("fft", "chunk_poly"), ("pallas", "mix_decimate")):
        torch.cuda.reset_peak_memory_stats()
        paths[method] = phase_path(
            dev["card"], method,
            profile_path=(profile_path + (".pallas" if method == "pallas"
                                          else "")
                          if profile_path else None))
        done(f"{method} path")
        # each kernel's launches are read on its own path
        for k in kernels:
            if k["name"] == kernel:
                k["launches"] = paths[method]["kernel_launches"][kernel]
    torch.cuda.reset_peak_memory_stats()
    paths["receiver"] = phase_receiver(
        dev["card"], rx_plans,
        profile_path + ".receiver" if profile_path else None)
    done("receiver path")
    paths["pll"] = phase_pll(dev["card"])
    paths["ctcss"] = phase_ctcss(dev["card"])
    done("pll and ctcss")
    paths["meteor"] = phase_meteor(
        dev["card"], profile_path + ".meteor" if profile_path else None)
    done("meteor path")
    paths["rds"] = phase_rds(dev["card"])
    done("rds path")
    paths["tf32"] = phase_tf32(dev["card"])
    done("tf32")
    for name, phase in (("dab", phase_dab), ("falcon9", phase_falcon9),
                        ("kg_sstv", phase_kg_sstv), ("m17", phase_m17),
                        ("ryfi", phase_ryfi)):
        paths[name] = phase(dev["card"])
        done(f"{name} path")
    torch.cuda.reset_peak_memory_stats()
    paths["pfb"] = phase_path(
        dev["card"], "pfb", profile_path=(profile_path + ".pfb"
                                          if profile_path else None))
    done("pfb path")
    for name, phase in (("paging", phase_paging), ("vor", phase_vor),
                        ("atv", phase_atv), ("scanner", phase_scanner)):
        paths[name] = phase(dev["card"])
        done(f"{name} path")
    paths["live"] = phase_live(dev["card"], paths["receiver"]["msps"])
    done("live path")
    paths["remote"] = phase_remote(dev["card"])
    done("remote path")
    paths["netclients"] = phase_netclients(dev["card"])
    done("netclients path")
    meteor_launches = paths["meteor"]["kernel_launches"]
    fused_launches = meteor_launches["costas_mm_scan"]
    kernels.append(costas_mm_entry(
        paths["meteor"]["kernel_checks"]["costas_mm_scan"], fused_launches,
        paths["meteor"]["kernel_ms_on_path"].get(
            "costas_scan_into_mm_scan_kernel")))
    for k in kernels:
        if k["name"] in ("costas_scan", "mm_scan", "viterbi_decode"):
            # costas_mm_scan counts one of each, but launches neither
            k["launches"] = meteor_launches[k["name"]] - (
                fused_launches if k["name"] != "viterbi_decode" else 0)
            k["path_check"] = check = paths["meteor"]["kernel_checks"][
                k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], check["max_abs_err"])
            k["rds_path_launches"] = paths["rds"]["kernel_launches"][
                k["name"]]
        if k["name"] in ("costas_scan", "mm_scan", "viterbi_decode"):
            for name in ("dab", "falcon9", "kg_sstv", "m17", "ryfi"):
                k[f"{name}_path_launches"] = paths[name]["kernel_launches"][
                    k["name"]]
            # the held calls of each path that records its CPU run
            for name, checks in (
                    ("kg_sstv", paths["kg_sstv"]["kernel_checks"]),
                    ("m17", paths["m17"]["kernel_checks"]),
                    ("m17_random_preamble",
                     paths["m17"]["random_preamble"]["kernel_checks"]),
                    ("ryfi", paths["ryfi"]["kernel_checks"])):
                if k["name"] in checks:
                    check = k[f"{name}_path_check"] = checks[k["name"]]
                    k["max_abs_err"] = max(k["max_abs_err"],
                                           check["max_abs_err"])
        if k["name"] in wider:
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                r["max_abs_err"] for r in wider[k["name"]]])
        if k["name"] == "viterbi_decode":
            k["rates"] = wider["viterbi_decode"]
            k["dab_path"] = {**paths["dab"]["viterbi_at_path_shape"],
                             "path_check": paths["dab"]["kernel_check"]}
        if k["name"] == "mm_scan":
            k["path_shapes"] = {
                "kg_sstv": paths["kg_sstv"]["kernel_checks"]["mm_scan"][
                    "at_path_shape"],
                "m17": paths["m17"]["kernel_checks"]["mm_scan"][
                    "at_path_shape"],
                "ryfi": paths["ryfi"]["kernel_checks"]["mm_scan"][
                    "at_path_shape"],
                "paging": paths["paging"]["kernel_check"]["at_path_shape"]}
            k["paging_path_launches"] = paths["paging"]["kernel_launches"][
                "mm_scan"]
            k["paging_path_check"] = paths["paging"]["kernel_check"]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   paths["paging"]["kernel_check"][
                                       "max_abs_err"])
            k["wide_banks"] = wider["mm_scan"]
            k["falcon9_path"] = {**paths["falcon9"]["mm_scan_at_path_shape"],
                                 "path_check": paths["falcon9"][
                                     "kernel_check"]}
        if k["name"] == "agc_scan":
            k["launches"] = paths["receiver"]["kernel_launches"]["agc_scan"]
            for name in ("live", "remote", "netclients"):
                k[f"{name}_path_launches"] = paths[name]["kernel_launches"][
                    "agc_scan"]
            # the CPU runs' plain AGC calls, launched again as the kernel
            hermes = paths["netclients"]["hermes"]["kernel_check"]
            for name, check in (("receiver", paths["receiver"]["kernel_check"]),
                                ("live", paths["live"]["kernel_check"]),
                                ("remote", paths["remote"]["kernel_check"]),
                                ("netclients", hermes)):
                k[f"{name}_path_check"] = check
                k["max_abs_err"] = max(k["max_abs_err"], check["max_abs_err"])
        if k["name"] == "pll_scan":
            k["launches"] = paths["pll"]["kernel_launches"]["pll_scan"]
            k["rds_path_launches"] = paths["rds"]["kernel_launches"][
                "pll_scan"]
            # each path's launches held on the card and one of them timed
            for name, check in (("pll", paths["pll"]["kernel_check"]),
                                ("rds", paths["rds"]["pll_check"])):
                k[f"{name}_path_check"] = {
                    key: v for key, v in check.items()
                    if key != "at_path_shape"}
                k["max_abs_err"] = max(k["max_abs_err"], check["max_abs_err"])
            k["path_shapes"] = {
                "pll": paths["pll"]["kernel_check"]["at_path_shape"],
                "rds": paths["rds"]["pll_check"]["at_path_shape"]}
        if k["name"] == "decim_fir":  # once per DDC stage and block
            k["launches"] = paths["receiver"]["decim_fir_launches"]
        if k["name"] == "chunk_poly":  # once per fused group and block
            k["receiver_path_launches"] = (
                paths["receiver"]["kernel_launches"]["chunk_poly"])
            k["live_path_launches"] = (
                paths["live"]["kernel_launches"]["chunk_poly"])
            k["remote_path_launches"] = (
                paths["remote"]["kernel_launches"]["chunk_poly"])
            k["multichip_path_launches_per_rank"] = {
                name: plan["chunk_poly_launches_per_rank"]
                for name, plan in paths["multichip"]["plans"].items()}
    # each kernel launches on its own path, or (costas_scan and mm_scan,
    # which the meteor path no longer launches) on another path
    assert all(k["launches"] or any(
        v for key, v in k.items() if key.endswith("_path_launches"))
        for k in kernels), [(k["name"], k["launches"]) for k in kernels]
    print(json.dumps({"kernels": kernels}), flush=True)
    for name in ("fft", "pallas", "receiver", "pll", "ctcss", "meteor",
                 "rds", "tf32", "dab", "falcon9", "kg_sstv", "m17", "ryfi",
                 "pfb", "paging", "vor", "atv", "live", "scanner", "remote",
                 "netclients", "multichip", "tooling"):
        print(json.dumps(paths[name]), flush=True)
    print(json.dumps({"timer_fallbacks": TIMER_FALLBACKS}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
