"""Drive sdrtpu_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile FILE  # also writes the torch.profiler
                                          # tables of 4 steady-state
                                          # sub-windows of each path to
                                          # FILE (fft) and FILE.pallas

Phases, each fatal:

1. device: a CUDA card is present; its name and power limit; TF32 off;
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
4. fft flagship: the 8-VFO WBFM pipeline off a 10 Msps capture,
   500k-sample blocks, 65536-bin waterfall at 20 Hz, ``skip_rotator``,
   through ``scan_repeat`` over 256 blocks;
5. pallas path: the same pipeline with ``channelizer_method="pallas"``
   (stage 1 in mix_decimate, one launch per block) and the rotator on;
6. scan kernels: agc_scan and pll_scan against their plain PyTorch loops
   on the card, at the step counts the receiver and the WFM pilot PLL
   launch and one long shape each, timed beside the plain loop;
7. receiver path: `IQFrontend` + `Receiver.push`/`flush` off one 10 Msps
   capture with a 65536-bin waterfall at 20 Hz and eight VFOs — three
   wfm stereo (one fft channelizer group, K1), two nfm (a second group),
   am, usb and cw (per-VFO DDCs; agc_scan) — over 32 M samples at
   ``scan_batch`` 1 and 8, with a live retune of a grouped and a per-VFO
   channel and a demodulator switch am -> nfm -> am in mid stream;
8. pll path: `BroadcastFm(pilot_mode="pll", rds_out=True)` over 8 blocks
   of 12 500 samples (pll_scan, one launch per block);
9. ctcss: an NFM chain with the CTCSS squelch on 50 ms blocks, card
   against CPU, and the squelch op's time per block.

Around each path's run every kernel's launch count is set to 0 and read,
and must be exact (fft: chunk_poly 32, mix_decimate 0; pallas: 256 and
0; receiver and pll: see `phase_receiver` and `phase_pll`); then the same
port runs on the CPU, and the card's audio (and waterfall) is held
against it.

Standard output: the card line, the ``kernels`` JSON line, the fft
flagship line, the pallas path line, the receiver, pll and ctcss lines,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
H100_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
K2_REL_TOL = 1e-5  # mix_decimate vs plain: max_abs_err / max|plain|
AUDIO_ATOL = 2e-4  # card vs CPU audio, as tests/test_torch_pipeline.py
SPEC_DB_ATOL = 0.02  # card vs CPU waterfall bins within 80 dB of the peak
AGC_GAIN_RTOL = 1e-5  # agc_scan vs plain loop: gain and final average
PLL_VCO_ATOL = 1e-4   # pll_scan vs plain loop: unit phasor; carried rad
# One step's dependent chain, for the serial bound of the scan kernels:
# cycles per dependent float32 operation and per IEEE division (assumed
# latencies of the SM's FP32 pipe and of the division's reciprocal plus
# refinement sequence), times the operations on the carry's path.
DEP_OP_CYCLES, DEP_DIV_CYCLES = 4, 36
AGC_CHAIN = (8, 1)   # mul add select select | div | min mul compare select
PLL_CHAIN = (13, 2)  # sub wrap(div+3) mul add max min add add wrap(div+3)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def device_ms(fn, reps: int) -> float:
    """Kernel time on the card per call of ``fn()`` (all its kernels).
    A trace that comes back without a device event is taken again, and
    each retake is logged."""
    fn()

    def run():
        for _ in range(reps):
            fn()

    for take in range(3):
        prof, _, busy_us = profiled(run)
        if busy_us > 0:
            return busy_us / reps / 1e3
        log(f"device_ms: take {take + 1} of 3 has no device event among "
            f"{len(prof.events())} events; taken again")
    raise AssertionError("the profiler saw no kernel on the card")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    card = card_line()
    print(f"card: {card}", flush=True)
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from sdrtpu_torch import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.2f} s cached={r['cached']}\n{r['log']}")
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


def phase_kernels(flagship_plan, rx_plans: dict) -> list[dict]:
    """chunk_poly against chunk_poly_ref, exact, at every checked shape
    (the test shapes, the flagship's sub-window, the 64-VFO plan and the
    receiver path's two fused groups), each timed beside its plain
    version and the one-call library copy.  The JSON entry's own numbers
    are at the flagship sub-window shape (what the fft path launches);
    the receiver path's shapes stand under ``receiver_shapes``.  ``ms``
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
        timings[(v, r, q, p)] = t = {"bound_ms": nbytes / H100_BYTES_PER_S * 1e3}
        for key, fn in fns.items():
            t[key + "ms"] = device_ms(fn, 20)
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
            if k != (valid, R, nif, P_main) and k not in rx_plans.values()],
        "receiver_shapes": [
            {"group_if_hz": g, "shape": list(k),
             **{n: round(t, 6) for n, t in timings[k].items()}}
            for g, k in rx_plans.items()],
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
            t[key + "ms"] = device_ms(fn, 20)
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
    from sdrtpu_torch.kernels import chunks, fused_channelizer, loops

    return {"chunk_poly": chunks.chunk_poly,
            "mix_decimate": fused_channelizer.mix_decimate,
            "agc_scan": loops.agc_scan, "pll_scan": loops.pll_scan}


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
    want = ({"chunk_poly": K // sub, "mix_decimate": 0} if method == "fft"
            else {"chunk_poly": 0, "mix_decimate": K})
    want.update(agc_scan=0, pll_scan=0)
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
    for b in range(2):
        xb = stereo[b * block:(b + 1) * block]
        st_c, (a_cpu, s_cpu) = cpu_pipe(st_c, torch.as_tensor(xb))
        st_g, (a_gpu, s_gpu) = pipe(st_g, torch.as_tensor(xb, device="cuda"))
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
    if method == "fft":
        what = "skip_rotator"
        plan = [ch.fused.valid, ch.fused.ratio, ch.fused.nif, ch.fused.nfft]
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
        "audio_vs_cpu_max_abs_err": a_err,
        "bench_capture_audio_vs_cpu_max_abs_err": bench_err,
        "waterfall_vs_cpu_max_abs_db": s_err,
        "device_busy_ms_per_block": busy_ms_block,
        "device_busy_share": busy_ms_block / (dt * 1e3 / K),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
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
    rate and float32 operations over its peak rate, and which it is."""
    by_bytes, by_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def serial_chain_ms(steps: int, chain) -> float:
    """steps x the dependent latency of one step at the card's SM clock."""
    ops, divs = chain
    cycles = ops * DEP_OP_CYCLES + divs * DEP_DIV_CYCLES
    hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    return steps * cycles / hz * 1e3


def phase_seq_loops() -> list[dict]:
    """agc_scan and pll_scan against their plain loops on the card.

    AGC shapes: 750 / 1200 / 150 steps (AM, SSB, CW IF blocks of 50 ms),
    3000 / 4800 / 600 (the receiver path's 200 ms blocks), real and
    complex input, one and five rows, the average starting at 0, a burst
    that trips the clipping look-ahead, and one long shape.  PLL: 12 500
    steps on a noisy 19 kHz pilot (the pll path's block) and one long
    shape.  ``ms`` is device time per launch (profiler), ``plain_ms`` the
    plain loop's wall time, taken once.  ``bound_ms`` is the contract's
    bytes-or-operations bound.  What really bounds a scan is its serial
    chain; `serial_chain_ms` reckons it from assumed latencies, so it
    goes to the log only and not into the measured line."""
    from sdrtpu_torch.kernels import loops

    rng = np.random.default_rng(7)
    fs_if = 15000.0
    atk, dcy = np.float32(50.0 / fs_if), np.float32(5.0 / fs_if)
    coef = (float(np.float32(1) - atk), float(atk),
            float(np.float32(1) - dcy), float(dcy), 1.0, 1e7, 10.0)
    agc_rows = {}
    agc_main = (1, 4800, False)  # the receiver's usb launch
    for rows, n, cplx in [(1, 750, False), (1, 1200, False), (1, 150, False),
                          (1, 750, True), (5, 1200, True), (1, 3000, False),
                          agc_main, (1, 600, False), (2, 24000, False)]:
        x = 1e-3 * rng.standard_normal((rows, n))
        if cplx:
            x = x + 1e-3j * rng.standard_normal((rows, n))
        x[:, :4] = 0.0
        x[:, n // 2:n // 2 + 3] *= 3e4
        x = torch.as_tensor(x.astype(np.complex64 if cplx else np.float32),
                            device="cuda")
        in_amp = x.abs().float().contiguous()
        smax = in_amp.flip(-1).cummax(-1).values.flip(-1).contiguous()
        amp0 = torch.zeros(rows, device="cuda")
        args = (in_amp, smax, amp0, *coef)
        g, amp = loops.agc_scan(*args)
        torch.cuda.synchronize()
        plain_ms = wall_ms(lambda: loops.agc_scan_ref(*args))
        g_ref, amp_ref = loops.agc_scan_ref(*args)
        rel = ((g - g_ref).abs() / g_ref.abs()).max().item()
        rel_amp = ((amp - amp_ref).abs() / amp_ref.abs()).max().item()
        clipped = int((g_ref[:, 1:] < 0.5 * g_ref[:, :-1]).sum().item())
        if not (max(rel, rel_amp) <= AGC_GAIN_RTOL
                and bool(torch.isfinite(g).all()) and clipped >= rows):
            raise AssertionError(
                f"agc_scan disagrees at {(rows, n, cplx)}: gain rel err "
                f"{rel}, average rel err {rel_amp}, look-ahead hits {clipped}")
        agc_rows[(rows, n, cplx)] = t = {
            "shape": [rows, n], "complex_input": cplx,
            "max_rel_err": max(rel, rel_amp),
            "max_abs_err": (g - g_ref).abs().max().item(),
            "ms": device_ms(lambda: loops.agc_scan(*args), 20),
            "plain_ms": plain_ms,
            # |x|, suffix max and gain per step, the average in and out;
            # ~12 float32 operations per step
            **roofline(4 * (3 * rows * n + 2 * rows), 12 * rows * n)}
        log(f"agc_scan {(rows, n, cplx)}: {t}; reckoned serial chain "
            f"{serial_chain_ms(n, AGC_CHAIN):.4f} ms")

    fs = 250000.0
    w = lambda hz: float(np.float32(2 * np.pi * hz / fs))
    pll = loops.Pll(25000.0 / fs, init_freq=w(19000.0), min_freq=w(18750.0),
                    max_freq=w(19250.0), device="cuda")
    pll_rows = {}
    pll_main = (1, 12500)
    for rows, n in [pll_main, (2, 25000)]:
        t_ax = np.arange(n)
        f = 19000.0 + 40.0 * np.arange(rows)[:, None]
        x = (0.1 * np.exp(1j * (2 * np.pi * f / fs * t_ax + 0.7))
             + 0.01 * (rng.standard_normal((rows, n))
                       + 1j * rng.standard_normal((rows, n))))
        x = torch.as_tensor(x.astype(np.complex64), device="cuda")
        args = (x, torch.zeros(rows, device="cuda"),
                torch.full((rows,), w(19000.0), device="cuda"),
                *pll._coefficients())
        vco, phase, freq = loops.pll_scan(*args)
        torch.cuda.synchronize()
        plain_ms = wall_ms(lambda: loops.pll_scan_ref(*args))
        vco_ref, phase_ref, freq_ref = loops.pll_scan_ref(*args)
        err = (vco - vco_ref).abs().max().item()
        carry = max(loops._wrap_pi(phase - phase_ref).abs().max().item(),
                    (freq - freq_ref).abs().max().item())
        lock = torch.angle(vco[:, -100:] * torch.conj(x[:, -100:]))
        if not (max(err, carry) <= PLL_VCO_ATOL
                and lock.abs().max().item() < 0.5):
            raise AssertionError(
                f"pll_scan disagrees at {(rows, n)}: phasor err {err}, "
                f"carry err {carry}, lock {lock.abs().max().item()} rad")
        pll_rows[(rows, n)] = t = {
            "shape": [rows, n], "max_abs_err": err, "carry_abs_err": carry,
            "ms": device_ms(lambda: loops.pll_scan(*args), 10),
            "plain_ms": plain_ms,
            # complex64 in and out, the carries; ~60 operations per step
            # (atan2f, two wraps, cosf and sinf)
            **roofline(16 * rows * n + 16 * rows, 60 * rows * n)}
        log(f"pll_scan {(rows, n)}: {t}; reckoned serial chain "
            f"{serial_chain_ms(n, PLL_CHAIN):.4f} ms")

    def entry(name, replaces, main, rows, tol_key, tol):
        m = rows[main]
        return {
            "name": name, "route": "cuda",
            "source": "sdrtpu_torch/csrc/seq_loops.cu",
            # no Pallas kernel: the reference's lax.scan of this loop
            "replaces": replaces,
            "launches": None,  # filled in from its path's run
            "max_abs_err": m["max_abs_err"], tol_key: tol,
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,  # no PyTorch call computes this recurrence
            "shape": m["shape"],
            "other_shapes": [v for k, v in rows.items() if k != main]}

    return [entry("agc_scan", "sdrtpu/kernels/loops.py:185", agc_main,
                  agc_rows, "gain_rtol", AGC_GAIN_RTOL),
            entry("pll_scan", "sdrtpu/kernels/loops.py:79", pll_main,
                  pll_rows, "vco_atol", PLL_VCO_ATOL)]


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


def build_receiver(device, scan_batch=1, sinks=True, spectrum=True):
    from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig

    fe = IQFrontend(RX_FS, {n: VfoConfig(o, m)
                            for n, (o, m) in RX_VFOS.items()},
                    fft_size=65536, fft_rate=20.0, device=device)
    audio = {n: [] for n in RX_VFOS}
    spec = []
    rx = Receiver(fe, audio_sinks=({n: audio[n].append for n in audio}
                                   if sinks else None),
                  spectrum_sink=spec.append if spectrum and sinks else None,
                  scan_batch=scan_batch)
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


def phase_receiver(card: str, rx_plans: dict,
                   profile_path: str | None = None) -> dict:
    """The generic receive path on the card, through `IQFrontend` and
    `Receiver.push`/`flush`.

    Launch counts, worked out from the code: each block launches
    chunk_poly once per fused group (2) and agc_scan once per AGC chain
    (am, usb, cw: 3; 2 while the am VFO runs nfm); `set_mode` runs the
    new chain once on a zero block (2 more chunk_poly; 2 agc_scan after
    the switch to nfm, 3 after the switch back).  mix_decimate and
    pll_scan are not on this path (the radio's pilot mode is
    "normalized")."""
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
    want = {"chunk_poly": 2 * (RX_BLOCKS + 2), "mix_decimate": 0,
            "agc_scan": 3 * (RX_BLOCKS - 2) + 2 * 2 + 2 + 3, "pll_scan": 0}
    if launches != want:
        raise AssertionError(f"receiver path launched {launches}, want {want}")

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
    t0 = time.perf_counter()
    for _ in range(RX_CPU_BLOCKS):
        cpu_rx.push(x)
    cpu_rx.flush()
    cpu_s = time.perf_counter() - t0
    errs = {}
    for name, (_, mode) in RX_VFOS.items():
        got = np.concatenate(audio[name][:RX_CPU_BLOCKS], axis=-1)
        ref = np.concatenate(cpu_audio[name], axis=-1)
        peak = float(np.abs(ref).max())
        err = float(np.abs(got - ref)[..., RX_SKIP:].max())
        tol = (AUDIO_ATOL if mode in ("wfm", "nfm")
               else RX_AGC_RTOL * max(peak, 1.0))
        errs[name] = {"max_abs_err": err, "tol": tol, "peak": peak}
        if not err <= tol:
            raise AssertionError(
                f"receiver: card audio vs CPU, VFO {name} ({mode}): {errs[name]}")
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
    with torch.inference_mode():
        for b in range(blocks):
            xb = torch.as_tensor(x[b * n:(b + 1) * n], device="cuda")
            sg, (a, rds) = gpu(sg, xb)
            outs.append((a, rds))
        torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"chunk_poly": 0, "mix_decimate": 0, "agc_scan": 0,
            "pll_scan": blocks}
    if launches != want:
        raise AssertionError(f"pll path launched {launches}, want {want}")
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
            "card": card}


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


def main(argv) -> int:
    dev = phase_device()
    built = phase_build()
    plan_pipe, _ = build_flagship("cpu")
    fused = plan_pipe.channelizer.fused
    # the fft path launches chunk_poly once per sub-window of blocks
    rx_plans = receiver_plans()
    kernels = phase_kernels((fused.valid, fused.ratio, fused.nif,
                             fused.n_chunks * plan_pipe._subk(256)), rx_plans)
    kernels.append(phase_mix_decimate(built["mix_decimate"]))
    kernels += phase_seq_loops()
    profile_path = (argv[argv.index("--profile") + 1]
                    if "--profile" in argv else None)
    paths = {}
    for method, kernel in (("fft", "chunk_poly"), ("pallas", "mix_decimate")):
        torch.cuda.reset_peak_memory_stats()
        paths[method] = phase_path(
            dev["card"], method,
            profile_path=(profile_path + (".pallas" if method == "pallas"
                                          else "")
                          if profile_path else None))
        # each kernel's launches are read on its own path
        for k in kernels:
            if k["name"] == kernel:
                k["launches"] = paths[method]["kernel_launches"][kernel]
    torch.cuda.reset_peak_memory_stats()
    paths["receiver"] = phase_receiver(
        dev["card"], rx_plans,
        profile_path + ".receiver" if profile_path else None)
    paths["pll"] = phase_pll(dev["card"])
    paths["ctcss"] = phase_ctcss(dev["card"])
    for k in kernels:
        if k["name"] == "agc_scan":
            k["launches"] = paths["receiver"]["kernel_launches"]["agc_scan"]
        if k["name"] == "pll_scan":
            k["launches"] = paths["pll"]["kernel_launches"]["pll_scan"]
        if k["name"] == "chunk_poly":  # once per fused group and block
            k["receiver_path_launches"] = (
                paths["receiver"]["kernel_launches"]["chunk_poly"])
    assert all(k["launches"] for k in kernels), [
        (k["name"], k["launches"]) for k in kernels]
    print(json.dumps({"kernels": kernels}), flush=True)
    for name in ("fft", "pallas", "receiver", "pll", "ctcss"):
        print(json.dumps(paths[name]), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
