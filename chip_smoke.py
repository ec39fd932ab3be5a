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
   data movement, so exact; mix_decimate within 1e-5 of the peak of both
   of its plain versions, the reference's per-sample rotation and the
   kernel's own output rotation, also over a 2.5 M-sample block at the
   band edges and with a ragged channel group), with its time beside
   its bound, its grid on this card and its registers;
4. fft flagship: the 8-VFO WBFM pipeline off a 10 Msps capture,
   500k-sample blocks, 65536-bin waterfall at 20 Hz, ``skip_rotator``,
   through ``scan_repeat`` over 256 blocks;
5. pallas path: the same pipeline with ``channelizer_method="pallas"``
   (stage 1 in mix_decimate, one launch per block) and the rotator on.

Around each path's 256-block run every kernel's launch count is set to 0
and read (fft: chunk_poly 32, mix_decimate 0; pallas: 256 and 0); then
the same port runs on the CPU from the card's mid-stream state, and the
card's audio and waterfall are held against it.

Standard output: the card line, the ``kernels`` JSON line, the fft
flagship line, the pallas path line, and last
``{"ok": true, "device": {...}}``.
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


def phase_kernels(flagship_plan) -> list[dict]:
    """chunk_poly against chunk_poly_ref, exact, at every checked shape,
    each timed beside its plain version and the one-call library copy.
    The JSON entry's own numbers are at the flagship sub-window shape
    (what the main path launches); ``ms`` is time on the card from the
    profiler, ``event_ms`` CUDA events over back-to-back calls."""
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
            for k, v in timings.items() if k != (valid, R, nif, P_main)],
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
             "bytes": nbytes, "flops": flops,
             "bound_ms": max(nbytes / H100_BYTES_PER_S,
                             flops / H100_FP32_FLOPS) * 1e3,
             "bound_by": ("bytes" if nbytes / H100_BYTES_PER_S
                          >= flops / H100_FP32_FLOPS else "operations"),
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
    from sdrtpu_torch.kernels import chunks, fused_channelizer

    return {"chunk_poly": chunks.chunk_poly,
            "mix_decimate": fused_channelizer.mix_decimate}


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


def main(argv) -> int:
    dev = phase_device()
    built = phase_build()
    plan_pipe, _ = build_flagship("cpu")
    fused = plan_pipe.channelizer.fused
    # the fft path launches chunk_poly once per sub-window of blocks
    kernels = phase_kernels((fused.valid, fused.ratio, fused.nif,
                             fused.n_chunks * plan_pipe._subk(256)))
    kernels.append(phase_mix_decimate(built["mix_decimate"]))
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps(paths["fft"]), flush=True)
    print(json.dumps(paths["pallas"]), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
