"""Roofline accounting for the flagship pipeline's stages, on an H100.

PyTorch counterpart of ``sdrtpu/roofline.py``.  For each stage of
`WbfmMultiVfoPipeline` it

- measures seconds per block with the slope method (a loop of the stage
  at two lengths, each ended by a device synchronisation; the fixed
  cost cancels in the difference), and
- computes an analytic FLOP and HBM-byte model from the stage's own plan
  (FFT sizes, fold shapes, polyphase geometry),

then reports achieved GFLOP/s and GB/s against the card's peaks and
classifies each stage by its arithmetic intensity against the machine
balance.  The models are the reference's, copied as they are, so they
read the same work whatever implements it: they count ALGORITHMIC
traffic (inputs + outputs + unfused intermediates at one read and one
write each), so ``hbm_util`` bounds the achieved fraction of peak
bandwidth from above.  A stage timed by the slope includes the host's
enqueue where the host is slower than the card (eager PyTorch launches
each op from Python), so a host-bound stage reads a low utilization.

Peaks: `H100_PEAKS`, NVIDIA's H100 SXM data sheet (67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s HBM3) at its 700 W limit; a card
set below that limit runs slower under load.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import resolve_device
from ._precision import fp32_contractions

H100_PEAKS = {
    "name": "NVIDIA H100 SXM",
    "flops_f32": 67e12,
    "hbm_gbps": 3350.0,
}
# a measured streaming rate above this share of the data sheet's is a
# timer fault, not a measurement
HBM_FAULT_SHARE = 1.05


def bound(nbytes: float, flops: float, peaks: dict = H100_PEAKS) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flops`` float32 operations: the larger of bytes
    over the memory rate and operations over the peak rate, and which
    it is."""
    by_bytes = nbytes / (peaks["hbm_gbps"] * 1e9)
    by_ops = flops / peaks["flops_f32"]
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

# -- the analytic models: the reference's, as they are (their comments
# -- speak of the reference's TPU plans and measurements) ----------------
def _flog2(n: float) -> float:
    return float(np.log2(max(n, 2.0)))


def fft_flops(n: int, batch: int = 1) -> float:
    """Split-radix complex FFT: ~5 n log2 n real FLOPs."""
    return 5.0 * batch * n * _flog2(n)


def channelizer_model(chain, block_len: int) -> tuple[float, float]:
    """(flops, bytes) per block for an `FftDecimatorChain`.

    Models the polyphase-split forward path (round 4): the forward
    transform is a length-nif FFT batch over the chunk polyphase
    components (P*R rows), with the outer Cooley-Tukey stage folded into
    the host-precomputed table — so FFT flops carry log2(nif), not
    log2(nfft), and the chunk matrix additionally round-trips once
    through the (P, R, nif) transpose.
    """
    P, F, R = chain.n_chunks, chain.nfft, chain.ratio
    C, nif = chain.n_channels, chain.nif
    n_if_out = block_len // R
    c64 = 8.0
    if getattr(chain, "_sparse", False):
        # sparse opt-in path: direct nfft-point forward FFT (no
        # polyphase transpose), gather of Rk live alias rows per channel
        rk = chain.rk
        flops = (
            fft_flops(F, P)                # direct forward FFTs
            + 8.0 * P * rk * nif * C       # sparse fold
            + fft_flops(nif, C * P)
            + 20.0 * C * n_if_out
        )
        bytes_ = (
            block_len * c64
            + 2 * P * F * c64              # chunk matrix write+read
            + 2 * P * F * c64              # spectrum X write+read
            + C * rk * nif * c64           # sparse table read
            + 2 * C * P * rk * nif * c64   # gathered intermediate w+r
            + 2 * C * P * nif * c64        # folded spectrum write+read
            + 2 * C * n_if_out * c64
            + C * n_if_out * c64
        )
        return flops, bytes_
    flops = (
        fft_flops(nif, P * R)              # split forward FFTs (len nif)
        + 8.0 * P * R * nif * C            # alias-fold einsum (cmul+add)
        + fft_flops(nif, C * P)            # per-channel IFFTs
        + 20.0 * C * n_if_out              # residual rotator (sin/cos/cmul)
    )
    if getattr(chain, "_pallas_chunks", False):
        # one-pass Pallas builder: no separate chunk-matrix or transpose
        # round trips (kernels/pallas_chunks.py), but chunk_poly fetches
        # every input block twice — once as grid step g's main block and
        # once as step g-1's halo block — so the ext read costs
        # ~2*block_len
        front_bytes = 2 * block_len * c64 + 2 * P * F * c64
    else:
        front_bytes = (
            block_len * c64                # wideband read
            + 2 * P * F * c64              # chunk matrix write+read
            + 2 * P * F * c64              # polyphase transpose write+read
        )
    bytes_ = (
        front_bytes
        + 2 * P * F * c64                  # spectrum F write+read
        + C * R * nif * c64                # folded filter table read
        + 2 * C * P * nif * c64            # folded spectrum write+read
        + 2 * C * n_if_out * c64           # ifft out + rotator read
        + C * n_if_out * c64               # IF output write
    )
    return flops, bytes_


def fold_model(chain) -> tuple[float, float]:
    """(flops, bytes) for the alias-fold einsum ALONE (substage).

    Used as a second model-vs-measured grounding point (VERDICT r3 #3):
    the fold's traffic is exactly known — read the (P, nfft) spectrum,
    read the (C, R, nif) table, write the (C, P, nif) folded spectrum —
    so its measured GB/s can be compared against the streaming ceiling
    with no unfused-intermediate ambiguity.
    """
    P, F, R = chain.n_chunks, chain.nfft, chain.ratio
    C, nif = chain.n_channels, chain.nif
    c64 = 8.0
    flops = 8.0 * P * R * nif * C
    bytes_ = (P * F + C * R * nif + C * P * nif) * c64
    return flops, bytes_


def pfb_model(pfb, block_len: int) -> tuple[float, float]:
    """(flops, bytes) per block for a `PfbChannelizer` front end.

    Counts the polyphase fold at its ALGORITHMIC traffic — each of the
    V*tpp shifted-segment AXPYs reads an (F, D) span, i.e. the whole
    input again — which is exactly why the untuned PFB measured 17x
    under its own flop model on v5e (VERDICT r3 #8): the fold is
    bandwidth-bound at tpp*V input re-reads, not flop-bound.
    """
    M, D, V, tpp = pfb.M, pfb.D, pfb.V, pfb.tpp
    C = pfb.n_channels
    F = block_len // D                      # frames per block
    n_if = pfb.out_len(block_len)
    tpp_r = getattr(getattr(pfb.resamp, "resamp", None), "taps_per_phase", 16)
    c64 = 8.0
    flops = (
        2.0 * tpp * M * F                   # fold MACs (real taps x cplx)
        + fft_flops(M, F)                   # M-point FFT batch
        + 2.0 * F * M                       # frame twiddle
        + 20.0 * C * F                      # residual rotator
        + 8.0 * C * n_if * tpp_r            # fb->if polyphase resample
    )
    bytes_ = (
        tpp * V * block_len * c64           # fold input re-reads (V*tpp spans)
        + F * M * c64                       # fold output write
        + 2 * F * M * c64                   # FFT in+out
        + 2 * F * M * c64                   # twiddle read+write
        + F * M * c64 + C * F * c64         # bin gather read+write
        + 2 * C * F * c64                   # rotator read+write
        + C * n_if * c64                    # IF output write
    )
    return flops, bytes_


def wfm_model(demod, C: int, n_if: int) -> tuple[float, float]:
    """(flops, bytes) per block for `BroadcastFm`, pilot-mode aware."""
    pilot_taps = 317  # 18.75-19.25 kHz bandpass at 250 kHz (bandpass est.)
    envelope = getattr(demod, "pilot_mode", "normalized") == "envelope"
    c64, f32 = 8.0, 4.0
    if envelope:
        # banded-Toeplitz MXU pilot (round 4c): R*M MACs per output on
        # the real MPX.  The R shifted row views overlap by all but
        # R-1 rows, so HBM traffic is ~one input read + one write (the
        # first model counted R reads and measured util came out 1.05)
        M = 128
        R = 1 + -(-(pilot_taps - 1) // M)
        pilot_flops = 2.0 * C * n_if * R * M
        pilot_bytes = 2 * C * n_if * f32
    else:
        # FFT overlap-save pilot filter: fwd+pointwise+inv per sample.
        # 4 units here + the mpx write/read counted below = the 6 units
        # the pre-4c model carried for these modes (unchanged total)
        pilot_flops = 15.0 * C * n_if * _flog2(4 * pilot_taps)
        pilot_bytes = 4 * C * n_if * f32
    # 11-tap inverse-sinc MPX equalizer (round 5, fused shift-add)
    eq_flops = (2.0 * 11 * C * n_if) if getattr(demod, "mpx_eq", False) else 0.0
    flops = (
        26.0 * C * n_if                    # quadrature discriminator
        + eq_flops
        + pilot_flops
        + (8.0 if envelope else 25.0) * C * n_if  # c2 + L/R decode
    )
    bytes_ = (
        C * n_if * c64                     # IF read
        + 2 * C * n_if * f32               # mpx write + read
        + pilot_bytes
        + 2 * C * n_if * 2 * f32           # stereo write (+1 read later)
    )
    return flops, bytes_


def audio_model(resamp, deemph, C: int, n_if: int, n_af: int) -> tuple[float, float]:
    """(flops, bytes) for the audio polyphase resample + deemphasis.

    Round 4c: both run as shifted MXU matmuls — the resampler re-reads
    its input R_rs times (no frame concat), the deemphasis R_de times.
    """
    rs = getattr(resamp, "resamp", None)
    tpp = getattr(rs, "taps_per_phase", 16)
    rows = 2 * C  # stereo x channels
    ntaps_de = getattr(deemph, "_ntaps", 64) or 64
    r_de = 1 + -(-(ntaps_de - 1) // 128)
    decim = getattr(rs, "decim", max(1, round(n_if / max(n_af, 1))))
    # The matmul path costs R_rs*M = decim+tpp MACs/output; the unrolled
    # path (interp*tpp <= MATMUL_MIN) is ~tpp AXPY MACs/output
    if getattr(rs, "method", "matmul") == "matmul":
        rs_flops = 2.0 * rows * n_af * (decim + tpp)
    else:
        rs_flops = 2.0 * rows * n_af * tpp
    flops = (
        rs_flops
        + 2.0 * rows * n_af * r_de * 128   # deemph banded-Toeplitz
    )
    f32 = 4.0
    # shifted matmul row views overlap almost fully -> ~one read each
    bytes_ = (
        rows * n_if * f32                  # resampler input read
        + rows * n_af * f32                # resampler write
        + 3 * rows * n_af * f32            # deemph read+write+carry
    )
    return flops, bytes_


def spectrum_model(spec, block_len: int) -> tuple[float, float]:
    frames = block_len // spec.interval
    n = spec.fft_size
    flops = fft_flops(n, frames) + 8.0 * frames * n  # window+|.|^2+log
    # input side: extract() SLICES nz samples per frame out of the block
    # already in HBM (keep/skip framing) — the skipped samples are never
    # read, so counting the whole block (round 3) over-stated traffic
    # ~40x at the 64-VFO config (interval 2.5M, nz 65536)
    bytes_ = frames * n * (8 + 8 + 4) + frames * spec.nz_size * 8
    return flops, bytes_


# -- measurement on the card ------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def slope_time(step, state0, k1: int = 8, k2: int = 96, reps: int = 6,
               device="cuda") -> float:
    """Seconds per iteration of ``step(state) -> (state, out)`` from the
    slope between loops of ``k1`` and ``k2`` iterations.

    Each loop starts and ends with a device synchronisation, so the
    difference of the two loop times cancels the fixed cost.  The two
    arms are interleaved (k1, k2, k1, k2, ...) so slow drift hits both;
    the best of ``reps`` of each is taken, and the state threads through
    every loop.  Eager PyTorch cannot hoist loop-invariant work, so the
    reference's salt (a value fed from each output into the next input)
    is not needed.  Where the arms differ by under 12 ms, the slope is
    taken once more with ``k2`` widened so that they differ by ~20 ms.
    """
    dev = resolve_device(device)
    cur = {k1: state0, k2: state0}

    def run(k):
        state = cur[k]
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(k):
            state, _ = step(state)
        _sync(dev)
        cur[k] = state
        return time.perf_counter() - t0

    for k in (k1, k2):  # warm each arm
        run(k)
    best = {k1: float("inf"), k2: float("inf")}
    for _ in range(reps):
        for k in (k1, k2):
            best[k] = min(best[k], run(k))
    t = max((best[k2] - best[k1]) / (k2 - k1), 1e-9)
    if t * (k2 - k1) < 0.012:
        k2w = min(int(k1 + 0.020 / t), 8192)
        if k2w > 2 * k2:
            return slope_time(step, state0, k1=k1, k2=k2w, reps=reps,
                              device=dev)
    return t


def measure_hbm_peak(nbytes: int = 1 << 28, device="cuda",
                     peaks: dict = H100_PEAKS) -> float:
    """Streaming read bandwidth of the card (GB/s), measured.

    Times a full float32 sum over ``nbytes`` (larger than the 50 MB L2,
    so every iteration reads HBM) by the slope method.  A reading above
    `HBM_FAULT_SHARE` of the data sheet's rate is a timer fault and
    raises.  Runs on a CUDA card only: a CPU has no HBM to measure.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_hbm_peak runs on a CUDA card")
    n = nbytes // 4
    x = (torch.arange(n, device=dev) % 1024).to(torch.float32) / 1024.0

    def step(acc):
        return acc + torch.sum(x), None

    t = slope_time(step, torch.zeros((), device=dev), k1=4, k2=52, reps=3,
                   device=dev)
    gbps = n * 4 / t / 1e9
    if gbps > HBM_FAULT_SHARE * peaks["hbm_gbps"]:
        raise RuntimeError(
            f"measure_hbm_peak: {gbps:.1f} GB/s is above {HBM_FAULT_SHARE} x "
            f"the data sheet's {peaks['hbm_gbps']} GB/s: a timer fault")
    return gbps


def profile_flagship(pipe, x, peaks: dict = H100_PEAKS,
                     measured_s_per_block: float | None = None,
                     batch_k: int | None = None) -> dict:
    """Per-stage roofline table for a `WbfmMultiVfoPipeline` block on its
    CUDA card.

    Stages are timed at the granularity the batched pipeline runs them
    (`WbfmMultiVfoPipeline.scan_call`): the channelizer per wideband
    block, the IF-rate back end on a ``batch_k``-block window (per-block
    time = slope / batch_k; default the pipeline's sub-window,
    ``pipe._subk(256)``).  ``pipeline_*`` utilizations use the caller's
    measured end-to-end seconds per block when given, else the summed
    stage times.  The keys are the reference's.
    """
    dev = pipe.device
    if dev.type != "cuda":
        raise ValueError("profile_flagship measures a pipeline on a CUDA "
                         "card; its peaks mean nothing for a CPU")
    block_len = pipe.block_len
    C = pipe.n_channels
    n_if = pipe.channelizer.out_len(block_len)
    n_af = pipe.audio_resamp.out_len(n_if)
    K = int(batch_k) if batch_k else pipe._subk(256)
    xd = torch.as_tensor(np.asarray(x)).to(dev, torch.complex64)
    st0 = pipe.init_state()
    stages = {}

    def add(name, step_fn, state0, model, blocks_per_step: int = 1):
        # one step first: scalar carries become per-channel
        state0, _ = step_fn(state0)
        t = slope_time(step_fn, state0, device=dev) / blocks_per_step
        flops, bytes_ = model
        gflops = flops / t / 1e9
        gbps = bytes_ / t / 1e9
        intensity = flops / bytes_
        balance = peaks["flops_f32"] / (peaks["hbm_gbps"] * 1e9)
        entry = {
            "ms_per_block": round(t * 1e3, 4),
            "gflop_per_s": round(gflops, 1),
            "hbm_gb_per_s": round(gbps, 1),
            "mfu": round(gflops * 1e9 / peaks["flops_f32"], 4),
            "hbm_util": round(gbps / peaks["hbm_gbps"], 4),
            "intensity_flop_per_byte": round(intensity, 2),
            "bound": "compute" if intensity > balance else "memory",
        }
        if entry["hbm_util"] > 1.0 or entry["mfu"] > 1.0:
            entry["unresolved"] = (
                "stage time below timing resolution at this block size; "
                "increase block_len or slope K")
        stages[name] = entry

    with torch.inference_mode():
        _, y = pipe.channelizer(st0["chan"], xd)
        y = y.repeat(1, K)  # (C, K*n_if) steady-state window
        _, (stereo, _) = pipe.demod(st0["demod"], y)

        def chan_step(st):
            return pipe.channelizer(st, xd)

        chain = pipe.channelizer.fused
        if hasattr(chain, "n_chunks"):
            add("channelizer", chan_step, st0["chan"],
                channelizer_model(chain, block_len))
            if not chain._sparse:
                # the fold alone: its traffic is exactly known, a second
                # point to ground the byte models against the measurement
                ext = torch.cat([xd.new_zeros(chain.tpad - 1), xd])
                Fp = chain.poly_spectrum(chain.chunk_matrix(ext,
                                                            chain.n_chunks))
                G = st0["chan"]["fused"]["hf"]

                def fold_step(st):
                    with fp32_contractions():
                        return st, torch.einsum("psk,csk->cpk", Fp, G)

                add("channelizer_fold", fold_step, None, fold_model(chain))
        elif hasattr(chain, "M"):  # PfbChannelizer
            add("channelizer", chan_step, st0["chan"],
                pfb_model(chain, block_len))
        else:
            state, _ = chan_step(st0["chan"])
            stages["channelizer"] = {
                "ms_per_block": round(
                    slope_time(chan_step, state, device=dev) * 1e3, 4),
                "bound": "unmodeled",
            }

        def demod_step(st):
            st, (s, _) = pipe.demod(st, y)
            return st, s

        add("wfm_demod", demod_step, st0["demod"],
            wfm_model(pipe.demod, C, n_if), blocks_per_step=K)

        def audio_step(st):
            s1, a = pipe.audio_resamp(st["rs"], stereo)
            s2, a = pipe.deemph(st["de"], a)
            return {"rs": s1, "de": s2}, a

        add("audio_resamp_deemph", audio_step,
            {"rs": st0["audio"], "de": st0["deemph"]},
            audio_model(pipe.audio_resamp, pipe.deemph, C, n_if, n_af),
            blocks_per_step=K)

        if pipe.spectrum is not None:
            segs = pipe.spectrum.extract(xd).repeat(K, 1)

            def spec_step(st):
                return st, pipe.spectrum.transform(segs)

            add("spectrum", spec_step, None,
                spectrum_model(pipe.spectrum, block_len), blocks_per_step=K)

    total_t = measured_s_per_block if measured_s_per_block else (
        sum(s["ms_per_block"] for name, s in stages.items()
            if name != "channelizer_fold") / 1e3)  # a substage
    models = [wfm_model(pipe.demod, C, n_if),
              audio_model(pipe.audio_resamp, pipe.deemph, C, n_if, n_af)]
    if hasattr(chain, "n_chunks"):
        models.append(channelizer_model(chain, block_len))
    elif hasattr(chain, "M"):
        models.append(pfb_model(chain, block_len))
    if pipe.spectrum is not None:
        models.append(spectrum_model(pipe.spectrum, block_len))
    total_flops = sum(m[0] for m in models)
    total_bytes = sum(m[1] for m in models)
    return {
        "hardware": peaks["name"],
        "device": torch.cuda.get_device_name(dev),
        "peak_f32_tflops": round(peaks["flops_f32"] / 1e12, 1),
        "peak_hbm_gbps": peaks["hbm_gbps"],
        "measured_stream_read_gbps": round(measure_hbm_peak(device=dev,
                                                            peaks=peaks), 1),
        "pipeline_ms_per_block": round(total_t * 1e3, 4),
        "pipeline_time_source": (
            "measured_end_to_end" if measured_s_per_block else "stage_sum"),
        "stages": stages,
        "pipeline_mfu": round(total_flops / total_t / peaks["flops_f32"], 4),
        "pipeline_hbm_util": round(
            total_bytes / total_t / (peaks["hbm_gbps"] * 1e9), 4),
    }
