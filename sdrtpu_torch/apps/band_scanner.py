"""Unattended band scanner: sweep -> stop on activity -> record (the
port's counterpart of ``examples/band_scanner.py``).

A `Scanner` watches the receiver's live spectrum, retunes the receiver's
VFO on activity (`Receiver.retune`: a state-table swap) and a `Recorder`
captures an audio WAV of every hit:

    python -m sdrtpu_torch.apps.band_scanner --input wideband.wav \\
        --start -400000 --stop 400000 --interval 100000 --level -40

``--selftest`` synthesizes a 1 Msps band with two NFM stations among
silent channels and checks that both are found and recorded.
``--device cpu`` runs the same port on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from ..io import wav
from .receiver import IQFrontend, Receiver, VfoConfig
from .recorder import Recorder
from .scanner import Scanner

# the selftest's stations: (offset Hz, tone Hz, on s, off s); station 1
# keys off at 2.5 s so the scanner resumes and finds station 2 (a
# constant carrier would hold the linger forever)
SELFTEST_STATIONS = ((-300_000.0, 700.0, 0.0, 2.5),
                     (200_000.0, 1100.0, 0.0, 6.0))


def selftest_band(fs: float, seconds: float = 6.0) -> np.ndarray:
    """The selftest's band: the two keyed NFM stations and weak noise."""
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex128)
    for f0, tone, t_on, t_off in SELFTEST_STATIONS:
        msg = np.sin(2 * np.pi * tone * t)
        ph = np.cumsum(2 * np.pi * 2500.0 * msg / fs)
        key = ((t >= t_on) & (t < t_off)).astype(float)
        x += 0.4 * key * np.exp(1j * (2 * np.pi * f0 * t + ph))
    x += 0.002 * (np.random.default_rng(0).standard_normal(n)
                  + 1j * np.random.default_rng(1).standard_normal(n))
    return x.astype(np.complex64)


def scan(iq: np.ndarray, fs: float, out_dir: str, start: float, stop: float,
         interval: float, level: float, mode: str = "nfm",
         device="cuda", log=print) -> dict:
    """Scan ``iq`` and record every hit into ``out_dir``; returns the hit
    frequencies, the WAV paths and the receiver's block length."""
    # a fast FFT cadence (one line per 4096 samples) keeps the scan loop
    # responsive and the block quantum near 0.5 s at 1 Msps
    fe = IQFrontend(fs, {"scan": VfoConfig(start, mode)}, spectrum=True,
                    fft_size=4096, fft_rate=fs / 4096, device=device)
    state = {"recorder": None, "hits": [], "paths": [], "rx": None}

    def on_tune(freq):
        if state["rx"] is not None:  # the Scanner tunes once in __init__
            state["rx"].retune("scan", freq)
        if state["recorder"] is not None:
            state["recorder"].close()
            state["recorder"] = None

    scanner = Scanner(start, stop, interval, vfo_bandwidth=25_000.0,
                      level_db=level, linger_time=0.5, tuning_time=0.2,
                      tune_callback=on_tune)

    def on_spectrum(lines):
        dt = 4096 / fs
        was = scanner.receiving
        for line in np.atleast_2d(lines):
            scanner.push_spectrum(line, 0.0, fs, dt)
        if scanner.receiving and state["recorder"] is None:
            path = os.path.join(out_dir, f"hit_{int(scanner.current):+d}Hz.wav")
            state["recorder"] = Recorder(path, 48000, mode="audio")
            state["hits"].append(scanner.current)
            state["paths"].append(path)
            log(f"activity at {scanner.current / 1e3:+.0f} kHz -> {path}")
        elif was and not scanner.receiving and state["recorder"] is not None:
            log(f"closed {state['recorder'].close()}")
            state["recorder"] = None

    def on_audio(a):
        if state["recorder"] is not None:
            state["recorder"].push(a)  # (2, n) audio

    rx = Receiver(fe, audio_sinks={"scan": on_audio},
                  spectrum_sink=on_spectrum)
    state["rx"] = rx
    rx.warmup()
    for i in range(0, len(iq) - rx.block_len + 1, rx.block_len):
        rx.push(iq[i: i + rx.block_len])
    rx.flush()
    if state["recorder"] is not None:
        state["recorder"].close()
    return {"hits": sorted(set(round(h) for h in state["hits"])),
            "paths": state["paths"], "block_len": rx.block_len}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrtpu_torch.apps.band_scanner",
                                 description=__doc__)
    ap.add_argument("--input", help="wideband IQ WAV to scan")
    ap.add_argument("--rate", type=float, default=1_000_000.0)
    ap.add_argument("--start", type=float, default=-400_000.0)
    ap.add_argument("--stop", type=float, default=400_000.0)
    ap.add_argument("--interval", type=float, default=100_000.0)
    ap.add_argument("--level", type=float, default=-40.0)
    ap.add_argument("--mode", default="nfm")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.selftest:
        iq = selftest_band(args.rate)
    else:
        if not args.input:
            ap.error("--input required (or --selftest)")
        info, iq = wav.read_iq_wav(args.input)
        args.rate = float(info.samplerate)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="sdrtpu_scan_")
    res = scan(iq, args.rate, out_dir, args.start, args.stop, args.interval,
               args.level, args.mode, device=args.device)
    hits = res["hits"]
    print(f"scan complete: {len(hits)} active frequencies {hits}", flush=True)
    if not args.selftest:
        return 0
    ok = all(round(f0) in hits for f0, *_ in SELFTEST_STATIONS)
    recs = [f for f in os.listdir(out_dir) if f.endswith(".wav")]
    ok = ok and len(recs) >= 2
    # the recordings' content: stereo 48 kHz frames with audio energy
    for f in recs:
        info, data = wav.read_wav(os.path.join(out_dir, f))
        ok = ok and info.channels == 2 and info.samplerate == 48000
        ok = ok and data.shape[0] > 4800 and float(np.std(data)) > 1e-4
    print("SELFTEST", "OK" if ok else "FAILED", f"recordings={recs}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
