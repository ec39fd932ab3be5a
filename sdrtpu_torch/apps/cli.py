"""Command-line receiver: IQ WAV in -> demodulated audio WAV out.

PyTorch counterpart of ``sdrtpu/apps/cli.py``, with the same flags plus
``--device``:

    python -m sdrtpu_torch.apps.cli --input baseband_98500000Hz.wav \
        --mode wfm --offset 0 --output audio.wav [--squelch -50] ...

runs on the card; ``--device cpu`` runs the same port on the CPU.

Multiple VFOs: repeat --vfo NAME:OFFSET:MODE[:BANDWIDTH]; each gets its own
output file ``<output-stem>_<NAME>.wav``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import wav
from .receiver import IQFrontend, Receiver, VfoConfig


def parse_vfo(spec: str) -> tuple[str, VfoConfig]:
    parts = spec.split(":")
    if len(parts) < 3:
        raise argparse.ArgumentTypeError("--vfo NAME:OFFSET:MODE[:BANDWIDTH]")
    name, offset, mode = parts[0], float(parts[1]), parts[2]
    bw = float(parts[3]) if len(parts) > 3 else None
    return name, VfoConfig(offset_hz=offset, mode=mode, bandwidth=bw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrtpu_torch", description=__doc__)
    ap.add_argument("--input", required=True, help="IQ WAV recording")
    ap.add_argument("--output", default="audio.wav", help="audio WAV out")
    ap.add_argument("--mode", default="wfm",
                    choices=["wfm", "nfm", "am", "usb", "lsb", "dsb", "cw",
                             "raw"])
    ap.add_argument("--offset", type=float, default=0.0,
                    help="VFO offset from capture center (Hz)")
    ap.add_argument("--bandwidth", type=float, default=None)
    ap.add_argument("--squelch", type=float, default=None, help="squelch dB")
    ap.add_argument("--mono", action="store_true", help="disable WFM stereo")
    ap.add_argument("--audio-rate", type=float, default=48000.0)
    ap.add_argument("--vfo", action="append", default=[],
                    help="extra VFO as NAME:OFFSET:MODE[:BANDWIDTH]")
    ap.add_argument("--no-spectrum", action="store_true")
    ap.add_argument("--block-len", type=int, default=None)
    ap.add_argument("--low-latency", action="store_true",
                    help="small-block operating point: ~5 ms blocks "
                         "(samplerate/200, the reference's source block "
                         "convention) instead of the throughput-tuned "
                         "default")
    ap.add_argument("--fft-size", type=int, default=65536)
    ap.add_argument("--fft-rate", type=float, default=20.0)
    ap.add_argument("--spectrum-out", default=None,
                    help="write waterfall dB frames to this .npy")
    ap.add_argument("--waterfall-png", default=None,
                    help="render the waterfall to this PNG")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    ap.add_argument("--config", default=None,
                    help="JSON receiver config (ConfigManager format); CLI "
                         "flags override its values")
    args = ap.parse_args(argv)

    if args.config:
        from .config import ConfigManager

        conf = ConfigManager(args.config).load(save_if_changed=False)
        for key in ("mode", "offset", "bandwidth", "squelch", "audio_rate",
                    "fft_size", "fft_rate", "block_len"):
            if key in conf and ap.get_default(key.replace("-", "_")) == getattr(args, key.replace("-", "_")):
                setattr(args, key.replace("-", "_"), conf[key])
        for name, v in conf.get("vfos", {}).items():
            args.vfo.append(f"{name}:{v['offset']}:{v['mode']}" +
                            (f":{v['bandwidth']}" if v.get("bandwidth") else ""))

    info, iq = wav.read_iq_wav(args.input)
    print(f"input: {args.input}: {info.samplerate} S/s, "
          f"{info.frames} samples ({info.frames/info.samplerate:.1f} s)",
          file=sys.stderr)

    vfos = {"main": VfoConfig(args.offset, args.mode, args.bandwidth,
                              args.squelch, stereo=not args.mono)}
    for spec in args.vfo:
        name, cfg = parse_vfo(spec)
        vfos[name] = cfg

    fe = IQFrontend(
        info.samplerate,
        vfos,
        audio_rate=args.audio_rate,
        spectrum=not args.no_spectrum,
        fft_size=args.fft_size,
        fft_rate=args.fft_rate,
        device=args.device,
    )

    block_len = args.block_len
    if args.low_latency and block_len is None:
        m = fe.block_multiple()
        block_len = max(1, round(info.samplerate / 200.0 / m)) * m

    audio_bufs = {n: [] for n in vfos}
    spec_frames = []
    rx = Receiver(
        fe,
        block_len=block_len,
        audio_sinks={n: audio_bufs[n].append for n in vfos},
        spectrum_sink=(spec_frames.append if not args.no_spectrum else None),
    )
    rx.push(iq)
    rx.flush()

    stem = args.output[:-4] if args.output.endswith(".wav") else args.output
    for name, chunks in audio_bufs.items():
        if not chunks:
            print(f"warning: no audio for VFO {name} "
                  f"(input shorter than one block of {rx.block_len}?)",
                  file=sys.stderr)
            continue
        audio = np.concatenate(chunks, axis=-1)
        path = args.output if len(vfos) == 1 else f"{stem}_{name}.wav"
        wav.write_wav(path, int(args.audio_rate), audio.T, "int16")
        print(f"wrote {path}: {audio.shape[-1]} frames", file=sys.stderr)
    if args.spectrum_out and spec_frames:
        np.save(args.spectrum_out, np.concatenate(spec_frames, axis=0))
        print(f"wrote {args.spectrum_out}", file=sys.stderr)
    if args.waterfall_png and spec_frames:
        from .waterfall import save_waterfall_png

        save_waterfall_png(args.waterfall_png,
                           np.concatenate(spec_frames, axis=0))
        print(f"wrote {args.waterfall_png}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
