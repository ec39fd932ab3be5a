"""A Meteor-M2 LRPT pass as an RTL-SDR records it: the QPSK downlink at
the decoder VFO's offset, looped seamlessly, plus white noise.

- Payload: random 892-byte CVCDUs drawn from the seed, each encoded by
  the plain CCSDS encoder (`sdrbench.reference.ccsds`: RS(255,223) at
  interleave 4, the randomizer, the ASM), back to back; the loop's
  remainder, shorter than a frame, is random fill, drawn again until no
  32 bits that start in it lie within 3 bits of the ASM or of its
  complement (so the deframer, which walks the fill bit by bit, finds
  the next frame's ASM and nothing before it).  The K=7 code runs
  tail-biting over the loop (its register starts with the loop's last
  six bits), so the coded stream repeats without a seam.
- Signal: coded bit pairs as QPSK symbols ``(1 - 2 c0 + i (1 - 2 c1)) /
  sqrt 2`` at the symbol rate, shaped by the root-raised-cosine
  spectrum (the configuration's beta), delayed by ``timing_sym``
  symbols, turned by ``phase_rad``, and moved to the VFO's offset plus
  ``cfo_hz``, all as one spectrum: a circular, band-limited pass whose
  every tone completes whole cycles over the loop.  Its RMS is
  ``amplitude``.
- Noise: complex white noise at ``esn0_db`` (symbol energy over noise
  density: a complex variance of ``amplitude^2 fs / (Rs 10^(esn0/10))``
  a sample), and short impulsive bursts: one in each frame, ``burst_s``
  long, adding white noise at ``burst_esn0_db``, at a place drawn from the
  seed in the frame's middle half (clear of the ASMs, and half a frame at
  least from the next burst, so that no two act on the loops at once).
  White noise alone cannot make the Reed-Solomon decoder correct bytes
  without the Costas loop slipping too (the Viterbi's errors stay rare
  until the SNR is near the slips'), where a pass's impulsive
  interference does: each burst is a short error burst past the Viterbi,
  a byte or a few for RS, and too short to turn the loops.

Everything is made on ``device`` from the seed: NumPy's generator for
the payload, one ``torch.Generator`` for the noise.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrbench.reference import ccsds

TOLERANCE = 3  # the deframer's ASM tolerance, in bits


def payload(cfg: dict, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The loop of ``n`` samples: (CVCDUs (frames, 892) uint8, channel bits
    before the convolutional code, one a symbol)."""
    fs = float(cfg["samplerate"])
    nsym = n * float(cfg["demod"]["symbolrate"]) / fs
    if abs(nsym - round(nsym)) > 1e-6:
        raise ValueError(f"{n} samples hold {nsym} symbols, not a whole "
                         "number")
    nsym = round(nsym)
    frames = nsym // ccsds.FRAME_BITS
    if frames < 1:
        raise ValueError(f"a loop of {nsym} symbols holds no frame")
    rng = np.random.default_rng([int(seed), 0x1A9])
    cvcdus = rng.integers(0, 256, (frames, ccsds.CVCDU_BYTES), dtype=np.uint8)
    body = np.concatenate([ccsds.frame_bits(c) for c in cvcdus])
    nfill = nsym - len(body)
    head = body[:31]
    while True:
        fill = rng.integers(0, 2, nfill, dtype=np.uint8)
        tail = np.concatenate([fill, head])
        if not ccsds.asm_hits(tail[:nfill + 31], TOLERANCE):
            break
    return cvcdus, np.concatenate([body, fill])


def rrc_spectrum(f: torch.Tensor, rs: float, beta: float) -> torch.Tensor:
    """The root-raised-cosine pulse's amplitude response at ``f`` Hz."""
    a = f.abs()
    lo, hi = (1.0 - beta) * rs / 2.0, (1.0 + beta) * rs / 2.0
    roll = torch.sqrt(0.5 * (1.0 + torch.cos(np.pi / (beta * rs) * (a - lo))))
    return torch.where(a <= lo, torch.ones_like(a),
                       torch.where(a < hi, roll, torch.zeros_like(a)))


def make(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    cap, dem = cfg["capture"], cfg["demod"]
    fs, rs = float(cfg["samplerate"]), float(dem["symbolrate"])
    beta = float(dem["rrc_beta"])
    seconds = n / fs
    _, bits = payload(cfg, n, seed)
    coded = torch.as_tensor(ccsds.conv_encode(bits).astype(np.float64),
                            device=device).reshape(-1, 2)
    sym = torch.complex(1.0 - 2.0 * coded[:, 0], 1.0 - 2.0 * coded[:, 1])
    sym = sym / np.sqrt(2.0)
    nsym = sym.shape[0]
    spec = torch.fft.fft(sym)
    del coded, sym
    # the pulse's bins: k / seconds Hz for |f| below (1 + beta) rs / 2
    kmax = int(np.floor((1.0 + beta) * rs / 2.0 * seconds))
    k = torch.arange(-kmax, kmax + 1, device=device)
    f = k.to(torch.float64) / seconds
    shaped = spec[torch.remainder(k, nsym)] * rrc_spectrum(f, rs, beta)
    shaped = shaped * torch.polar(
        torch.ones_like(f), -2.0 * np.pi * f * float(cap["timing_sym"]) / rs)
    del spec
    shift = seconds * (float(cfg["vfos"][0]["offset_hz"])
                       + float(cap["cfo_hz"]))
    if abs(shift - round(shift)) > 1e-6:
        raise ValueError("the VFO offset and the CFO must complete whole "
                         f"cycles over the loop ({shift} cycles)")
    z = torch.zeros(n, dtype=torch.complex128, device=device)
    z[torch.remainder(k + round(shift), n)] = shaped
    del shaped, f, k
    z = torch.fft.ifft(z)
    amp = float(cap["amplitude"])
    z *= amp * np.exp(1j * float(cap["phase_rad"])) / torch.sqrt(
        torch.mean(z.real ** 2 + z.imag ** 2))
    var = amp ** 2 * fs / (rs * 10.0 ** (float(cap["esn0_db"]) / 10.0))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn((2, n), generator=gen, dtype=torch.float32,
                        device=device) * float(np.sqrt(var / 2.0))
    z += torch.complex(noise[0], noise[1])
    del noise
    rng = np.random.default_rng([int(seed), 0xB0057])
    frames = nsym // ccsds.FRAME_BITS
    width = max(1, round(float(cap["burst_s"]) * fs))
    quarter = ccsds.FRAME_BITS / 4.0
    first = (np.arange(frames) * ccsds.FRAME_BITS + quarter
             + rng.uniform(0.0, 2.0 * quarter - float(cap["burst_s"]) * rs,
                           frames))
    start = np.round(first * fs / rs).astype(np.int64)
    at = (start[:, None] + np.arange(width)) % n
    at = torch.as_tensor(at.reshape(-1), device=device)
    bvar = amp ** 2 * fs / (rs * 10.0 ** (float(cap["burst_esn0_db"]) / 10.0))
    burst = torch.randn((2, at.shape[0]), generator=gen, dtype=torch.float32,
                        device=device) * float(np.sqrt(bvar / 2.0))
    z.index_add_(0, at, torch.complex(burst[0], burst[1]).to(z.dtype))
    return z.to(torch.complex64)
