"""The Meteor-M2 LRPT decoder VFO on the card against the same port on
the CPU, at the benchmark cell's shapes (``meteor_lrpt_2m4``: 2.4 Msps,
the VFO at +300 kHz, 1 s blocks): two blocks of the seeded pass
(`sdrbench.captures.lrpt_pass`) through an `IQFrontend` with the decoder
VFO and its deframer on each device.

And the decoder VFO's `MeteorDemod`, whose Costas and M&M scans run as
one `costas_mm_scan` launch, against the same module's stages one after
another (RRC, FastAGC, `MeteorCostas`, `MuellerMuller`: two launches),
over three blocks of the pass after the VFO's DDC on the card: symbols,
valid mask and every state leaf equal to the bit.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_lrpt_vfo_cuda.py -q --noconftest

(~2 min: the CPU side runs the Costas and M&M scans' plain loops).

Tolerance.  Frames: equal, byte for byte, none failing RS.  Symbols: the
card's DDC (`decim_fir`) and matched filter sum in another order than
the CPU's convolutions, so the samples into the loops differ in the last
bits; the scans are bit-equal on equal inputs, but M&M's 128-phase
interpolator turns a timing difference of a few 1e-7 into the
neighbouring phase for a few symbols (each off by at most ~0.03, the
phase step times the signal's slope), while the rest agree to float32
rounding.  So: the median absolute gap below 1e-5, at least 90 % of the
symbols within 1e-4, none beyond 0.1, and the counts equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrbench.captures import lrpt_pass  # noqa: E402
from sdrtpu_torch.apps.receiver import (  # noqa: E402
    IQFrontend, Receiver, Vfo, VfoConfig)

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 1013
BLOCKS = 2


def run(cfg, x, device):
    v = cfg["vfos"][0]
    fe = IQFrontend(cfg["samplerate"], {v["name"]: VfoConfig(
        v["offset_hz"], v["mode"], v["bandwidth_hz"])},
        fft_size=cfg["fft_size"], fft_rate=cfg["fft_rate"], device=device)
    rx = Receiver(fe, block_len=cfg["block_len"])
    deframer = rx.deframers[v["name"]]
    st, syms, frames = fe.init_state(), [], []
    with torch.inference_mode():
        for block in x:
            st, (outs, _) = fe(st, block.to(device))
            s, n = outs[v["name"]]
            s = s[:int(n)]
            frames += deframer.process(s)
            syms.append(s.cpu().numpy())
    return syms, frames, deframer.counters


@pytest.mark.cuda
def test_decoder_vfo_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = json.loads((ROOT / "sdrbench/configs/meteor_lrpt_2m4.json")
                     .read_text())
    n = 4 * cfg["block_len"]  # a 4 s loop; its first two blocks
    x = lrpt_pass.make(cfg, n, SEED, "cuda").reshape(4, -1)[:BLOCKS].cpu()
    gpu = run(cfg, x, "cuda")
    cpu = run(cfg, x, "cpu")
    for g, c in zip(gpu[0], cpu[0]):
        assert g.shape == c.shape
        d = np.abs(g.astype(np.complex128) - c)
        print(f"symbols {len(d)}: median {np.median(d):.3g}, "
              f"90% {np.quantile(d, 0.9):.3g}, max {d.max():.3g}")
        assert np.median(d) < 1e-5
        assert np.quantile(d, 0.9) < 1e-4
        assert d.max() < 0.1
    assert len(gpu[1]) == len(cpu[1]) >= 8
    for a, b in zip(gpu[1], cpu[1]):
        assert np.array_equal(a, b)
    assert gpu[2]["rs_failures"] == cpu[2]["rs_failures"] == 0
    assert gpu[2]["frames"] == cpu[2]["frames"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same_bits(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.cuda
def test_meteor_demod_with_its_loops_in_one_launch_equals_its_stages():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = json.loads((ROOT / "sdrbench/configs/meteor_lrpt_2m4.json")
                     .read_text())
    v = cfg["vfos"][0]
    x = lrpt_pass.make(cfg, 4 * cfg["block_len"], SEED,
                       "cuda").reshape(4, -1)[:3]
    vfo = Vfo(VfoConfig(v["offset_hz"], v["mode"], v["bandwidth_hz"]),
              cfg["samplerate"], 48_000.0, device="cuda")
    d = vfo.radio
    st = vfo.init_state()
    xl, ddc, fused, split = st["xl"], st["ddc"], st["radio"], st["radio"]
    with torch.inference_mode():
        for block in x:
            xl, y = vfo.xlator(xl, block)
            ddc, y = vfo.ddc(ddc, y)
            fused, (syms, valid) = d(fused, y)
            s = dict(split)
            s["rrc"], z = d.rrc(split["rrc"], y)
            s["agc"], z = d.agc(split["agc"], z)
            s["costas"], z = d.costas(split["costas"], z)
            s["mm"], (syms2, valid2) = d.recov(split["mm"], z)
            split = s
            assert int(valid.sum()) == int(valid2.sum()) > 70_000
            assert _same_bits(syms, syms2) and _same_bits(valid, valid2)
            assert fused.keys() == split.keys()
            for k in fused:
                assert all(_same_bits(a, b) for a, b in zip(
                    _leaves(fused[k]), _leaves(split[k]))), k
