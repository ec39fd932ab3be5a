"""K2's CUDA kernel against its plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_mix_decimate_cuda.py -q --noconftest

Tolerance: 1e-5 of the plain version's peak, against `mix_decimate_ref`
(the reference's per-sample rotation and banded-Toeplitz matmuls, TF32
off) and against `mix_decimate_modulated_ref` (the kernel's own
arithmetic).  All take the same float32 tables; the kernel rotates once
per output with three table factors instead of two and sums the T taps
directly in fp32 FFMA, so the roundings and the order of the sums
differ.  Shapes: the three of tests/test_pallas_channelizer.py, the
8-VFO flagship block, M=2 with its most taps, one tap (no tail), an odd
channel count, a block whose last output tile is ragged, 64 channels
and 9 (a ragged channel group), fewer outputs than one tile and an
exact multiple of the tile, the most taps M=8 takes, M=4 with 36 taps,
a carried phase within 1e-3 of 2*pi, and a 2.5 M-sample block at the
band edges (offsets +-0.45 fs), where a phase error would have grown.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import fused_channelizer as tfc  # noqa: E402

FS = 10e6


@pytest.mark.cuda
@pytest.mark.parametrize("C,M,T,n,case", [
    (4, 8, 36, 65536, ""),
    (4, 4, 20, 65536, ""),
    (2, 8, 36, 65536 + 40000, ""),
    (8, 8, 36, 500000, ""),
    (3, 2, 34, 3000, ""),
    (5, 8, 1, 8 * 1000, ""),
    (1, 4, 36, 4 * 300, ""),
    (64, 8, 31, 200000, ""),
    (9, 8, 36, 100000, ""),
    (3, 8, 36, 8 * 100, ""),            # fewer outputs than one tile
    (2, 8, 36, 8 * 256 * 132 * 2, ""),  # whole tiles on a 132-SM card
    (4, 8, 40, 65536, ""),
    (4, 4, 36, 65536, ""),
    (4, 8, 36, 65536, "phase near 2 pi"),
    (2, 8, 36, 2_500_000, "band edge"),
])
def test_mix_decimate_cuda_kernel_matches_plain(C, M, T, n, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    offs = rng.uniform(-4.5e6, 4.5e6, C)
    if case == "band edge":
        offs = np.array([-0.45 * FS, 0.45 * FS])
    h = rng.standard_normal(T).astype(np.float32)
    stage = tfc.FusedChannelizerStage(offs, FS, h / np.abs(h).sum(), M, n,
                                      device="cuda")
    tail = torch.as_tensor((rng.standard_normal(T - 1)
                            + 1j * rng.standard_normal(T - 1)).astype(
                                np.complex64), device="cuda")
    x = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                         ).astype(np.complex64), device="cuda")
    phase = rng.uniform(0, 6.28, C)
    if case:
        phase = 2 * np.pi - rng.uniform(0, 1e-3, C)
    phase = torch.as_tensor(phase.astype(np.float32), device="cuda")
    args = (tail, x, stage._coarse, stage._fine, stage._taps, phase, M)
    before = tfc.mix_decimate.launches
    got = tfc.mix_decimate(*args)
    torch.cuda.synchronize()
    assert tfc.mix_decimate.launches == before + 1
    want = tfc.mix_decimate_ref(*args)
    assert got.shape == want.shape == (C, n // M)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    modulated = tfc.mix_decimate_modulated_ref(*args)
    assert (got - modulated).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_launch_plan_fills_the_card_in_one_wave():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the plan reads the card's SMs")
    for C, n, T in ((8, 500_000, 36), (64, 2_500_000, 31)):
        plan = tfc.launch_plan(n, C, 8, T)
        assert plan["sms"] == torch.cuda.get_device_properties(
            0).multi_processor_count
        assert plan["ctas"] == plan["ranges"] * plan["channel_groups"]
        assert plan["channel_groups"] == -(-C // 8)
        assert 0.9 <= plan["ctas_per_sm"] <= plan["resident_ctas_per_sm"]
        assert plan["waves"] <= 1.0
