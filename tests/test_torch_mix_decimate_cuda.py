"""K2's CUDA kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_mix_decimate_cuda.py -q --noconftest

Tolerance: 1e-5 of the plain version's peak.  Both take the same float32
tables and products; the kernel sums the T taps directly in fp32 FFMA
while the plain version runs the banded-Toeplitz matmuls (TF32 off), so
the sums run in another order.  Shapes: the three of
tests/test_pallas_channelizer.py, the 8-VFO flagship block, M=2 with its
most taps, one tap (no tail), an odd channel count and a block whose
last output tile is ragged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import fused_channelizer as tfc  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("C,M,T,n", [
    (4, 8, 36, 65536),
    (4, 4, 20, 65536),
    (2, 8, 36, 65536 + 40000),
    (8, 8, 36, 500000),
    (3, 2, 34, 3000),
    (5, 8, 1, 8 * 1000),
    (1, 4, 36, 4 * 300),
])
def test_mix_decimate_cuda_kernel_matches_plain(C, M, T, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    offs = rng.uniform(-4.5e6, 4.5e6, C)
    h = rng.standard_normal(T).astype(np.float32)
    stage = tfc.FusedChannelizerStage(offs, 10e6, h / np.abs(h).sum(), M, n,
                                      device="cuda")
    tail = torch.as_tensor((rng.standard_normal(T - 1)
                            + 1j * rng.standard_normal(T - 1)).astype(
                                np.complex64), device="cuda")
    x = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                         ).astype(np.complex64), device="cuda")
    phase = torch.as_tensor(rng.uniform(0, 6.28, C).astype(np.float32),
                            device="cuda")
    args = (tail, x, stage._coarse, stage._fine, stage._taps, phase, M)
    before = tfc.mix_decimate.launches
    got = tfc.mix_decimate(*args)
    torch.cuda.synchronize()
    assert tfc.mix_decimate.launches == before + 1
    want = tfc.mix_decimate_ref(*args)
    assert got.shape == want.shape == (C, n // M)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
