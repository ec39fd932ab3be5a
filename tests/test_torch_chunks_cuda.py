"""K1's CUDA kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_chunks_cuda.py -q --noconftest

Tolerance: exact (the kernel only moves data).  Shapes: the three plan
shapes of tests/test_pallas_chunks.py, the 8-VFO flagship's 4M-sample
sub-window (P=1000), the 64-VFO plan's block (P=125) and a window
wider than two chunk strides; each ``ext``
ends 7 samples short of the last chunk, so the kernel's zero fill runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import chunks  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("valid,R,nif,P", [
    (1600, 8, 256, 10),
    (4000, 40, 128, 10),
    (25600, 200, 128, 5),
    (4000, 40, 128, 1000),
    (20000, 200, 128, 125),
    (160, 8, 64, 4),  # nif > 2*valid/R: past the Pallas kernel's limit
])
def test_chunk_poly_cuda_kernel_matches_plain(valid, R, nif, P):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(11)
    L = (P - 1) * valid + R * nif - 7
    ext = torch.as_tensor(
        (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(
            np.complex64), device="cuda")
    before = chunks.chunk_poly.launches
    got = chunks.chunk_poly(ext, valid, R, nif, P)
    torch.cuda.synchronize()
    assert chunks.chunk_poly.launches == before + 1
    assert torch.equal(got, chunks.chunk_poly_ref(ext, valid, R, nif, P))
