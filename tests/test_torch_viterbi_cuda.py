"""The Viterbi decoder kernel against its plain PyTorch loop, on the
card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_viterbi_cuda.py -q --noconftest

Tolerance: none.  Branch metrics are one rounded sum of two exact
products, candidates one rounded add, the pick the first maximum and the
normalisation one rounded subtract, in the kernel and in the plain loop:
bits and final metrics are equal (``torch.equal``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.fec import viterbi as tv  # noqa: E402


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("K,polys,rows,n,noise", [
    (7, (0o171, 0o133), 1, 3000, 0.6), (7, (0o171, 0o133), 2, 2500, 0.8),
    (5, (0o27, 0o31), 1, 2000, 0.6), (7, (0o171, 0o133), 1, 1025, 0.0)])
def test_viterbi_kernel_matches_plain(K, polys, rows, n, noise):
    _need_card()
    rng = np.random.default_rng(7)
    enc, dec = tv.ConvEncoder(K, polys), tv.ViterbiDecoder(K, polys,
                                                           device="cuda")
    bits = rng.integers(0, 2, (rows, n)).astype(np.uint8)
    soft = np.stack([enc.encode_to_soft(b) for b in bits])
    soft = (soft + noise * rng.standard_normal(soft.shape)).astype(np.float32)
    sym = torch.as_tensor(soft.reshape(rows, n, 2), device="cuda")
    args = (sym, dec.exp_prev, dec.prev, dec.prev_bit)
    before = tv.viterbi_decode.launches
    got_bits, got_m = tv.viterbi_decode(*args)
    torch.cuda.synchronize()
    assert tv.viterbi_decode.launches == before + 1
    want_bits, want_m = tv.viterbi_decode_ref(*args)
    assert torch.equal(got_bits, want_bits)
    assert torch.equal(got_m, want_m)
    if noise == 0.0:
        assert np.array_equal(got_bits.cpu().numpy(), bits)


@pytest.mark.cuda
def test_viterbi_kernel_refuses_what_it_cannot_decode():
    _need_card()
    dec = tv.ViterbiDecoder(3, (0o7, 0o5, 0o3), device="cuda")  # rate 1/3
    sym = torch.zeros((1, 10, 3), device="cuda")
    with pytest.raises(ValueError):
        tv.viterbi_decode(sym, dec.exp_prev, dec.prev, dec.prev_bit)
