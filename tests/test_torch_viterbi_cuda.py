"""The Viterbi decoder kernel against its plain PyTorch loop, on the
card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_viterbi_cuda.py -q --noconftest

Tolerance: none.  Branch metrics are the R exact products summed in r
order with each add rounded, candidates one rounded add, the pick the
first maximum and the normalisation one rounded subtract, in the kernel
and in the plain loop: bits and final metrics are equal to the bit,
at rates 1/2, 1/3 and 1/4, K from 3 to 7, on random float soft
symbols.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.fec import viterbi as tv  # noqa: E402


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


DAB = (0o133, 0o171, 0o145, 0o133)


K3 = {2: (0o7, 0o5), 3: (0o5, 0o7, 0o7), 4: (0o5, 0o7, 0o7, 0o5)}
K5 = {3: (0o25, 0o33, 0o37), 4: (0o25, 0o27, 0o33, 0o37)}


# K in {3, 5, 7} x R in {2, 3, 4}, n in {1, 1023, 1025, 88 448} (the
# meteor path's longest launch; the plain version on the CPU there),
# rows in {1, 2, 4}; the traceback's chunks are ceil(n / 32) steps
@pytest.mark.cuda
@pytest.mark.parametrize("K,polys,rows,n,noise", [
    (7, (0o171, 0o133), 1, 3000, 0.6), (7, (0o171, 0o133), 2, 2500, 0.8),
    (5, (0o27, 0o31), 1, 2000, 0.6), (7, (0o171, 0o133), 1, 1025, 0.0),
    (7, DAB, 1, 3000, 0.8), (7, DAB, 4, 774, 1.0), (5, DAB, 1, 2000, 0.8),
    (7, DAB[:3], 2, 1500, 0.7), (5, DAB[:3], 1, 2100, 0.7),
    (7, DAB, 1, 1025, 0.0),
    (3, K3[2], 1, 1, 0.8), (3, K3[2], 4, 1023, 0.8), (3, K3[3], 2, 1025, 0.8),
    (3, K3[4], 1, 1023, 0.8), (5, (0o27, 0o31), 4, 1025, 0.8),
    (5, K5[3], 1, 1, 0.8), (5, K5[3], 2, 1023, 0.8), (5, K5[4], 4, 1025, 0.8),
    (7, (0o171, 0o133), 4, 1, 0.8), (7, DAB[:3], 1, 1023, 0.8),
    (7, DAB, 2, 1, 0.8),
    (7, (0o171, 0o133), 1, 88_448, 0.7), (7, (0o171, 0o133), 4, 88_448, 0.9),
    (5, K5[4], 2, 88_448, 0.8), (3, K3[3], 1, 88_448, 0.8)])
def test_viterbi_kernel_matches_plain(K, polys, rows, n, noise):
    _need_card()
    rng = np.random.default_rng(7)
    R = len(polys)
    enc, dec = tv.ConvEncoder(K, polys), tv.ViterbiDecoder(K, polys,
                                                           device="cuda")
    bits = rng.integers(0, 2, (rows, n)).astype(np.uint8)
    soft = np.stack([enc.encode_to_soft(b) for b in bits])
    soft = (soft + noise * rng.standard_normal(soft.shape)).astype(np.float32)
    sym = torch.as_tensor(soft.reshape(rows, n, R), device="cuda")
    args = (sym, dec.exp_prev, dec.prev, dec.prev_bit)
    before = tv.viterbi_decode.launches
    got_bits, got_m = tv.viterbi_decode(*args)
    torch.cuda.synchronize()
    assert tv.viterbi_decode.launches == before + 1
    # the plain version on the card, or on the CPU (faster) at 88 448
    want_bits, want_m = tv.viterbi_decode_ref(
        sym if n < 50_000 else sym.cpu(), *args[1:])
    assert torch.equal(got_bits.cpu(), want_bits.cpu())
    # the metrics to the bit
    assert torch.equal(got_m.cpu().view(torch.int32),
                       want_m.cpu().view(torch.int32))
    if noise == 0.0:
        assert np.array_equal(got_bits.cpu().numpy(), bits)


@pytest.mark.cuda
def test_viterbi_kernel_refuses_what_it_cannot_decode():
    """Rate 1/5 and K = 8 are beyond the kernel."""
    _need_card()
    dec = tv.ViterbiDecoder(3, (0o7, 0o5, 0o3, 0o6, 0o4), device="cuda")
    sym = torch.zeros((1, 10, 5), device="cuda")
    with pytest.raises(ValueError):
        tv.viterbi_decode(sym, dec.exp_prev, dec.prev, dec.prev_bit)
    dec = tv.ViterbiDecoder(8, (0o371, 0o233), device="cuda")
    sym = torch.zeros((1, 10, 2), device="cuda")
    with pytest.raises(ValueError):
        tv.viterbi_decode(sym, dec.exp_prev, dec.prev, dec.prev_bit)


@pytest.mark.cuda
def test_dab_fic_decodes_with_one_launch_a_frame():
    """`DabDemodulator.decode_fic` on the card: the four codewords are
    the four rows of one launch, and the bits equal the CPU's."""
    _need_card()
    from sdrtpu_torch.decoders import dab

    fibs = np.stack([dab.build_fib([dab.make_fig_1_1(0xC0DE, "ON CARD")])]
                    * dab.FIBS_PER_FRAME)
    dibits = dab.DabModulator().fic_to_symbols(fibs)
    before = tv.viterbi_decode.launches
    got, ok = dab.DabDemodulator(device="cuda").decode_fic(
        torch.as_tensor(dibits, device="cuda"))
    assert tv.viterbi_decode.launches == before + 1
    want, _ = dab.DabDemodulator(device="cpu").decode_fic(dibits)
    assert ok.all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fibs)
