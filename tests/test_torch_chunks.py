"""K1, the overlap-save chunk builder: sdrtpu_torch against sdrtpu.

``ct[p, s, q] = ext[p*valid + q*R + s]`` (0 past the end of ext) is pure
data movement, so every comparison is exact.  On the CPU the port's
wrapper runs its plain version; it is held against the Pallas kernel in
interpret mode and against the loop definition `ref_chunks`, at the
three plan shapes of tests/test_pallas_chunks.py.  The CUDA kernel is
held against the plain version on the card in
tests/test_torch_chunks_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels.pallas_chunks import chunk_poly as jchunk_poly  # noqa: E402
from sdrtpu.kernels.pallas_chunks import choose_group  # noqa: E402
from sdrtpu_torch.kernels import chunks  # noqa: E402

RNG = np.random.default_rng(11)

SHAPES = [
    (1600, 8, 256, 10),    # large tile
    (4000, 40, 128, 10),   # the 8-VFO plan geometry
    (25600, 200, 128, 5),  # the 64-VFO plan geometry
]


def ref_chunks(ext, valid, R, nif, P):
    need = (P - 1) * valid + R * nif
    ext = np.pad(ext, (0, max(0, need - len(ext))))
    ct = np.zeros((P, R, nif), ext.dtype)
    for p in range(P):
        for s in range(R):
            ct[p, s] = ext[p * valid + s : p * valid + s + R * nif : R]
    return ct


def _ext(L):
    return (RNG.standard_normal(L) + 1j * RNG.standard_normal(L)).astype(
        np.complex64)


@pytest.mark.parametrize("valid,R,nif,P", SHAPES)
def test_chunk_poly_matches_pallas_and_definition(valid, R, nif, P):
    L = (P - 1) * valid + R * nif
    ext = _ext(L)
    o_re, o_im = jchunk_poly(
        jnp.asarray(ext.real), jnp.asarray(ext.imag), valid=valid, ratio=R,
        nif=nif, n_chunks=P, group=choose_group(P, valid, R, nif),
        interpret=True)
    pallas = np.asarray(o_re) + 1j * np.asarray(o_im)
    before = chunks.chunk_poly.launches
    got = chunks.chunk_poly(torch.as_tensor(ext), valid, R, nif, P)
    assert chunks.chunk_poly.launches == before  # the plain version ran
    assert got.dtype == torch.complex64 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), ref_chunks(ext, valid, R, nif, P))


@pytest.mark.parametrize("valid,R,nif,P,L", [
    (4000, 40, 128, 3, 8500),   # ragged end: samples past L read as zero
    (160, 8, 40, 4, 800),       # the 2 Msps test plan
    (160, 8, 64, 4, 1000),      # nif > 2*valid/R: past the Pallas limit
])
def test_chunk_poly_short_ext_and_wide_windows(valid, R, nif, P, L):
    ext = _ext(L)
    got = chunks.chunk_poly(torch.as_tensor(ext), valid, R, nif, P)
    np.testing.assert_array_equal(got.numpy(), ref_chunks(ext, valid, R, nif, P))


def test_chunk_poly_refuses_other_devices():
    ext = torch.zeros(100, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        chunks.chunk_poly(ext, 20, 4, 5, 2)

