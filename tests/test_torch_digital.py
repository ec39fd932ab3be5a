"""sdrtpu_torch's bit-level primitives against sdrtpu's (CPU).

Tolerance: none; slicing, differential decoding and Manchester
decimation are exact on bits.  The differential decoder streams over
three blocks, its carry handed over through ``convert``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import digital as jd  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.kernels import digital as td  # noqa: E402

RNG = np.random.default_rng(81)


def test_binary_slice():
    x = RNG.standard_normal(257).astype(np.float32)
    x[:3] = (0.0, -0.0, 1e-30)
    got = td.binary_slice(torch.as_tensor(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jd.binary_slice(jnp.asarray(x))))


@pytest.mark.parametrize("modulus", [2, 4])
def test_differential_decoder_streams(modulus):
    x = RNG.integers(0, modulus, 300).astype(np.uint8)
    jdd = jd.DifferentialDecoder(modulus)
    tdd = td.DifferentialDecoder(modulus, device="cpu")
    sj = jdd.init_state()
    st = state_from_jax(sj, "cpu")
    for blk in (x[:100], x[100:170], x[170:]):
        sj, yj = jdd(sj, jnp.asarray(blk))
        st, yt = tdd(st, torch.as_tensor(blk))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert int(st) == int(sj)
        st = state_from_jax(state_to_numpy(st), "cpu")


def test_manchester_decoder():
    x = RNG.standard_normal((3, 40)).astype(np.float32)
    jm, tm = jd.ManchesterDecoder(), td.ManchesterDecoder()
    assert tm.out_len(40) == jm.out_len(40) == 20
    _, yj = jm(jm.init_state(), jnp.asarray(x))
    _, yt = tm(tm.init_state(), torch.as_tensor(x))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
