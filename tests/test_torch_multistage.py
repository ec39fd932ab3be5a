"""sdrtpu_torch's `MultistageDecimator` (a cascade of half-band
decimate-by-2 `DecimatingFir` stages) against sdrtpu's.

Tolerances: the half-band taps and the stage plan are the same host
float64 math, so equal; outputs within 2e-6 of the peak (complex64
shift-and-add, the same tap order, float32 rounding of the products);
the carried stage tails within the same bound across blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels.fir import MultistageDecimator as JMD  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.kernels.fir import MultistageDecimator as TMD  # noqa: E402

RNG = np.random.default_rng(21)
TOL = 2e-6


@pytest.mark.parametrize("ratio", [1, 2, 8, 32])
def test_stage_plan_and_taps_equal(ratio):
    j, t = JMD(ratio), TMD(ratio, device="cpu")
    assert len(t.stages) == len(j.stages) == int(np.log2(ratio))
    for a, b in zip(t.stages, j.stages):
        assert a.decimation == b.decimation == 2
        np.testing.assert_array_equal(a.taps, b.taps)
    assert t.out_len(4096) == j.out_len(4096)


@pytest.mark.parametrize("ratio,dtype,block", [
    (8, "complex64", 1024), (4, "float32", 512), (16, "complex64", 2048)])
def test_streams_like_the_reference(ratio, dtype, block):
    """Three blocks from one converted state; output and every stage's
    tail after each block."""
    jd = JMD(ratio, dtype=getattr(jnp, dtype))
    td = TMD(ratio, dtype=getattr(torch, dtype), device="cpu")
    sj = jd.init_state()
    st = state_from_jax(sj, "cpu")
    for _ in range(3):
        x = RNG.standard_normal(block)
        if dtype == "complex64":
            x = x + 1j * RNG.standard_normal(block)
        x = x.astype(dtype)
        sj, yj = jd(sj, jnp.asarray(x))
        st, yt = td(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        assert yt.shape == yj.shape == (block // ratio,)
        np.testing.assert_allclose(yt.numpy(), yj, atol=TOL * np.abs(yj).max())
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=TOL * max(np.abs(b).max(), 1.0))


def test_tone_survives_and_alias_is_rejected():
    n = np.arange(16384)
    op = TMD(8, device="cpu")
    for f, want in ((0.04, "pass"), (0.45, "stop")):
        x = torch.as_tensor(np.exp(2j * np.pi * f * n).astype(np.complex64))
        st, out = op.init_state(), []
        for k in range(4):
            st, y = op(st, x[k * 4096:(k + 1) * 4096])
            out.append(y)
        y = torch.cat(out).abs().numpy()[500:]
        if want == "pass":
            assert y.mean() > 0.95
        else:
            assert y.max() < 1e-3
