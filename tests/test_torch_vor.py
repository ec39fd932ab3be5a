"""sdrtpu_torch's VOR receiver against sdrtpu's.

Tolerance: the bearing within 0.01 degree of the JAX package's (both
form the DFT bins' phase in float32 and sum 25 000 products in their
own order), the amplitude within 1e-4 relative; the carried state (the
band-pass tail, the discriminator's previous sample) streams across
blocks from one converted state, within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders import vor as jv  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.decoders import vor as tv  # noqa: E402

FS = 25000.0
BEARING_TOL = 0.01  # degrees


def _ang_err(a, b):
    d = abs(a - b) % 360.0
    return min(d, 360.0 - d)


def test_synthesis_equal():
    np.testing.assert_array_equal(tv.synthesize_vor(137.5, FS, 0.5),
                                  jv.synthesize_vor(137.5, FS, 0.5))


@pytest.mark.parametrize("bearing", [0.0, 45.0, 137.5, 270.0, 359.0])
def test_bearing_streams_like_the_reference(bearing):
    """Two 1 s blocks from one state: the same bearing and amplitude on
    each, the same carried state; the bearing is the one sent."""
    x = tv.synthesize_vor(bearing, FS, seconds=2.0)
    jr, tr = jv.VorReceiver(FS), tv.VorReceiver(FS, device="cpu")
    np.testing.assert_array_equal(tr.sub_bpf.taps, jr.sub_bpf.taps)
    sj = jr.init_state()
    st = state_from_jax(sj, "cpu")
    n = int(FS)
    for b in range(2):
        blk = x[b * n:(b + 1) * n]
        sj, (dj, aj) = jr(sj, jnp.asarray(blk))
        st, (dt, at) = tr(st, torch.as_tensor(blk))
        assert _ang_err(float(dt), float(dj)) < BEARING_TOL
        np.testing.assert_allclose(float(at), float(aj), rtol=1e-4)
        np.testing.assert_allclose(st["bpf"].numpy(), np.asarray(sj["bpf"]),
                                   atol=1e-6)
        np.testing.assert_allclose(st["fm"].numpy(), np.asarray(sj["fm"]),
                                   atol=1e-6)
    assert _ang_err(float(dt), bearing) < 2.0


def test_noise_and_rows():
    """AWGN at the reference test's level, two receivers' worth of rows
    at once: each row's bearing as the reference's for that row."""
    rng = np.random.default_rng(0)
    rows = np.stack([tv.synthesize_vor(b, FS, 1.0) for b in (200.0, 15.0)])
    rows = rows + 0.2 * (rng.standard_normal(rows.shape)
                         + 1j * rng.standard_normal(rows.shape)).astype(
                             np.complex64)
    jr, tr = jv.VorReceiver(FS), tv.VorReceiver(FS, device="cpu")
    _, (dj, _) = jr(jr.init_state(), jnp.asarray(rows))
    _, (dt, _) = tr(tr.init_state(), torch.as_tensor(rows))
    for k in range(2):
        assert _ang_err(float(dt[k]), float(dj[k])) < BEARING_TOL
    assert _ang_err(float(dt[0]), 200.0) < 5.0
