"""The arithmetic of K2's CUDA kernel, proven on the CPU.

The kernel moves the rotation from the input samples to the outputs:
``y_c[j] = rot_c(jM) * sum_t ext[jM + t] * g_c[t]`` with modulated taps
``g_c[t] = h[t] * fine_c[t]``.  `mix_decimate_modulated_ref` states that
in float32 PyTorch.  The same seeded numpy inputs go through

(a) sdrtpu's Pallas stage with ``interpret=True``, as
    tests/test_pallas_channelizer.py runs it,
(b) `mix_decimate_ref`, the per-sample rotation and Toeplitz matmuls,
(c) the modulated form,

and all three agree within 1e-5 of the peak: the forms take the same
float32 tables, (c) carries one more table factor (three instead of
two) and sums in another order.  The long band-edge block (offsets
+-0.45 fs, 2.5 M samples, a carried phase near 2*pi) holds (c) against
(b) only, to keep the interpret-mode run short; it is where a phase
error of the identity would have grown largest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import pallas_channelizer as jpc  # noqa: E402
from sdrtpu_torch.kernels import fused_channelizer as tfc  # noqa: E402

FS = 10e6
REL_TOL = 1e-5


def _inputs(seed, C, T, n, band=0.45):
    rng = np.random.default_rng(seed)
    offs = rng.uniform(-band * FS, band * FS, C)
    h = rng.standard_normal(T).astype(np.float32)
    return rng, offs, h / np.abs(h).sum()


def _signal(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _close(got, want, what):
    peak = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= REL_TOL * peak, f"{what}: max_abs_err {err}, peak {peak}"


@pytest.mark.parametrize("C,M,T,n,blocks", [
    (4, 8, 36, jpc.TILE_IN, 1),          # tests/test_pallas_channelizer.py
    (4, 4, 20, jpc.TILE_IN, 1),
    (2, 8, 36, jpc.TILE_IN + 40000, 1),  # not a multiple of the tile
    (3, 2, 34, 3000, 1),                 # the most taps M=2 takes
    (5, 8, 1, 4096, 1),                  # one tap: no tail; an odd C
    (9, 8, 40, 8192, 1),                 # the most taps; 8 channels + 1
    (3, 8, 36, 20480, 2),                # carried tail and phase
    (2, 4, 36, 12288, 2),
])
def test_three_forms_agree(C, M, T, n, blocks):
    rng, offs, h = _inputs(31, C, T, n)
    js = jpc.FusedChannelizerStage(offs, FS, h, M, n, interpret=True)
    ts = tfc.FusedChannelizerStage(offs, FS, h, M, n, device="cpu")
    sj = js.init_state()
    st = ts.init_state()
    if blocks == 1:  # a block in mid-stream: a tail and a phase to carry in
        tail = _signal(rng, T - 1)
        phase = rng.uniform(0, 2 * np.pi, C).astype(np.float32)
        sj = {"tail": jnp.asarray(tail), "phase": jnp.asarray(phase)}
        st = {"tail": torch.as_tensor(tail), "phase": torch.as_tensor(phase)}
    for b in range(blocks):
        x = _signal(rng, n)
        args = (st["tail"], torch.as_tensor(x), ts._coarse, ts._fine,
                ts._taps, st["phase"], M)
        plain = tfc.mix_decimate_ref(*args).numpy()
        modulated = tfc.mix_decimate_modulated_ref(*args)
        assert modulated.shape == (C, n // M)
        assert modulated.dtype == torch.complex64
        sj, yj = js(sj, jnp.asarray(x))
        st, _ = ts(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        _close(plain, yj, f"block {b}: plain vs pallas")
        _close(modulated.numpy(), yj, f"block {b}: modulated vs pallas")
        _close(modulated.numpy(), plain, f"block {b}: modulated vs plain")


@pytest.mark.parametrize("phase0", [0.0, 2 * np.pi - 1e-3])
def test_long_band_edge_block(phase0):
    """C=2 at -0.45 fs and +0.45 fs over 2.5 M samples, M=8, T=36."""
    M, T, n = 8, 36, 2_500_000
    rng, _, h = _inputs(32, 2, T, n)
    ts = tfc.FusedChannelizerStage([-0.45 * FS, 0.45 * FS], FS, h, M, n,
                                   device="cpu")
    args = (torch.as_tensor(_signal(rng, T - 1)),
            torch.as_tensor(_signal(rng, n)), ts._coarse, ts._fine, ts._taps,
            torch.full((2,), phase0, dtype=torch.float32), M)
    plain = tfc.mix_decimate_ref(*args).numpy()
    modulated = tfc.mix_decimate_modulated_ref(*args).numpy()
    _close(modulated, plain, "modulated vs plain")
    # the last outputs, where an error growing with the index would peak
    _close(modulated[:, -4096:], plain[:, -4096:], "last 4096 outputs")


def test_modulated_form_is_the_defining_sum():
    """Against a float64 numpy evaluation of
    y_c[j] = sum_t ext[jM+t] e^{i(w_c (jM+t-halo) + phase_c)} h[t]."""
    M, T, n = 4, 33, 8192
    rng, offs, h = _inputs(33, 3, T, n)
    ts = tfc.FusedChannelizerStage(offs, FS, h, M, n, device="cpu")
    tail, x = _signal(rng, T - 1), _signal(rng, n)
    phase = np.array([0.3, 5.9, 2.0], np.float32)
    y = tfc.mix_decimate_modulated_ref(
        torch.as_tensor(tail), torch.as_tensor(x), ts._coarse, ts._fine,
        ts._taps, torch.as_tensor(phase), M).numpy()
    ext = np.concatenate([tail, x]).astype(np.complex128)
    e = np.arange(ext.shape[0])
    omega = -2 * np.pi * offs / FS
    rot = np.exp(1j * (omega[:, None] * (e - (T - 1)) + phase[:, None]))
    idx = M * np.arange(n // M)[:, None] + np.arange(T)[None, :]
    want = ((ext[None, :] * rot)[:, idx] * h.astype(np.float64)).sum(-1)
    _close(y, want, "modulated vs float64 sum")
