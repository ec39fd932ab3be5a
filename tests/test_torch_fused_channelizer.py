"""K2's module in sdrtpu_torch (`FusedChannelizerStage`, `mix_decimate`)
against sdrtpu's Pallas stage, both on the CPU.

The JAX stage runs its Pallas kernel with ``interpret=True``, as
tests/test_pallas_channelizer.py does; the port's wrapper runs its plain
PyTorch version on CPU tensors.

Tolerances:
- host tables (fine, coarse, block phase step, W1/W2): exact;
- IF output: 1e-5 of the peak (both take the same float32 rotation and
  Toeplitz products; the matmul sums run in another order);
- carried state: the tail exactly, the float32 phase to 2e-6 rad (both
  reduce mod 2*pi in float32);
- the plain version against a float64 numpy evaluation of the defining
  sum: 1e-5 of the peak (float32 tables and sums).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import pallas_channelizer as jpc  # noqa: E402
from sdrtpu_torch.kernels import fused_channelizer as tfc  # noqa: E402

RNG = np.random.default_rng(21)
FS = 10e6


def _taps(t):
    h = RNG.standard_normal(t).astype(np.float32)
    return h / np.abs(h).sum()


def _signal(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64)


def _pair(offsets, taps, M, n):
    return (jpc.FusedChannelizerStage(offsets, FS, taps, M, n, interpret=True),
            tfc.FusedChannelizerStage(offsets, FS, taps, M, n, device="cpu"))


def test_constants_and_toeplitz_tables_equal():
    assert (tfc.ROW, tfc.TILE_ROWS, tfc.TILE_IN) == (
        jpc.ROW, jpc.TILE_ROWS, jpc.TILE_IN)
    for M, T in ((8, 36), (4, 20), (2, 34), (8, 1)):
        h = _taps(T)
        w1, w2 = tfc._toeplitz_mats(torch.as_tensor(h), M)
        r1, r2 = jpc._toeplitz_mats(h, M)
        assert w1.dtype == torch.float32 and w2.dtype == torch.float32
        np.testing.assert_array_equal(w1.numpy(), r1)
        np.testing.assert_array_equal(w2.numpy(), r2)


@pytest.mark.parametrize("n", [jpc.TILE_IN, jpc.TILE_IN + 40000])
def test_host_tables_equal(n):
    offs = np.array([-3e6, -1e6, 0.5e6, 2.75e6])
    js, ts = _pair(offs, _taps(36), 8, n)
    fine, coarse = ts._fine.numpy(), ts._coarse.numpy()
    np.testing.assert_array_equal(fine.real, js.fine_re)
    np.testing.assert_array_equal(fine.imag, js.fine_im)
    np.testing.assert_array_equal(ts.block_delta, js.block_delta)
    # the reference tiles its rows (n_tiles, C, 65 of 128 lanes); row 64
    # of tile i is row 0 of tile i+1
    rows = js.n_tiles * jpc.TILE_ROWS + 1
    assert coarse.shape == (4, rows)
    g = np.arange(rows)
    tile = np.minimum(g // jpc.TILE_ROWS, js.n_tiles - 1)
    lane = g - tile * jpc.TILE_ROWS
    np.testing.assert_array_equal(coarse.real, js.coarse_re[tile, :, lane].T)
    np.testing.assert_array_equal(coarse.imag, js.coarse_im[tile, :, lane].T)


@pytest.mark.parametrize("M,T,n", [
    (8, 36, jpc.TILE_IN),           # tests/test_pallas_channelizer.py shapes
    (4, 20, jpc.TILE_IN),
    (8, 36, jpc.TILE_IN + 40000),   # not a multiple of the tile
    (2, 34, 3000),                  # the most taps M=2 takes; a short block
    (8, 1, 4096),                   # one tap: the carried tail is empty
])
def test_stage_matches_reference_over_two_blocks(M, T, n):
    offs = np.array([-3e6, -1e6, 0.5e6, 2.75e6])
    js, ts = _pair(offs, _taps(T), M, n)
    sj = js.init_state()
    st = {"tail": torch.as_tensor(sj["tail"]),
          "phase": torch.as_tensor(sj["phase"])}
    for _ in range(2):
        x = _signal(n)
        sj, yj = js(sj, jnp.asarray(x))
        st, yt = ts(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        assert yt.shape == yj.shape == (4, n // M) and yt.dtype == torch.complex64
        np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5 * np.abs(yj).max())
        assert st["tail"].shape == (T - 1,)
        np.testing.assert_array_equal(st["tail"].numpy(), np.asarray(sj["tail"]))
        np.testing.assert_allclose(st["phase"].numpy(), np.asarray(sj["phase"]),
                                   atol=2e-6)


def test_plain_version_is_the_defining_sum():
    """y_c[j] = sum_t ext[jM+t] e^{i(w_c (jM+t-halo) + phase_c)} h[t],
    evaluated in float64 numpy from the same offsets and a nonzero
    carried phase."""
    M, T, n = 8, 36, 8192
    offs = np.array([-2.5e6, 0.0, 3.3e6])
    h = _taps(T)
    ts = tfc.FusedChannelizerStage(offs, FS, h, M, n, device="cpu")
    tail, x = _signal(T - 1), _signal(n)
    phase = np.array([0.3, 5.9, 2.0], np.float32)
    y = tfc.mix_decimate(torch.as_tensor(tail), torch.as_tensor(x),
                         ts._coarse, ts._fine, ts._taps,
                         torch.as_tensor(phase), M).numpy()
    ext = np.concatenate([tail, x]).astype(np.complex128)
    e = np.arange(ext.shape[0])
    omega = -2 * np.pi * offs / FS
    rot = np.exp(1j * (omega[:, None] * (e - (T - 1)) + phase[:, None]))
    mixed = ext[None, :] * rot
    idx = M * np.arange(n // M)[:, None] + np.arange(T)[None, :]
    want = (mixed[:, idx] * h.astype(np.float64)).sum(-1)
    np.testing.assert_allclose(y, want, atol=1e-5 * np.abs(want).max())


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    ts = tfc.FusedChannelizerStage([1e6], FS, _taps(36), 8, 4096, device="cpu")
    st = ts.init_state()
    before = tfc.mix_decimate.launches
    x = torch.as_tensor(_signal(4096))
    args = (st["tail"], x, ts._coarse, ts._fine, ts._taps, st["phase"], 8)
    assert torch.equal(tfc.mix_decimate(*args), tfc.mix_decimate_ref(*args))
    assert tfc.mix_decimate.launches == before
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.mix_decimate(*meta)
    with pytest.raises(ValueError, match="bad plan"):
        tfc.mix_decimate(*args[:-1], 5)
    with pytest.raises(ValueError, match="tail"):
        tfc.mix_decimate(st["tail"].to(torch.complex128), *args[1:])
    with pytest.raises(ValueError, match="cover"):
        tfc.mix_decimate(args[0], args[1], ts._coarse[:, :4], *args[3:])


def test_stage_asserts_like_the_reference():
    with pytest.raises(AssertionError):
        tfc.FusedChannelizerStage([0.0], FS, _taps(36), 5, 4000, device="cpu")
    with pytest.raises(AssertionError, match="spill"):
        tfc.FusedChannelizerStage([0.0], FS, _taps(41), 8, 4096, device="cpu")
