"""The sparse alias fold of sdrtpu_torch's fft channelizer against
sdrtpu's (both on the CPU): `FftDecimatorChain(sparse_thresh_db=)`,
`Channelizer` and `WbfmMultiVfoPipeline(sparse_fold_db=)`.  The
counterpart of tests/test_pallas_channelizer.py:262-301.

Tolerances:
- live-row selection and tables (``fold_idx``, the sparse ``hf``, the
  row count): exact, they are the same float64/complex64 host math;
- IF output against the reference's sparse fold: 1e-5 of the peak (FFT
  and fold sums in another order, as tests/test_torch_channelizer.py);
- the sparse against the dense fold: 2e-4 of the peak, the reference's
  own bound (rows below -100 dB dropped);
- carried state: the tail exactly, the rotator phase to 2e-6 rad;
- the pipeline's audio: 2e-4 after the filter-fill blocks, as
  tests/test_torch_pipeline.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.apps.wbfm_pipeline import WbfmMultiVfoPipeline as JPipe  # noqa: E402
from sdrtpu.kernels.resample import RationalResampler as JRR  # noqa: E402
from sdrtpu.shard import channelizer as jch  # noqa: E402
from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline as TPipe  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.shard import channelizer as tch  # noqa: E402

RNG = np.random.default_rng(12)
FS, N = 10e6, 40000
# edge offsets whose alias rows wrap around DC and Nyquist
OFFS = np.array([-4.9e6, -2.2e6, 0.0, 1e5, 3.3e6, 4.9e6])


def _stages():
    rr = JRR(FS, 250e3)
    return [(np.asarray(s.taps), s.decimation) for s in rr.predecim.stages]


def _noise(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64)


def _check_state(st, sj):
    np.testing.assert_array_equal(st["tail"].numpy(), np.asarray(sj["tail"]))
    np.testing.assert_array_equal(st["fold_idx"].numpy(),
                                  np.asarray(sj["fold_idx"]))
    np.testing.assert_array_equal(st["hf"].numpy(), np.asarray(sj["hf"]))
    dphi = st["rot"]["phase"].numpy() - np.asarray(sj["rot"]["phase"])
    assert np.abs(np.angle(np.exp(1j * dphi))).max() <= 2e-6


def test_live_rows_and_tables_equal():
    jc = jch.FftDecimatorChain(OFFS, FS, _stages(), N,
                               sparse_thresh_db=-100.0)
    tc = tch.FftDecimatorChain(OFFS, FS, _stages(), N,
                               sparse_thresh_db=-100.0, device="cpu")
    assert jc._sparse and tc._sparse
    assert tc.rk == jc.rk < tc.ratio // 2
    np.testing.assert_array_equal(tc._fold_idx, jc._fold_idx)
    assert tc._fold_idx.dtype == np.int32
    np.testing.assert_array_equal(tc._hf_sparse, jc._hf_sparse)
    st = tc.init_state()
    assert set(st) == {"tail", "rot", "hf", "fold_idx"}
    assert tuple(st["hf"].shape) == (len(OFFS), tc.rk, tc.nif)


def test_sparse_streams_like_the_reference():
    """Three blocks, then a two-block window; the state carried across,
    and converted from the reference's at the start."""
    jc = jch.FftDecimatorChain(OFFS, FS, _stages(), N,
                               sparse_thresh_db=-100.0)
    tc = tch.FftDecimatorChain(OFFS, FS, _stages(), N,
                               sparse_thresh_db=-100.0, device="cpu")
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    assert st["fold_idx"].dtype == torch.int32
    for x in [_noise(N), _noise(N), _noise(N), _noise(2 * N)]:
        sj, yj = jc(sj, jnp.asarray(x))
        st, yt = tc(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj,
                                   atol=1e-5 * np.abs(yj).max())
        _check_state(st, sj)
    back = state_to_numpy(st)
    assert back["fold_idx"].dtype == np.int32


def test_sparse_matches_dense():
    sparse = tch.FftDecimatorChain(OFFS, FS, _stages(), N,
                                   sparse_thresh_db=-100.0, device="cpu")
    dense = tch.FftDecimatorChain(OFFS, FS, _stages(), N, device="cpu")
    assert sparse._sparse and not dense._sparse
    x = torch.as_tensor(_noise(N))
    _, a = sparse(sparse.init_state(), x)
    _, b = dense(dense.init_state(), x)
    np.testing.assert_allclose(a.numpy(), b.numpy(),
                               atol=2e-4 * b.abs().max().item())


def test_random_taps_fall_back_to_dense():
    """White-spectrum taps keep every alias row: more than R // 2 live,
    so the dense fold runs, in both packages."""
    taps = [(RNG.standard_normal(36), 8), (RNG.standard_normal(95), 5)]
    jc = jch.FftDecimatorChain(np.array([1e6]), FS, taps, N,
                               sparse_thresh_db=-100.0)
    tc = tch.FftDecimatorChain(np.array([1e6]), FS, taps, N,
                               sparse_thresh_db=-100.0, device="cpu")
    assert not jc._sparse and not tc._sparse
    assert "fold_idx" not in tc.init_state()


def test_retune_keeps_layout_or_raises():
    """A retune that keeps the live-row count swaps the tables and
    carries the tail; one that changes it raises, as the reference."""
    offs = np.array([0.0, 1.3e6])
    moved = np.array([10e3, 1.29e6])
    jc = jch.FftDecimatorChain(offs, FS, _stages(), N, sparse_thresh_db=-100.0)
    tc = tch.FftDecimatorChain(offs, FS, _stages(), N,
                               sparse_thresh_db=-100.0, device="cpu")
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    x = _noise(N)
    sj, _ = jc(sj, jnp.asarray(x))
    st, _ = tc(st, torch.as_tensor(x))
    sj = jc.retune_state(sj, moved, FS, _stages())
    st = tc.retune_state(st, moved, FS, _stages())
    _check_state(st, sj)
    x = _noise(N)
    sj, yj = jc(sj, jnp.asarray(x))
    st, yt = tc(st, torch.as_tensor(x))
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5 * np.abs(yj).max())
    # a channel moved to 125 kHz keeps 9 alias rows, not 6
    edge = np.array([125e3, 1.3e6])
    with pytest.raises(ValueError, match="sparse-fold layout"):
        jc.retune_state(sj, edge, FS, _stages())
    with pytest.raises(ValueError, match="sparse-fold layout"):
        tc.retune_state(st, edge, FS, _stages())


def test_channelizer_and_pipeline_take_the_sparse_fold():
    """`WbfmMultiVfoPipeline(sparse_fold_db=-100)`, the config of
    tests/test_torch_pipeline.py: both packages' audio from one state
    over four blocks."""
    fs, block = 2_000_000.0, 20_000
    offs = np.linspace(-0.35, 0.35, 4) * fs
    t = np.arange(4 * block) / fs
    x = sum(0.4 * np.exp(1j * (2 * np.pi * f0 * t + 3 * np.sin(
        2 * np.pi * (400 + 150 * i) * t))) for i, f0 in enumerate(offs))
    x = x.astype(np.complex64).reshape(4, block)
    cfg = dict(channelizer_method="fft", sparse_fold_db=-100.0,
               skip_rotator=True)
    jp, tp = JPipe(offs, fs, block, **cfg), TPipe(offs, fs, block,
                                                  device="cpu", **cfg)
    assert jp.channelizer.fused._sparse and tp.channelizer.fused._sparse
    sj = jp.init_state()
    st = state_from_jax(sj, "cpu")
    for k in range(4):
        sj, (aj, _) = jp(sj, jnp.asarray(x[k]))
        st, (at, _) = tp(st, torch.as_tensor(x[k]))
        if k >= 2:
            np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=2e-4)
