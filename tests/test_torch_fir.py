"""FIR evaluations of sdrtpu_torch against sdrtpu (both on the CPU).

Same inputs (seeded numpy) through each sdrtpu function and its port.
Tolerances: the shift-and-add, banded-Toeplitz matmul and FFT forms are
float32 sums taken in another order than the reference's, so outputs
agree to 2e-6 of the signal peak (about 30 float32 ulps of accumulation
over 317 taps); streamed state (the input tail) is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import fir as jfir  # noqa: E402
from sdrtpu.kernels import taps as jtaps  # noqa: E402
from sdrtpu.kernels.iir import Deemphasis as JDeemphasis  # noqa: E402
from sdrtpu_torch.kernels import fir as tfir  # noqa: E402

# true float32 contractions (the reference's "highest" precision); a
# no-op on the CPU, stated so the same test reads right on the card
torch.backends.cuda.matmul.allow_tf32 = False

RNG = np.random.default_rng(5)
PILOT = 2.0 * np.real(jtaps.band_pass(18750.0, 19250.0, 3000.0, 250000.0,
                                      odd_tap_count=True))
DEEMPH = JDeemphasis(50e-6, 48000.0)._fir


def _x(shape, cplx):
    x = RNG.standard_normal(shape)
    if cplx:
        x = x + 1j * RNG.standard_normal(shape)
    return x.astype(np.complex64 if cplx else np.float32)


def _close(got, want, rel=2e-6):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


def test_shapes_are_the_flagship_ones():
    assert PILOT.shape == (317,) and DEEMPH.shape == (60,)


@pytest.mark.parametrize("taps,shape,cplx", [
    (PILOT, (2, 3, 3000), False),   # envelope pilot: (C, n) real MPX
    (PILOT, (3, 2000), True),
    (DEEMPH, (2, 3, 1500), False),  # de-emphasis: (2, C, n) stereo audio
    (DEEMPH.astype(np.complex64) * (1 + 0.5j), (700,), True),
])
def test_matmul_correlate_valid(taps, shape, cplx):
    x = _x(shape, cplx)
    want = jfir.matmul_correlate_valid(jnp.asarray(x), taps)
    _close(tfir.matmul_correlate_valid(torch.as_tensor(x), taps), want)
    # and the direct shift-and-add sum of the same definition
    _close(tfir.correlate_valid(torch.as_tensor(x), taps),
           jfir.correlate_valid(jnp.asarray(x), taps))


@pytest.mark.parametrize("stride,cplx", [(1, True), (5, True), (8, False)])
def test_correlate_valid_strided(stride, cplx):
    taps = jtaps.low_pass(0.1, 0.05, 1.0)
    x = _x((2, 4000), cplx)
    _close(tfir.correlate_valid(torch.as_tensor(x), taps, stride=stride),
           jfir.correlate_valid(jnp.asarray(x), taps, stride=stride))


@pytest.mark.parametrize("n,cplx", [(5000, False), (5000, True),
                                    (70000, True)])
def test_fft_correlate_valid(n, cplx):
    """Single-transform and chunked overlap-save plans (n=70000 crosses
    the 32768 single-FFT limit)."""
    assert tfir._plan_corr_nfft(n, 317) == jfir._plan_corr_nfft(n, 317)
    x = _x((2, n), cplx)
    _close(tfir.fft_correlate_valid(torch.as_tensor(x), PILOT),
           jfir.fft_correlate_valid(jnp.asarray(x), PILOT), rel=5e-6)


@pytest.mark.parametrize("method", ["mm", "direct", "fft"])
def test_fir_streams_two_blocks(method):
    dtype = "float32" if method == "mm" else "complex64"
    jop = jfir.Fir(PILOT, dtype=getattr(jnp, dtype), method=method)
    top = tfir.Fir(PILOT, dtype=getattr(torch, dtype), method=method,
                   device="cpu")
    sj, st = jop.init_state(), top.init_state()
    for _ in range(2):
        x = _x((3, 1000), dtype == "complex64")
        sj, yj = jop(sj, jnp.asarray(x))
        st, yt = top(st, torch.as_tensor(x))
        _close(yt, yj, rel=5e-6)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("lengths", [(1000, 1000, 1000), (1000, 70000, 1000)],
                         ids=["one-plan", "two-plans-in-turn"])
def test_fir_fft_keeps_its_tap_spectrum(lengths):
    """`Fir`'s "fft" method keeps the tap spectrum on the device per FFT
    size; its outputs are the bits of `fft_correlate_valid` building the
    spectrum at every call (70 000 takes the chunked plan)."""
    top = tfir.Fir(PILOT, dtype=torch.complex64, method="fft", device="cpu")
    st = top.init_state()
    for n in lengths:
        x = torch.as_tensor(_x((3, n), True))
        ext = torch.cat([st.expand(3, -1), x], dim=-1)
        st, y = top(st, x)
        assert torch.equal(y, tfir.fft_correlate_valid(ext, PILOT))
    assert sorted(k for k, _ in top._spectra) == sorted(
        {tfir._plan_corr_nfft(n + len(PILOT) - 1, len(PILOT))
         for n in lengths})


def test_decimating_fir_streams_two_blocks():
    taps = jtaps.low_pass(100000.0, 50000.0, 2e6)
    jop = jfir.DecimatingFir(taps, 8)
    top = tfir.DecimatingFir(taps, 8, device="cpu")
    sj, st = jop.init_state(), top.init_state()
    for _ in range(2):
        x = _x((4000,), True)
        sj, yj = jop(sj, jnp.asarray(x))
        st, yt = top(st, torch.as_tensor(x))
        _close(yt, yj)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _decimating_fir_by_cat(taps, M, state, x):
    """`DecimatingFir`'s step as it was written before `decim_fir`: the
    tail and the block concatenated, the shift-and-add at the stride,
    the concatenation's last ``T - 1`` samples as the next state."""
    state = state.expand(x.shape[:-1] + (len(taps) - 1,))
    ext = torch.cat([state, x], dim=-1)
    return ext[..., x.shape[-1]:], tfir.correlate_valid(ext, taps, stride=M)


@pytest.mark.parametrize("M,T,n", [(8, 30, 4000), (2, 32, 10), (5, 95, 30),
                                   (1, 1, 7)],
                         ids=["n>=T-1", "n<T-1", "n<T-1,95taps", "one-tap"])
@pytest.mark.parametrize("cplx", [True, False], ids=["c64", "f32"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["1row", "3rows"])
def test_decimating_fir_streams_three_blocks_as_the_cat_path(M, T, n, cplx,
                                                             lead):
    """Three blocks through `DecimatingFir` (`decim_fir` on the CPU) give
    the outputs and states of the concatenating step, to the bit, with
    the tail shorter or longer than the block and one or three rows."""
    taps = RNG.standard_normal(T).astype(np.float32)
    dtype = torch.complex64 if cplx else torch.float32
    op = tfir.DecimatingFir(taps, M, dtype=dtype, device="cpu")
    st = ref = op.init_state()
    for _ in range(3):
        x = torch.as_tensor(_x(lead + (n,), cplx))
        st, y = op(st, x)
        ref, y_ref = _decimating_fir_by_cat(taps, M, ref, x)
        assert y.shape == lead + (n // M,) and st.shape == lead + (T - 1,)
        assert torch.equal(y, y_ref) and torch.equal(st, ref)


def test_decimating_fir_refuses_complex_taps():
    with pytest.raises(ValueError, match="complex taps"):
        tfir.DecimatingFir(np.ones(5, np.complex64), 2, device="cpu")


def test_build_sources_list_decim_fir():
    """The strided FIR kernel is one of the sources `build_all` builds."""
    from sdrtpu_torch import _build

    assert "decim_fir" in _build.SOURCES
    assert (_build.CSRC / "decim_fir.cu").exists()
    assert _build.lib_path("decim_fir").name.startswith("libdecim_fir-")


def _tile_reads(M, T, n, itemsize):
    """``csrc/decim_fir.cu``'s staging and tap walk, mirrored on the
    host over `decim_fir_plan`'s tile: for each output, the ``ext``
    indices its taps read, in tap order."""
    ob, qw, smem = tfir.decim_fir_plan(M, T, itemsize)
    assert smem == M * qw * itemsize + 4 * T
    A = (n - 1) // M + 1
    reads = np.empty((A, T), np.int64)
    wrap = (M - 1) * qw - 1
    for i0 in range(0, A, ob):
        nout = min(ob, A - i0)
        span = (nout - 1) * M + T
        tile = np.full(M * qw, -1, np.int64)
        j = np.arange(span)
        tile[(j % M) * qw + j // M] = i0 * M + j
        for k in range(nout):
            idx = [k]
            p = 0
            for _ in range(1, T):
                p += 1
                if p == M:
                    p = 0
                    idx.append(idx[-1] - wrap)
                else:
                    idx.append(idx[-1] + qw)
            reads[i0 + k] = tile[idx]
    return reads


@pytest.mark.parametrize("M,T,n,itemsize", [
    (8, 30, 4096, 8), (8, 32, 2048, 8), (5, 30, 1250, 8), (2, 32, 600, 8),
    (5, 20, 1000, 4), (1, 20, 300, 4), (2, 95, 10, 8), (3, 7, 2, 8),
    (13, 40, 2600, 8), (64, 100, 640, 8), (1, 7000, 300, 8)])
def test_decim_fir_tile_holds_every_sample_its_taps_read(M, T, n, itemsize):
    """In `decim_fir_plan`'s tile, in polyphase order, output i's tap t
    reads ``ext[i * M + t]`` under the kernel's walk, for short and long
    blocks, strides and tap counts; the tile fits 48 KB, or for 7 000
    taps the card's most."""
    reads = _tile_reads(M, T, n, itemsize)
    want = np.arange(reads.shape[0])[:, None] * M + np.arange(T)[None, :]
    np.testing.assert_array_equal(reads, want)
    smem = tfir.decim_fir_plan(M, T, itemsize)[2]
    assert smem <= (tfir._SMEM_MAX if T == 7000 else tfir._SMEM_STATIC)


def test_decim_fir_plan_refuses_a_tile_past_shared_memory():
    assert tfir.decim_fir_plan(8, 30, 8)[:2] == (256, 259)
    with pytest.raises(ValueError, match="does not fit"):
        tfir.decim_fir_plan(1, 30000, 8)


def test_cuda_default_raises_without_a_card():
    """Constructors default to the card and never fall back quietly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfir.Fir(PILOT)
