"""The port's measurement tooling and last public names against sdrtpu's.

- `roofline`'s analytic models read the port's plans and give the
  reference's numbers exactly (float64) for the flagship, the 64-VFO and
  the pfb plans;
- `benchmark.measure_op` on the CPU (tests/test_misc_modules.py:175);
- `kernels.fftspec.four_step_fft` within 1e-4 of the peak of JAX's and
  of ``torch.fft.fft``;
- `FftDecimatorChain.chunk_matrix` equal to JAX's (data movement) and
  `poly_spectrum` within 1e-5 of the peak;
- `graph.compile.CompiledOp` on a `Fir`: outputs and state within 1e-6
  of JAX's over two blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu import roofline as jroof  # noqa: E402
from sdrtpu.apps.wbfm_pipeline import WbfmMultiVfoPipeline as JPipe  # noqa: E402
from sdrtpu_torch import roofline as troof  # noqa: E402
from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline as TPipe  # noqa: E402

PLANS = {
    "flagship": (np.linspace(-4e6, 4e6, 8), 10e6, 500_000, "fft"),
    "vfo64": (np.linspace(-20e6, 20e6, 64), 50e6, 2_500_000, "fft"),
    "pfb": (np.linspace(-4e6, 4e6, 8), 10e6, 500_000, "pfb"),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_roofline_models_equal_the_reference(plan):
    offs, fs, block, method = PLANS[plan]
    kw = dict(channelizer_method=method, spectrum=True,
              skip_rotator=method == "fft")
    j, t = JPipe(offs, fs, block, **kw), TPipe(offs, fs, block,
                                                device="cpu", **kw)
    C = len(offs)
    n_if = j.channelizer.out_len(block)
    n_af = j.audio_resamp.out_len(n_if)
    assert (t.channelizer.out_len(block), t.audio_resamp.out_len(n_if)) == (
        n_if, n_af)
    assert t._subk(256) == j._subk(256)
    pairs = [
        ("wfm_model", (j.demod, C, n_if), (t.demod, C, n_if)),
        ("audio_model", (j.audio_resamp, j.deemph, C, n_if, n_af),
         (t.audio_resamp, t.deemph, C, n_if, n_af)),
        ("spectrum_model", (j.spectrum, block), (t.spectrum, block)),
    ]
    jf, tf = j.channelizer.fused, t.channelizer.fused
    if method == "fft":
        pairs += [("channelizer_model", (jf, block), (tf, block)),
                  ("fold_model", (jf,), (tf,))]
    else:
        pairs.append(("pfb_model", (jf, block), (tf, block)))
    for name, ja, ta in pairs:
        want, got = getattr(jroof, name)(*ja), getattr(troof, name)(*ta)
        assert got == want, (name, got, want)
    assert troof.fft_flops(65536, 3) == jroof.fft_flops(65536, 3)


def test_h100_peaks_are_the_data_sheet():
    assert troof.H100_PEAKS["flops_f32"] == 67e12
    assert troof.H100_PEAKS["hbm_gbps"] == 3350.0
    assert not hasattr(troof, "V5E_PEAKS")


def test_device_measurements_refuse_the_cpu():
    with pytest.raises(ValueError):
        troof.measure_hbm_peak(1 << 20, device="cpu")
    offs, fs, block, _ = PLANS["flagship"]
    pipe = TPipe(offs[:2], fs, block, device="cpu")
    with pytest.raises(ValueError):
        troof.profile_flagship(pipe, np.zeros(block, np.complex64))


def test_slope_time_counts_the_steps():
    calls = []

    def step(st):
        calls.append(1)
        return st + 1, None

    t = troof.slope_time(step, 0, k1=2, k2=40, reps=2, device="cpu")
    assert t > 0 and len(calls) >= 2 * (2 + 40) + 2 + 40


def test_measure_op_cpu():
    from sdrtpu.benchmark import measure_op as jmeasure_op
    from sdrtpu.kernels import taps
    from sdrtpu.kernels.fir import Fir as JFir
    from sdrtpu_torch.benchmark import measure_op
    from sdrtpu_torch.kernels.fir import Fir

    h = taps.low_pass(0.2, 0.1, 1.0)
    r = measure_op(Fir(h, device="cpu"), (8192,), k_blocks=2, n_dispatch=2,
                   reps=1)
    assert r["msps"] > 0 and r["backend"] == "cpu"
    assert r["samples_per_dispatch"] == 2 * 8192
    want = jmeasure_op(JFir(h, dtype=jnp.complex64), (1024,), k_blocks=1,
                       n_dispatch=1, reps=1)
    assert set(r) == set(want)


@pytest.mark.parametrize("shape", [(65536,), (3, 65536), (48000,),
                                   (2, 3000)])
def test_four_step_fft(shape):
    from sdrtpu.kernels.fftspec import four_step_fft as jfour
    from sdrtpu_torch.kernels.fftspec import four_step_fft

    rng = np.random.default_rng(9)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    got = four_step_fft(torch.as_tensor(x)).numpy()
    want_j = np.asarray(jfour(jnp.asarray(x)))
    want_t = torch.fft.fft(torch.as_tensor(x)).numpy()
    peak = np.abs(want_t).max()
    np.testing.assert_allclose(got, want_j, atol=1e-4 * peak)
    np.testing.assert_allclose(got, want_t, atol=1e-4 * peak)


@pytest.mark.parametrize("plan", ["flagship", "vfo64"])
def test_chunk_matrix_and_poly_spectrum(plan):
    from sdrtpu.shard.channelizer import FftDecimatorChain as JChain
    from sdrtpu_torch.shard.channelizer import FftDecimatorChain

    offs, fs, block, _ = PLANS[plan]
    offs = offs[:4]
    jc = JChain(offs, fs, [(np.ones(9) / 9, 5), (np.ones(7) / 7, 8)], block)
    tc = FftDecimatorChain(offs, fs, [(np.ones(9) / 9, 5),
                                      (np.ones(7) / 7, 8)], block,
                           device="cpu")
    assert (tc.valid, tc.nfft, tc.n_chunks) == (jc.valid, jc.nfft,
                                                jc.n_chunks)
    rng = np.random.default_rng(3)
    L = block + tc.tpad - 1
    ext = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(
        np.complex64)
    P = tc.n_chunks
    cm_j = np.asarray(jc.chunk_matrix(jnp.asarray(ext), P))
    cm_t = tc.chunk_matrix(torch.as_tensor(ext), P)
    np.testing.assert_array_equal(cm_t.numpy(), cm_j)
    ps_j = np.asarray(jc.poly_spectrum(jnp.asarray(cm_j)))
    ps_t = tc.poly_spectrum(cm_t).numpy()
    np.testing.assert_allclose(ps_t, ps_j, atol=1e-5 * np.abs(ps_j).max())


def test_compiled_op_on_a_fir():
    from sdrtpu.graph.compile import CompiledOp as JCompiled
    from sdrtpu.graph.compile import to_numpy as jto_numpy
    from sdrtpu.kernels import taps
    from sdrtpu.kernels.fir import Fir as JFir
    from sdrtpu_torch.graph.compile import CompiledOp
    from sdrtpu_torch.kernels.fir import Fir

    h = taps.low_pass(0.1, 0.05, 1.0)
    jop = JCompiled(JFir(h, dtype=jnp.complex64))
    top = CompiledOp(Fir(h, device="cpu"))
    sj, st = jop.init_state(), top.init_state()
    assert isinstance(st, np.ndarray) and st.dtype == np.complex64
    rng = np.random.default_rng(4)
    for _ in range(2):
        x = (rng.standard_normal(4096)
             + 1j * rng.standard_normal(4096)).astype(np.complex64)
        sj, yj = jop(sj, x)
        st, yt = top(st, x)
        assert isinstance(yt, np.ndarray)
        np.testing.assert_allclose(yt, jto_numpy(yj), atol=1e-6)
        np.testing.assert_allclose(st, jto_numpy(sj), atol=1e-6)
