"""The per-block channelizer methods of sdrtpu_torch ("pallas", "xla-fused",
"xla") and `correlate_valid_bank` against sdrtpu, both on the CPU.

sdrtpu's "pallas" method runs its Pallas kernel in interpret mode
("pallas-interpret"); the port's runs the plain PyTorch version of K2 on
CPU tensors.

Tolerances:
- `correlate_valid_bank`: 2e-6 of the peak (the same float32 products,
  summed in the same tap order);
- host tables (modulated taps, group-delay phase, rotator tables): exact;
- IF output: 1e-5 of the peak (float32 sums in another order; the
  95-tap second stage sums 95 products);
- carried state: input tails and tables exactly, float32 phases to
  2e-6 rad, the tails that hold computed samples (later stages) to 1e-5
  of their peak.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.kernels import fir as jfir  # noqa: E402
from sdrtpu.shard import channelizer as jch  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402
from sdrtpu_torch.kernels import fir as tfir  # noqa: E402
from sdrtpu_torch.kernels import fused_channelizer as tfc  # noqa: E402
from sdrtpu_torch.shard import channelizer as tch  # noqa: E402

RNG = np.random.default_rng(8)
FS, IF, N = 10e6, 250e3, 40000
OFFS = np.array([-4e6, -1.2e6, 2e6])
RETUNED = np.array([-3.5e6, -1.2e6, 2.5e6])
# state leaves that carry computed samples (tails after the first stage)
COMPUTED = ("/rest/", "/tails/1", "/tails/2", "/resamp/")


def _signal(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
            ).astype(np.complex64)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _check_state(st, sj):
    """Same nest, shapes and types, at the tolerances above."""
    ft, fj = _flat(tree_map(lambda t: t.numpy(), st)), _flat(sj)
    assert ft.keys() == fj.keys()
    for path, b in fj.items():
        a = ft[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path.endswith("phase"):
            np.testing.assert_allclose(a, b, atol=2e-6, err_msg=path)
        elif any(k in path for k in COMPUTED):
            np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("shared,stride,cplx", [
    (True, 1, True), (True, 8, True), (True, 5, False),
    (False, 1, True), (False, 5, True),
])
def test_correlate_valid_bank_matches_reference(shared, stride, cplx):
    C, T, n = 3, 21, 2000
    taps = RNG.standard_normal((C, T)).astype(np.float32)
    taps[:, 1::2] = 0.0  # half-band-like zero columns are skipped
    if cplx:
        taps = (taps * np.exp(1j * RNG.uniform(0, 6, (C, T)))).astype(
            np.complex64)
    x = _signal(n) if shared else _signal(C, n)
    want = np.asarray(jfir.correlate_valid_bank(jnp.asarray(x), taps,
                                                stride=stride))
    got = tfir.correlate_valid_bank(torch.as_tensor(x), taps, stride=stride)
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6 * np.abs(want).max())
    # taps on the device with the caller's live list: the same sum
    live = list(range(0, T, 2))
    dev = tfir.correlate_valid_bank(torch.as_tensor(x), torch.as_tensor(taps),
                                    stride=stride, live=live)
    np.testing.assert_array_equal(dev.numpy(), got.numpy())


def test_correlate_valid_bank_real_input_real_taps():
    taps = RNG.standard_normal((2, 9)).astype(np.float32)
    x = RNG.standard_normal(500).astype(np.float32)
    want = np.asarray(jfir.correlate_valid_bank(jnp.asarray(x), taps, stride=2))
    got = tfir.correlate_valid_bank(torch.as_tensor(x), taps, stride=2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("decim", [8, 5, 2])
def test_modulated_stage_matches_reference(decim):
    n = 4000
    offs = np.array([-3e6, -1e6, 0.5e6, 2.75e6])
    taps = RNG.standard_normal(36).astype(np.float32)
    js = jch.ModulatedDecimatorStage(offs, FS, taps, decim, n)
    ts = tch.ModulatedDecimatorStage(offs, FS, taps, decim, n, device="cpu")
    np.testing.assert_array_equal(ts.stage_plan[0][0], js.stage_plan[0][0])
    np.testing.assert_array_equal(ts._phase0, js._phase0)
    assert ts._live == js._live
    sj = js.init_state()
    st = state_from_jax(sj, "cpu")
    for _ in range(2):
        x = _signal(n)
        sj, yj = js(sj, jnp.asarray(x))
        st, yt = ts(st, torch.as_tensor(x))
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5 * np.abs(yj).max())
        _check_state(st, tree_map(np.asarray, sj))


def _channelizers(method, offs=OFFS, fs=FS, out=IF, n=N, **kw):
    jm = "pallas-interpret" if method == "pallas" else method
    return (jch.Channelizer(offs, fs, out, n, method=jm, **kw),
            tch.Channelizer(offs, fs, out, n, method=method, device="cpu",
                            **kw))


def _stream(jc, tc, blocks, retune_at=None):
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    for i, b in enumerate(blocks):
        if i == retune_at:
            sj = jc.retune_state(sj, RETUNED)
            st = tc.retune_state(st, RETUNED)
        sj, yj = jc(sj, jnp.asarray(b))
        st, yt = tc(st, torch.as_tensor(b))
        yj = np.asarray(yj)
        assert yt.shape == yj.shape
        np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5 * np.abs(yj).max())
        _check_state(st, tree_map(np.asarray, sj))
    return st


@pytest.mark.parametrize("method", ["pallas", "xla-fused", "xla"])
def test_channelizer_method_streams_three_blocks(method):
    jc, tc = _channelizers(method)
    assert tc.method == method
    st = _stream(jc, tc, [_signal(N) for _ in range(3)])
    if method == "pallas":
        assert isinstance(tc.fused, tfc.FusedChannelizerStage)
        assert [(s.decimation, s.ntaps) for s in tc.rest_stages] == [(5, 95)]
        assert st["rest"][0].shape == (3, 94)


@pytest.mark.parametrize("method", ["xla-fused", "xla"])
def test_channelizer_retune_matches_reference(method):
    """A retune before the third block: the tables swap, the tails and
    each channel's accumulated phase carry over, as in sdrtpu."""
    jc, tc = _channelizers(method)
    _stream(jc, tc, [_signal(N) for _ in range(4)], retune_at=2)
    np.testing.assert_array_equal(tc.offsets, RETUNED)


def test_pallas_retune_is_a_rebuild():
    _, tc = _channelizers("pallas")
    with pytest.raises(NotImplementedError, match="rebuild"):
        tc.retune_state(tc.init_state(), RETUNED)


def test_auto_falls_back_like_the_reference(monkeypatch):
    # no integer predecimation (1 Msps -> 48 kHz is one 6/125 polyphase)
    jc, tc = _channelizers("auto", fs=1e6, out=48e3, n=12500,
                           offs=np.array([-2e5, 1e5]))
    assert jc.method == tc.method == "xla"
    _stream(jc, tc, [_signal(12500) for _ in range(2)])
    # no FFT chunk plan: the time-domain modulated taps
    def no_plan(*a, **k):
        raise ValueError("no FFT chunk plan")
    monkeypatch.setattr(jch, "_plan_fft_chunks", no_plan)
    monkeypatch.setattr(tch, "_plan_fft_chunks", no_plan)
    jc, tc = _channelizers("auto")
    assert jc.method == tc.method == "xla-fused"
    _stream(jc, tc, [_signal(N) for _ in range(2)])
    # xla-fused without predecimation resolves to xla in both
    assert tch.Channelizer([0.0], 1e6, 48e3, 12500, method="xla-fused",
                           device="cpu").method == "xla"


@pytest.mark.parametrize("method", ["pallas", "xla-fused", "xla"])
def test_skip_rotator_needs_the_fft_method(method):
    with pytest.raises(ValueError, match="only supported on the fft"):
        jch.Channelizer(OFFS, FS, IF, N, method=method.replace(
            "pallas", "pallas-interpret"), skip_rotator=True)
    with pytest.raises(ValueError, match="only supported on the fft"):
        tch.Channelizer(OFFS, FS, IF, N, method=method, skip_rotator=True,
                        device="cpu")


@pytest.mark.parametrize("fs,n", [(2e6, 16000), (1.25e6, 10000)])
def test_pallas_rejects_an_ineligible_plan(fs, n):
    """Stage 1 of 2 Msps -> 250 kHz is (8, 152 taps): too many taps;
    1.25 Msps -> 250 kHz decimates by 5."""
    with pytest.raises(ValueError, match="not eligible"):
        jch.Channelizer(OFFS / 10, fs, IF, n, method="pallas")
    with pytest.raises(ValueError, match="not eligible"):
        tch.Channelizer(OFFS / 10, fs, IF, n, method="pallas", device="cpu")


def test_pallas_interpret_has_no_meaning_here():
    with pytest.raises(ValueError, match="method='pallas' with device='cpu'"):
        tch.Channelizer(OFFS, FS, IF, N, method="pallas-interpret",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown channelizer method"):
        tch.Channelizer(OFFS, FS, IF, N, method="polyphase", device="cpu")
