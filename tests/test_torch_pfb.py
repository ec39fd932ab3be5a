"""sdrtpu_torch's PFB channelizer against sdrtpu's.

- The plan, the prototype, the twiddles and the bins: equal.
- Channel outputs from one converted state, two blocks: 2e-5 absolute
  of the unit-gain tones (the fold sums in the reference's order; the
  M-point FFT and the resampler's products round in their own).
- Streaming (three blocks one by one) equals the whole three-block
  window within 2e-5, the carried tail exactly (the port's own
  invariant, as tests/test_pfb.py holds the reference's).
- Retune: the new bins and rotator tables equal the reference's, the
  rotator phase and the histories kept; outputs after it within 2e-5.
- `Channelizer(method="pfb")` and `WbfmMultiVfoPipeline(
  channelizer_method="pfb")` at tests/test_pfb.py's 2 Msps / 4 VFOs:
  audio within 2e-4 of the JAX package's after the filter fill
  (tests/test_torch_pipeline.py's tolerance), the state leaves within
  2e-4; and the skip_rotator guard rejects "pfb" as the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.apps.wbfm_pipeline import WbfmMultiVfoPipeline as JPipe  # noqa: E402
from sdrtpu.shard import channelizer as jch  # noqa: E402
from sdrtpu.shard import pfb as jp  # noqa: E402
from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline as TPipe  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402
from sdrtpu_torch.shard import channelizer as tch  # noqa: E402
from sdrtpu_torch.shard import pfb as tp  # noqa: E402

FS = 10_000_000.0
IF = 250_000.0
ATOL = 2e-5


def _block_len(fs=FS):
    return jp.PfbChannelizer.block_multiple_for(fs, IF) * 8


def _tones(offsets, fines, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f0, df in zip(offsets, fines):
        x = x + np.exp(2j * np.pi * (f0 + df) * t)
    return x.astype(np.complex64)


def _pair(offsets, blk):
    return (jp.PfbChannelizer(offsets, FS, IF, blk),
            tp.PfbChannelizer(offsets, FS, IF, blk, device="cpu"))


@pytest.mark.parametrize("fs", [FS, 50_000_000.0, 2_000_000.0])
def test_plan_and_tables_equal(fs):
    assert tp.plan_pfb(fs, IF) == jp.plan_pfb(fs, IF)
    assert (tp.PfbChannelizer.block_multiple_for(fs, IF)
            == jp.PfbChannelizer.block_multiple_for(fs, IF))
    offs = np.linspace(-0.4, 0.4, 5) * fs
    blk = _block_len(fs)
    j = jp.PfbChannelizer(offs, fs, IF, blk)
    t = tp.PfbChannelizer(offs, fs, IF, blk, device="cpu")
    np.testing.assert_array_equal(t._h2, j._h2)
    np.testing.assert_array_equal(t._tw, j._tw)
    np.testing.assert_array_equal(t._bins, j._bins)
    np.testing.assert_array_equal(t.rot._coarse_t, j.rot._coarse_t)
    assert t.out_len(blk) == j.out_len(blk)


def test_channels_stream_like_the_reference():
    offsets = np.array([-3e6, -1e6, 0.5e6, 2e6])
    blk = _block_len()
    x = _tones(offsets, [10e3, -15e3, 20e3, 5e3], 2 * blk)
    jc, tc = _pair(offsets, blk)
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    for b in range(2):
        xb = x[b * blk:(b + 1) * blk]
        sj, yj = jc(sj, jnp.asarray(xb))
        st, yt = tc(st, torch.as_tensor(xb))
        assert yt.shape == (4, tc.out_len(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
        np.testing.assert_array_equal(st["tail"].numpy(),
                                      np.asarray(sj["tail"]))
        tree_map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), atol=ATOL), state_to_numpy(st), sj)
    assert float(np.abs(yt.numpy()[:, yt.shape[1] // 2:]).mean()) > 0.8


def test_fold_equals_the_reference_loop():
    """The strided-view fold gives the reference loop's bits."""
    offsets = np.array([1e6])
    blk = _block_len()
    jc, tc = _pair(offsets, blk)
    x = _tones(offsets, [3e3], blk, seed=3)
    ext = np.concatenate([np.zeros(tc.L - tc.D, np.complex64), x])
    F = blk // tc.D
    z = tc.fold(torch.as_tensor(ext), F).numpy()
    rows = np.pad(ext, (0, (F + tc.tpp * tc.V) * tc.D - len(ext))).reshape(
        -1, tc.D)
    want = np.zeros((F, tc.M), np.complex64)
    for s in range(tc.V):
        acc = None
        for q in range(tc.tpp):
            term = rows[q * tc.V + s:q * tc.V + s + F] * tc._h2[
                q, s * tc.D:(s + 1) * tc.D]
            acc = term if acc is None else acc + term
        want[:, s * tc.D:(s + 1) * tc.D] = acc
    np.testing.assert_array_equal(z, want)


def test_streaming_equals_whole():
    offsets = np.array([-2e6, 1e6, 3e6])
    blk = _block_len()
    x = _tones(offsets, [12e3, -8e3, 3e3], 3 * blk)
    tc = tp.PfbChannelizer(offsets, FS, IF, blk, device="cpu")
    st = tc.init_state()
    outs = []
    for b in range(3):
        st, y = tc(st, torch.as_tensor(x[b * blk:(b + 1) * blk]))
        outs.append(y)
    st2, whole = tc(tc.init_state(), torch.as_tensor(x))
    np.testing.assert_allclose(whole.numpy(), torch.cat(outs, -1).numpy(),
                               atol=ATOL)
    np.testing.assert_array_equal(st2["tail"].numpy(), st["tail"].numpy())
    np.testing.assert_allclose(st2["rot"]["phase"].numpy(),
                               st["rot"]["phase"].numpy(), atol=1e-5)


def test_retune_like_the_reference():
    offsets = np.array([-2e6, 1e6])
    blk = _block_len()
    jc, tc = _pair(offsets, blk)
    x0 = _tones(offsets, [5e3, 5e3], blk)
    x1 = _tones([3e6], [7e3], blk, seed=1)
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    sj, _ = jc(sj, jnp.asarray(x0))
    st, _ = tc(st, torch.as_tensor(x0))
    new = np.array([3e6, 1e6])
    sj = jc.retune_state(sj, new)
    st2 = tc.retune_state(st, new)
    np.testing.assert_array_equal(st2["bins"].numpy(), np.asarray(sj["bins"]))
    assert st2["bins"].dtype == torch.int32
    assert st2["tail"] is st["tail"]
    assert st2["rot"]["phase"] is st["rot"]["phase"]
    for k in ("coarse", "fine", "delta"):
        np.testing.assert_array_equal(st2["rot"][k].numpy(),
                                      np.asarray(sj["rot"][k]))
    for _ in range(2):
        sj, yj = jc(sj, jnp.asarray(x1))
        st2, yt = tc(st2, torch.as_tensor(x1))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)


def test_channelizer_pfb_and_guard():
    offs = np.array([-3e6, 2e6])
    blk = _block_len()
    jc = jch.Channelizer(offs, FS, IF, blk, method="pfb")
    tc = tch.Channelizer(offs, FS, IF, blk, method="pfb", device="cpu")
    assert tc.method == jc.method == "pfb"
    assert tc.rest_stages == [] and tc.init_state()["poly"] == ()
    x = _tones(offs, [4e3, -6e3], 2 * blk)
    sj = jc.init_state()
    st = state_from_jax(sj, "cpu")
    for b in range(2):
        xb = x[b * blk:(b + 1) * blk]
        sj, yj = jc(sj, jnp.asarray(xb))
        st, yt = tc(st, torch.as_tensor(xb))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
    sj = jc.retune_state(sj, np.array([-1e6, 2e6]))
    st = tc.retune_state(st, np.array([-1e6, 2e6]))
    np.testing.assert_array_equal(st["fused"]["bins"].numpy(),
                                  np.asarray(sj["fused"]["bins"]))
    with pytest.raises(ValueError, match="skip_rotator"):
        jch.Channelizer(offs, FS, IF, blk, method="pfb", skip_rotator=True)
    with pytest.raises(ValueError, match="skip_rotator"):
        tch.Channelizer(offs, FS, IF, blk, method="pfb", skip_rotator=True,
                        device="cpu")


def test_pipeline_with_pfb_front():
    """tests/test_pfb.py::test_pipeline_with_pfb_front's configuration:
    2 Msps, 4 stereo stations, 4 blocks through ``scan_call`` (one
    window), then ``scan_repeat`` of the last block, from one state."""
    fs = 2_000_000.0
    offs = np.linspace(-0.35, 0.35, 4) * fs
    mpfb = jp.PfbChannelizer.block_multiple_for(fs, IF)
    block = int(np.lcm(mpfb, JPipe.block_multiple(fs))) * 4
    K = 4
    t = np.arange(K * block) / fs
    x = np.zeros(t.shape, np.complex128)
    for i, f0 in enumerate(offs):
        left = np.sin(2 * np.pi * (400 + 150 * i) * t)
        right = np.sin(2 * np.pi * (900 + 150 * i) * t)
        mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
        ph = np.cumsum(2 * np.pi * 75000.0 * mpx / fs)
        x += 0.4 * np.exp(1j * (2 * np.pi * f0 * t + ph))
    x = x.astype(np.complex64).reshape(K, block)
    jpipe = JPipe(offs, fs, block, channelizer_method="pfb")
    tpipe = TPipe(offs, fs, block, channelizer_method="pfb", device="cpu")
    assert tpipe.channelizer.method == "pfb"
    sj = jpipe.init_state()
    st = state_from_jax(sj, "cpu")
    sj, aj = jpipe.scan_call(sj, jnp.asarray(x))
    st, at = tpipe.scan_call(st, torch.as_tensor(x))
    assert at.shape == aj.shape
    skip = aj.shape[-1]  # the first block fills the filters
    at = np.concatenate(list(at.numpy()), axis=-1)
    aj = np.concatenate(list(np.asarray(aj)), axis=-1)
    np.testing.assert_allclose(at[..., skip:], aj[..., skip:], atol=2e-4)
    tree_map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=2e-4), state_to_numpy(st), sj)
    sj, rj = jpipe.scan_repeat(sj, jnp.asarray(x[-1]), 2)
    st, rt = tpipe.scan_repeat(st, torch.as_tensor(x[-1]), 2)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=2e-4)
    for c in range(4):
        left = at[0, c, skip:] - at[0, c, skip:].mean()
        spec = np.abs(np.fft.rfft(left * np.hanning(len(left))))
        peak = np.fft.rfftfreq(len(left), 1 / 48000.0)[np.argmax(spec)]
        assert abs(peak - (400 + 150 * c)) < 50, (c, peak)
