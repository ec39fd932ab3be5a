"""The whole slice: sdrtpu_torch's WbfmMultiVfoPipeline against sdrtpu's.

The config of tests/test_scan_call.py (2 Msps, 20k-sample blocks, 4
VFOs, 4096-bin waterfall at 100 Hz) with ``skip_rotator=True``.  Both
packages start from one state (converted with ``sdrtpu_torch.convert``)
and see the same blocks, with a retune mid-stream.

Tolerances:
- audio: ``atol=2e-4`` after the 2 filter-fill blocks, as
  tests/test_scan_call.py holds batched against sequential (angle() of
  near-zero samples during the fill is ill-conditioned);
- waterfall: 0.02 dB on bins within 80 dB of the frame peak (float32
  FFT rounding of the weakest of those bins, about 0.005 dB here);
- carried state: 2e-4 absolute on every leaf.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.apps.wbfm_pipeline import WbfmMultiVfoPipeline as JPipe  # noqa: E402
from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline as TPipe  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

FS, BLOCK, K = 2_000_000.0, 20_000, 6
OFFS = np.linspace(-0.35, 0.35, 4) * FS
RETUNED = OFFS + np.array([10e3, 0.0, -20e3, 0.0])


def _wideband(n):
    t = np.arange(n) / FS
    x = np.zeros(n, np.complex128)
    for i, f0 in enumerate(OFFS):
        left = np.sin(2 * np.pi * (400 + 150 * i) * t)
        right = np.sin(2 * np.pi * (900 + 150 * i) * t)
        mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
        ph = np.cumsum(2 * np.pi * 75000.0 * mpx / FS)
        x += 0.4 * np.exp(1j * (2 * np.pi * f0 * t + ph))
    return x.astype(np.complex64)


X = _wideband(K * BLOCK).reshape(K, BLOCK)


def _pipes(**kw):
    cfg = dict(channelizer_method="fft", spectrum=True, fft_size=4096,
               fft_rate=100.0, skip_rotator=True)
    return JPipe(OFFS, FS, BLOCK, **cfg), TPipe(OFFS, FS, BLOCK, device="cpu",
                                                **cfg, **kw)


def _close_spec(dt, dj):
    dt, dj = np.asarray(dt), np.asarray(dj)
    assert dt.shape == dj.shape
    live = dj > dj.max(axis=-1, keepdims=True) - 80.0
    np.testing.assert_allclose(dt[live], dj[live], atol=0.02)


def _leaves(tree, path=""):
    """{path: leaf} of a nest of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _close_state(st, sj):
    flat_t, flat_j = _leaves(state_to_numpy(st)), _leaves(sj)
    assert flat_t.keys() == flat_j.keys()
    for path, b in flat_j.items():
        a = flat_t[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, atol=2e-4, err_msg=path)


def test_sequential_call_with_retune_matches_reference():
    jp, tp = _pipes()
    sj = jp.init_state()
    st = state_from_jax(tree_map(np.asarray, sj), "cpu")
    assert st["demod"]["quad"]["rot"].shape == (4,)
    for b in range(K):
        if b == 3:
            sj = jp.retune_state(sj, RETUNED)
            st = tp.retune_state(st, RETUNED)
        sj, (aj, dj) = jp(sj, jnp.asarray(X[b]))
        st, (at, dt) = tp(st, torch.as_tensor(X[b]))
        aj = np.asarray(aj)
        assert at.shape == aj.shape == (2, 4, tp.out_len(BLOCK))
        if b >= 2:
            np.testing.assert_allclose(at.numpy(), aj, atol=2e-4)
        _close_spec(dt, dj)
    _close_state(st, sj)


def test_scan_call_from_a_shared_midstream_state():
    """Two blocks in sdrtpu, then both packages continue from that state:
    a retune, then scan_call over 4 blocks (the port in 2-block
    sub-windows, the reference as one window) and scan_repeat."""
    jp, tp = _pipes(sub_samples=2 * BLOCK)
    sj = jp.init_state()
    for b in range(2):
        sj, _ = jp(sj, jnp.asarray(X[b]))
    sj = tree_map(np.asarray, sj)
    st = state_from_jax(sj, "cpu")
    sj = jp.retune_state(sj, RETUNED)
    st = tp.retune_state(st, RETUNED)
    xs = X[2:]
    assert tp._subk(len(xs)) == 2
    sj2, (aj, dj) = jp.scan_call(sj, jnp.asarray(xs))
    st2, (at, dt) = tp.scan_call(st, torch.as_tensor(xs))
    aj = np.asarray(aj)
    assert at.shape == aj.shape == (4, 2, 4, tp.out_len(BLOCK))
    np.testing.assert_allclose(at.numpy(), aj, atol=2e-4)
    assert dt.shape == (4, 1, 4096)
    _close_spec(dt.reshape(-1, 4096), np.asarray(dj).reshape(-1, 4096))
    _close_state(st2, sj2)

    tp.spec_reduce = torch.amax
    _, (ar, sr) = tp.scan_repeat(st, torch.as_tensor(X[2]), 4)
    _, (aj, _) = jp.scan_repeat(sj, jnp.asarray(X[2]), 4)
    np.testing.assert_allclose(ar.numpy(), np.asarray(aj), atol=2e-4)
    assert sr.shape == (2,) and bool(torch.isfinite(sr).all())


def _if_back_end_before_graphs(self, st, state, y):
    """The IF back end as it ran before `GraphedStep` dispatched it."""
    st["demod"], (stereo, _) = self.demod(state["demod"], y)
    st["audio"], a = self.audio_resamp(state["audio"], stereo)
    st["deemph"], a = self.deemph(state["deemph"], a)
    return a


def _three_calls(tp, entry):
    """The state and outputs of three calls of ``entry`` from rest; the
    scans take 4 blocks in 2-block sub-windows."""
    st, outs = tp.init_state(), []
    for b in range(3):
        if entry == "call":
            st, out = tp(st, torch.as_tensor(X[b]))
        elif entry == "scan_call":
            st, out = tp.scan_call(st, torch.as_tensor(X[b:b + 4]))
        else:
            st, out = tp.scan_repeat(st, torch.as_tensor(X[b]), 4)
        outs.append(out)
    return st, outs


@pytest.mark.parametrize("entry", ["call", "scan_call", "scan_repeat"])
def test_if_back_end_on_the_cpu_is_eager_and_unchanged(entry):
    """Every entry gives the bits of the body the IF back end ran before
    it dispatched to a graph, and on the CPU every pass is eager."""
    now = _pipes(sub_samples=2 * BLOCK)[1]
    before = _pipes(sub_samples=2 * BLOCK)[1]
    before._if_back_end = _if_back_end_before_graphs.__get__(before)
    got, want = [], []
    tree_map(got.append, _three_calls(now, entry))
    tree_map(want.append, _three_calls(before, entry))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    passes = 3 if entry == "call" else 6
    g = now._if_graph
    assert (g.eager_passes, g.captures, g.replays) == (passes, 0, 0)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPipe(OFFS, FS, BLOCK)
