"""WbfmMultiVfoPipeline of sdrtpu_torch against sdrtpu on the per-block
channelizer methods: "pallas" (sdrtpu runs "pallas-interpret", its Pallas
kernel in interpret mode; the port runs K2's plain version on the CPU),
"xla-fused" and "xla".

3 VFOs off 10 Msps, 50 000-sample blocks, ``skip_rotator=False``, a
4096-bin waterfall at 200 Hz.  Both packages start from one state and
see the same blocks through ``__call__``, ``scan_call`` and
``scan_repeat`` (2-block sub-windows in both).

Tolerances, as tests/test_torch_pipeline.py:
- audio: ``atol=2e-4`` after the 2 filter-fill blocks;
- waterfall: 0.02 dB on bins within 80 dB of the frame peak;
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

FS, BLOCK, K = 10_000_000.0, 50_000, 4
OFFS = np.linspace(-0.35, 0.35, 3) * FS


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


X = _wideband((2 + K) * BLOCK).reshape(2 + K, BLOCK)


def _pipes(method, monkeypatch):
    monkeypatch.setenv("SDRTPU_SUBK", "2")
    cfg = dict(spectrum=True, fft_size=4096, fft_rate=200.0,
               skip_rotator=False)
    jm = "pallas-interpret" if method == "pallas" else method
    return (JPipe(OFFS, FS, BLOCK, channelizer_method=jm, **cfg),
            TPipe(OFFS, FS, BLOCK, channelizer_method=method,
                  sub_samples=2 * BLOCK, device="cpu", **cfg))


def _close_spec(dt, dj):
    dt, dj = np.asarray(dt), np.asarray(dj)
    assert dt.shape == dj.shape
    live = dj > dj.max(axis=-1, keepdims=True) - 80.0
    np.testing.assert_allclose(dt[live], dj[live], atol=0.02)


def _close_state(st, sj):
    flat_t = state_to_numpy(st)
    paths = []

    def check(a, b):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=2e-4)
        paths.append(1)

    tree_map(check, flat_t, sj)
    assert paths


@pytest.mark.parametrize("method", ["pallas", "xla-fused", "xla"])
def test_call_then_scan_from_a_shared_state(method, monkeypatch):
    jp, tp = _pipes(method, monkeypatch)
    assert tp.channelizer.method == method
    sj = jp.init_state()
    st = state_from_jax(tree_map(np.asarray, sj), "cpu")
    # two blocks through __call__ (the filter fill)
    for b in range(2):
        sj, (aj, dj) = jp(sj, jnp.asarray(X[b]))
        st, (at, dt) = tp(st, torch.as_tensor(X[b]))
        assert at.shape == np.asarray(aj).shape == (2, 3, tp.out_len(BLOCK))
        _close_spec(dt, dj)
    _close_state(st, sj)
    # scan_call over K blocks in 2-block sub-windows, from that state
    assert tp._subk(K) == jp._subk(K) == 2
    sj2, (aj, dj) = jp.scan_call(sj, jnp.asarray(X[2:]))
    st2, (at, dt) = tp.scan_call(st, torch.as_tensor(X[2:]))
    aj = np.asarray(aj)
    assert at.shape == aj.shape == (K, 2, 3, tp.out_len(BLOCK))
    np.testing.assert_allclose(at.numpy(), aj, atol=2e-4)
    assert dt.shape == (K, 1, 4096)
    _close_spec(dt.reshape(-1, 4096), np.asarray(dj).reshape(-1, 4096))
    _close_state(st2, sj2)
    # scan_repeat: one block K times
    sj3, (aj, dj) = jp.scan_repeat(sj, jnp.asarray(X[2]), K)
    st3, (at, dt) = tp.scan_repeat(st, torch.as_tensor(X[2]), K)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=2e-4)
    _close_spec(dt.reshape(-1, 4096), np.asarray(dj).reshape(-1, 4096))
    _close_state(st3, sj3)


def test_scan_repeat_is_scan_call_on_repeated_blocks(monkeypatch):
    """On the per-block front scan, scan_repeat of one block is scan_call
    of K copies of it (the port against itself: the same ops)."""
    _, tp = _pipes("pallas", monkeypatch)
    st = tp.init_state()
    st_r, (a_r, d_r) = tp.scan_repeat(st, torch.as_tensor(X[1]), K)
    st_c, (a_c, d_c) = tp.scan_call(st, torch.as_tensor(np.stack([X[1]] * K)))
    assert torch.equal(a_r, a_c) and torch.equal(d_r, d_c)
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
             state_to_numpy(st_r), state_to_numpy(st_c))
