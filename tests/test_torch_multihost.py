"""The port's multi-process execution (gloo ranks on the CPU).

Counterparts of tests/test_multihost.py (BASELINE config 5's mechanism:
the 64-channel channelizer + discriminator scan with its channel axis
over several processes) and of the reference's ``dryrun_multichip``.

Tolerances: the sharded scan within 1e-3 of the unsharded (the
reference's bound), against both packages' unsharded scans (the JAX
one after the channelizer's filter fill: see the test); the dry run asserts 1e-4 on
its own steady-state block.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from sdrtpu_torch.shard.multihost import (  # noqa: E402
    dryrun_multichip, run_processes, scaling_efficiency)

FS, IF_RATE, C, N = 10_000_000.0, 250_000.0, 64, 40_000
CENTERS = np.linspace(-4.5e6, 4.5e6, C)


def test_four_rank_64ch_scan(tmp_path):
    """The 64-channel channelizer + `Quadrature`, channel-sharded over 4
    ranks: every rank holds C/4 rows of each per-channel state leaf, and
    the gathered output is the unsharded scan's."""
    from sdrtpu.kernels.demod import Quadrature as JQuad
    from sdrtpu.shard.channelizer import Channelizer as JChan
    from sdrtpu_torch.graph.block import tree_map
    from sdrtpu_torch.kernels.demod import Quadrature
    from sdrtpu_torch.shard.channelizer import Channelizer

    rng = np.random.default_rng(7)
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
        np.complex64)
    jch, jq = JChan(CENTERS, FS, IF_RATE, N, method="fft"), JQuad(75000.0,
                                                                  IF_RATE)

    @jax.jit
    def jstep(a):
        _, y = jch(jch.init_state(), a)
        return jq(jq.init_state(), y)[1]

    ref_j = np.asarray(jstep(jnp.asarray(x)))
    ch = Channelizer(CENTERS, FS, IF_RATE, N, method="fft", device="cpu")
    quad = Quadrature(75000.0, IF_RATE, device="cpu")
    with torch.inference_mode():
        s1, y = ch(ch.init_state(), torch.as_tensor(x))
        s2, ref_t = quad(quad.init_state(), y)
    ref_t = ref_t.numpy()
    full_shapes = []
    tree_map(lambda t: full_shapes.append(tuple(t.shape)),
             {"ch": s1, "q": s2})

    ranks = run_processes(workers.scan64_rank, 4, tmp_path,
                          args=(4, CENTERS, FS, IF_RATE, x), device="cpu",
                          timeout=120)
    got = np.concatenate([r["a"] for r in sorted(
        ranks, key=lambda r: r["channel_index"])])
    assert got.shape == ref_j.shape == (C, N // 40)
    assert float(np.abs(got - ref_t).max()) < 1e-3
    # against JAX after the filter fill: the first (tpad - 1) / R IF
    # samples rise from ~1e-8 (the zero tail), where the discriminator's
    # angle turns the packages' last-bit differences (4e-8 here) into
    # whole radians
    fill = (ch.fused.tpad - 1) // ch.fused.ratio
    assert float(np.abs(got[:, fill:] - ref_j[:, fill:]).max()) < 1e-3
    # every per-channel leaf (the fold table, the rotator tables, the
    # discriminator's carry) holds C/4 rows on each rank; the rest whole
    want = [(C // 4,) + s[1:] if s and s[0] == C else s for s in full_shapes]
    assert sum(s != w for s, w in zip(full_shapes, want)) >= 4
    for r in ranks:
        assert r["state_shapes"] == want


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(tmp_path, n):
    res = dryrun_multichip(n, device="cpu", workdir=tmp_path)
    assert res["mesh"] == ([2, 2] if n == 4 else [n, 1])
    assert res["audio_shape"] == [2, 8, 48]
    assert res["max_abs_err"] < 1e-4


def test_scaling_efficiency_keys():
    calls = []

    def step(k):
        calls.append(k)
        return sum(range(k))

    r = scaling_efficiency(step, step, (1000,), (2000,), n_devices=2,
                           reps=2)
    assert set(r) == {"t_single", "t_sharded", "n_devices",
                      "weak_scaling_efficiency"}
    assert r["n_devices"] == 2 and r["t_single"] > 0 and r["t_sharded"] > 0
    assert calls.count(1000) == calls.count(2000) == 3  # warm + 2 reps


def test_a_failing_rank_is_reported(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_processes(workers.failing_rank, 2, tmp_path, device="cpu",
                      timeout=60)
