"""The port's time and channel sharding (torch.distributed, gloo ranks on
the CPU) against sdrtpu's shard_map on the 8 virtual CPU devices.

Counterparts of tests/test_shard.py at its sizes, over 2 and 4 ranks.
The JAX side runs here; each rank is a fresh process that imports only
the port (tests/torch_dist_workers.py) and gets the same seeded input
and the reference's initial state as numpy.

Tolerances:
- `time_sharded_fir`: 1e-6 of the JAX output; bit-equal to the port's
  own unsharded ``Fir(method="direct")``, which sums the same taps in
  the same order;
- `time_sharded_channelizer`: 1e-5 of the peak against JAX's on the same
  mesh (the same local plan; the port's channelizer test holds the
  unsharded chain so), and tests/test_shard.py's 4e-3 of the peak
  against the unsharded chain; the carried state 2e-6;
- `ShardedWbfmPipeline`: blocks >= 3 within 1e-4 (tests/test_shard.py's
  bound; blocks 0-2 are the filter-fill transient);
- prefix relock: the reference's own bounds, SNR > 40 dB (WFM with its
  PLL) and 2e-5 (de-emphasis), against the unsharded op.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from sdrtpu.kernels import taps as tapsmod  # noqa: E402
from sdrtpu.shard.mesh import make_mesh as jmake_mesh  # noqa: E402
from sdrtpu_torch.shard.multihost import run_processes  # noqa: E402

TIMEOUT = 240  # seconds, one session of ranks
MESH = {2: (1, 2), 4: (2, 2)}  # the channelizer's and flagship's (C, T)
FS_WB, FS_IF, FS_AF = 2_000_000.0, 250_000.0, 48_000.0
RELOCK_WFM, RELOCK_DEEMPH = 6000, 2048


def _stages(fs, f_if):
    from sdrtpu.kernels.resample import RationalResampler

    rr = RationalResampler(fs, f_if)
    return [(np.asarray(s.taps), s.decimation) for s in rr.predecim.stages]


@functools.cache
def _fir_case():
    h = tapsmod.low_pass(0.25, 0.1, 1.0)
    x = np.random.default_rng(21).standard_normal(4096).astype(np.float32)
    return h, list(x.reshape(2, 2048))


@functools.cache
def _chan_case(n_channel, n_time):
    """Offsets, stages, local span, two global blocks of noise and the
    reference's initial state of the local-span chain."""
    from sdrtpu.shard.channelizer import FftDecimatorChain as JChain

    n_local = 8000
    N = n_time * n_local
    offsets = (np.array([-700e3, -50e3, 412e3, 600e3]) if n_channel > 1
               else np.array([-700e3, -50e3, 412e3]))
    stages = _stages(FS_WB, FS_IF)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(2 * N)
         + 1j * rng.standard_normal(2 * N)).astype(np.complex64)
    state0 = JChain(offsets, FS_WB, stages, n_local).init_state()
    return offsets, stages, n_local, list(x.reshape(2, N)), state0


def _flagship_signal(fs, offs, n):
    """tests/test_shard.py's flagship signal: a stereo WFM station at each
    offset."""
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex128)
    for i, f0 in enumerate(offs):
        L = np.sin(2 * np.pi * (400 + 200 * i) * t)
        R = np.sin(2 * np.pi * (900 + 200 * i) * t)
        mpx = (0.45 * (L + R) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (L - R) * np.sin(2 * np.pi * 38000 * t))
        ph = np.cumsum(2 * np.pi * 75000.0 * mpx / fs)
        x += 0.4 * np.exp(1j * (2 * np.pi * f0 * t + ph))
    return x.astype(np.complex64)


@functools.cache
def _flag_case(n_channel, n_time):
    """tests/test_shard.py's flagship case (4 VFOs off 2 Msps, five
    blocks of 2000) and the reference's sharded pipeline on the same
    mesh shape, with its initial state."""
    from sdrtpu.shard.flagship import ShardedWbfmPipeline

    block, n_blocks = 2000, 5
    offs = np.linspace(-0.35, 0.35, 4) * FS_WB
    x = _flagship_signal(FS_WB, offs, n_blocks * block)
    mesh = jmake_mesh(n_channel=n_channel, n_time=n_time)
    sh = ShardedWbfmPipeline(offs, FS_WB, block, mesh)
    return offs, block, list(x.reshape(n_blocks, block)), mesh, sh


@functools.cache
def _wfm_case():
    """Two global blocks of 32 000 samples of a stereo WFM station at the
    IF rate, and the unsharded reference's stereo output over both."""
    from sdrtpu.kernels.wfm import BroadcastFm

    n = 64000
    t = np.arange(n) / FS_IF
    L = np.sin(2 * np.pi * 440.0 * t)
    R = np.sin(2 * np.pi * 1200.0 * t)
    mpx = (0.45 * (L + R) / 2 + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * ((L - R) / 2) * np.sin(2 * np.pi * 38000.0 * t))
    ph = np.cumsum(2 * np.pi * 75000.0 * mpx / FS_IF)
    blocks = list((0.8 * np.exp(1j * ph)).astype(np.complex64).reshape(2, -1))
    op = BroadcastFm(75000.0, FS_IF, stereo=True, low_pass=True,
                     pilot_mode="pll")
    step = jax.jit(op.__call__)
    st, ref = op.init_state(), []
    for blk in blocks:
        st, (y, _) = step(st, jnp.asarray(blk))
        ref.append(np.asarray(y))
    return blocks, np.concatenate(ref, axis=-1)


@functools.cache
def _deemph_case():
    x = np.random.default_rng(3).standard_normal(32000).astype(np.float32)
    return list(x.reshape(2, 16000))


def _jobs(n):
    """Every port-side run at ``n`` ranks, for one session of ranks."""
    nc, nt = MESH[n]
    h, fir_blocks = _fir_case()
    offsets, stages, n_local, chan_blocks, chan_state = _chan_case(nc, nt)
    offs, block, flag_blocks, _, sh = _flag_case(nc, nt)
    wfm_blocks = list(np.asarray(_wfm_case()[0]))
    return [
        ("fir", "fir_rank", (n, h, fir_blocks)),
        ("chan", "channelizer_rank", (nc, nt, offsets, FS_WB, stages,
                                      n_local, chan_state, chan_blocks)),
        ("flag", "flagship_rank", (nc, nt, offs, FS_WB, block,
                                   sh.init_state(), flag_blocks)),
        ("wfm", "relock_rank", ("wfm", n, RELOCK_WFM, wfm_blocks)),
        ("deemph", "relock_rank", ("deemph", n, RELOCK_DEEMPH,
                                   _deemph_case())),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(n)``: the port's results of every job at ``n`` gloo ranks
    (one session of processes per rank count, run once), by rank."""
    done = {}

    def get(n):
        if n not in done:
            done[n] = run_processes(
                workers.session_rank, n, tmp_path_factory.mktemp(f"r{n}"),
                args=(_jobs(n),), device="cpu", timeout=TIMEOUT)
        return done[n]

    return get


@pytest.mark.parametrize("n_time", [2, 4])
def test_time_sharded_fir_streams(ranks, n_time):
    from sdrtpu.shard.overlap import time_sharded_fir
    from sdrtpu_torch.kernels.fir import Fir

    h, blocks = _fir_case()
    mesh = jmake_mesh(n_channel=1, n_time=n_time)
    tail = jnp.zeros(len(h) - 1, jnp.float32)
    step = jax.jit(functools.partial(time_sharded_fir, mesh, h))
    ref = []
    for blk in blocks:
        tail, y = step(jnp.asarray(blk), tail)
        ref.append(np.asarray(y))

    got = ranks(n_time)[0]["fir"]
    for g, r in zip(got["ys"], ref):
        np.testing.assert_allclose(g, r, atol=1e-6)
    np.testing.assert_array_equal(got["tail"], np.asarray(tail))
    op = Fir(h, dtype=torch.float32, method="direct", device="cpu")
    _, y_ref = op(op.init_state(), torch.as_tensor(np.concatenate(blocks)))
    np.testing.assert_array_equal(np.concatenate(got["ys"]), y_ref.numpy())
    # time-rank 0 sent its float32 tail right once a block
    assert got["traffic"]["halo"] == 2 * (len(h) - 1) * 4


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_channelizer(ranks, n):
    from sdrtpu.shard.channelizer import FftDecimatorChain as JChain
    from sdrtpu.shard.overlap import time_sharded_channelizer
    from sdrtpu_torch.convert import state_from_jax
    from sdrtpu_torch.shard.channelizer import FftDecimatorChain

    n_channel, n_time = MESH[n]
    offsets, stages, n_local, blocks, state0 = _chan_case(n_channel, n_time)
    local = JChain(offsets, FS_WB, stages, n_local)
    mesh = jmake_mesh(n_channel=n_channel, n_time=n_time)
    step = jax.jit(lambda s, a: time_sharded_channelizer(mesh, local, a, s))
    st, ref = state0, []
    for blk in blocks:
        st, y = step(st, jnp.asarray(blk))
        ref.append(np.asarray(y))

    got = [r["chan"] for r in ranks(n)]
    for g, r in zip(got[0]["ys"], ref):
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max())
    C_local = len(offsets) // n_channel
    for rank in got:
        c = rank["coords"][0]
        rows = slice(c * C_local, (c + 1) * C_local)
        np.testing.assert_allclose(rank["state"]["tail"],
                                   np.asarray(st["tail"]), atol=0)
        np.testing.assert_allclose(rank["state"]["rot"]["phase"],
                                   np.asarray(st["rot"]["phase"])[rows],
                                   atol=2e-6)

    # against the port's own unsharded chain on the global blocks
    N = n_time * n_local
    full = FftDecimatorChain(offsets, FS_WB, stages, N, device="cpu")
    sf = state_from_jax(JChain(offsets, FS_WB, stages, N).init_state(),
                        "cpu")
    for g, blk in zip(got[0]["ys"], blocks):
        sf, yf = full(sf, torch.as_tensor(blk))
        np.testing.assert_allclose(g, yf.numpy(),
                                   atol=4e-3 * yf.abs().max().item())


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_flagship_matches_reference(ranks, n):
    from sdrtpu.shard.mesh import shard_channel_state

    offs, block, blocks, mesh, sh = _flag_case(*MESH[n])
    st = shard_channel_state(mesh, sh.init_state(), 4)
    step = jax.jit(sh.__call__)
    ref = []
    for blk in blocks:
        st, a = step(st, jnp.asarray(blk))
        ref.append(np.asarray(a))

    got = ranks(n)[0]["flag"]
    errs = [float(np.abs(g - r).max()) for g, r in zip(got, ref)]
    assert got[0].shape == ref[0].shape == (2, 4, 48)
    assert max(errs[3:]) < 1e-4, errs


@pytest.mark.parametrize("n_time", [2, 4])
def test_prefix_relock_wfm_pll_chain(ranks, n_time):
    """The WFM stereo demodulator with its SEQUENTIAL pilot PLL, time-
    sharded by prefix relock: the residual sits > 40 dB under the audio of
    the unsharded reference, streaming across two global blocks."""
    _, ref = _wfm_case()
    got = np.concatenate(ranks(n_time)[0]["wfm"], axis=-1)
    assert got.shape == ref.shape
    skip = 12000  # the global stream's own start-up transient
    err = got[:, skip:] - ref[:, skip:]
    snr = 10 * np.log10(np.sum(ref[:, skip:] ** 2)
                        / max(np.sum(err ** 2), 1e-30))
    assert snr > 40.0, snr


@pytest.mark.parametrize("n_time", [2, 4])
def test_prefix_relock_tail_carried(ranks, n_time):
    """The carried value is the input tail: no seam at block boundaries."""
    from sdrtpu.kernels.iir import Deemphasis

    blocks = _deemph_case()
    op = Deemphasis(50e-6, FS_AF)
    st = op.init_state()
    ref = []
    for blk in blocks:
        st, y = op(st, jnp.asarray(blk))
        ref.append(np.asarray(y))
    ref = np.concatenate(ref)

    got = np.concatenate(ranks(n_time)[0]["deemph"])
    np.testing.assert_allclose(got[RELOCK_DEEMPH:], ref[RELOCK_DEEMPH:],
                               atol=2e-5)


def test_fractional_ratio_raises():
    from sdrtpu.shard.flagship import ShardedWbfmPipeline as JSharded
    from sdrtpu_torch.shard.flagship import ShardedWbfmPipeline
    from sdrtpu_torch.shard.mesh import make_mesh

    fs, block = 2_400_000.0, 48_000  # 2.4 Msps -> 250 kHz is 48/5
    offs = [-300e3, 300e3]
    with pytest.raises(ValueError, match="INTEGER"):
        JSharded(offs, fs, block, jmake_mesh(n_channel=1, n_time=1))
    with pytest.raises(ValueError, match="INTEGER"):
        ShardedWbfmPipeline(offs, fs, block, make_mesh(1, 1, device="cpu"))


def test_one_rank_flagship_runs_the_pipelines_if_back_end():
    """The sharded flagship's IF back end is the unsharded pipeline's
    (its `GraphedStep`, eager on the CPU): the bits of the demod,
    resampler and de-emphasis called one after another."""
    from sdrtpu_torch.graph.block import tree_map
    from sdrtpu_torch.shard.flagship import ShardedWbfmPipeline
    from sdrtpu_torch.shard.mesh import make_mesh

    def before(self, st, state, y):
        st["demod"], (stereo, _) = self.demod(state["demod"], y)
        st["audio"], a = self.audio_resamp(state["audio"], stereo)
        st["deemph"], a = self.deemph(state["deemph"], a)
        return a

    block, n_blocks = 2000, 3
    offs = np.linspace(-0.35, 0.35, 4) * FS_WB
    x = _flagship_signal(FS_WB, offs, n_blocks * block)
    mesh = make_mesh(1, 1, device="cpu")
    now = ShardedWbfmPipeline(offs, FS_WB, block, mesh)
    old = ShardedWbfmPipeline(offs, FS_WB, block, mesh)
    old.pipe._if_back_end = before.__get__(old.pipe)
    st_n = st_o = now.init_state()
    for blk in x.reshape(n_blocks, block):
        st_n, a_n = now(st_n, blk)
        st_o, a_o = old(st_o, blk)
        assert a_n.shape == (2, 4, 48) and torch.equal(a_n, a_o)

    def same(p, q):
        assert p.shape == q.shape and torch.equal(p, q)

    for k in ("demod", "audio", "deemph"):
        tree_map(same, st_n[k], st_o[k])
    assert now.pipe._if_graph.eager_passes == n_blocks


def test_one_rank_mesh_is_the_plain_chain():
    """A (1, 1) mesh runs without torch.distributed: every collective is a
    no-op and the sharded channelizer is the plain chain."""
    from sdrtpu_torch.shard.channelizer import FftDecimatorChain
    from sdrtpu_torch.shard.mesh import make_mesh
    from sdrtpu_torch.shard.overlap import time_sharded_channelizer

    fs, n = 2_000_000.0, 8000
    offsets = np.array([-700e3, 412e3])
    chain = FftDecimatorChain(offsets, fs, _stages(fs, FS_IF), n,
                              device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    x = np.random.default_rng(5).standard_normal(2 * n).astype(np.complex64)
    st_s = st_u = chain.init_state()
    for blk in x.reshape(2, n):
        st_s, ys = time_sharded_channelizer(mesh, chain, blk, st_s)
        st_u, yu = chain(st_u, torch.as_tensor(blk))
        assert torch.equal(ys, yu)
    assert torch.equal(st_s["tail"], st_u["tail"])
    assert mesh.traffic == {"halo": 0, "allgather": 0, "allreduce": 0}
