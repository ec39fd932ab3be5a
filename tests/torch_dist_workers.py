"""Rank functions for the port's multi-process CPU tests.

`sdrtpu_torch.shard.multihost.run_processes` starts each rank as a fresh
process that imports this module (and only the port: no JAX), joins a
gloo group and calls one of these with numpy arguments.  Each returns
numpy results; the tests hold them against the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrtpu_torch.convert import state_from_jax, state_to_numpy
from sdrtpu_torch.shard.mesh import all_gather, make_mesh, shard_channel_state


def session_rank(jobs):
    """Run each ``(name, function name, args)`` of ``jobs`` in turn (one
    process start for every job of a test module); ``{name: result}``."""
    return {name: globals()[fn](*args) for name, fn, args in jobs}


def _mesh(n_channel, n_time):
    return make_mesh(n_channel=n_channel, n_time=n_time, device="cpu")


def fir_rank(n_time, taps, blocks):
    """`time_sharded_fir` streamed over ``blocks``; rank 0 returns the
    gathered output of each block and the final tail."""
    from sdrtpu_torch.shard.overlap import time_sharded_fir

    mesh = _mesh(1, n_time)
    tail = torch.zeros(len(taps) - 1, dtype=torch.float32)
    ys = []
    for blk in blocks:
        tail, y = time_sharded_fir(mesh, taps, blk, tail)
        ys.append(all_gather(mesh, y, "time").numpy())
    return {"ys": ys, "tail": tail.numpy(), "traffic": dict(mesh.traffic)}


def channelizer_rank(n_channel, n_time, offsets, fs, stages, n_local,
                     state, blocks):
    """`time_sharded_channelizer` streamed over ``blocks`` from the
    reference's state; rank 0 returns the whole output, every rank its
    carried state and mesh coordinates."""
    from sdrtpu_torch.shard.channelizer import FftDecimatorChain
    from sdrtpu_torch.shard.overlap import time_sharded_channelizer

    mesh = _mesh(n_channel, n_time)
    chain = FftDecimatorChain(offsets, fs, stages, n_local, device="cpu")
    st = shard_channel_state(mesh, state_from_jax(state, "cpu"), len(offsets))
    ys = []
    for blk in blocks:
        st, y = time_sharded_channelizer(mesh, chain, blk, st)
        y = all_gather(mesh, all_gather(mesh, y, "time"), "channel", dim=0)
        ys.append(y.numpy())
    return {"ys": ys, "state": state_to_numpy(st),
            "coords": (mesh.index("channel"), mesh.index("time"))}


def flagship_rank(n_channel, n_time, offsets, fs, block, state, blocks):
    """`ShardedWbfmPipeline` from the reference's initial state; the
    audio of every channel after each block."""
    from sdrtpu_torch.shard.flagship import ShardedWbfmPipeline

    mesh = _mesh(n_channel, n_time)
    sh = ShardedWbfmPipeline(offsets, fs, block, mesh)
    st = shard_channel_state(mesh, state_from_jax(state, "cpu"), len(offsets))
    out = []
    with torch.inference_mode():
        for blk in blocks:
            st, a = sh(st, blk)
            out.append(all_gather(mesh, a, "channel", dim=1).numpy())
    return out


def relock_rank(kind, n_time, relock, blocks):
    """`time_sharded_relock` of the WFM stereo demodulator with its pilot
    PLL ("wfm", 250 kHz) or of the 50 us de-emphasis ("deemph", 48 kHz)."""
    from sdrtpu_torch.kernels.iir import Deemphasis
    from sdrtpu_torch.kernels.wfm import BroadcastFm
    from sdrtpu_torch.shard.overlap import time_sharded_relock

    mesh = _mesh(1, n_time)
    if kind == "wfm":
        fm = BroadcastFm(75000.0, 250_000.0, stereo=True, low_pass=True,
                         pilot_mode="pll", device="cpu")

        class StereoOnly:
            def init_state(self):
                return fm.init_state()

            def __call__(self, state, x):
                st, (stereo, _) = fm(state, x)
                return st, stereo

        op, dtype = StereoOnly(), torch.complex64
    else:
        op, dtype = Deemphasis(50e-6, 48000.0, device="cpu"), torch.float32
    tail = torch.zeros(relock, dtype=dtype)
    out = []
    for blk in blocks:
        tail, y = time_sharded_relock(mesh, op, blk, tail, relock)
        out.append(all_gather(mesh, y, "time").numpy())
    return out


def scan64_rank(n_channel, centers, fs, if_rate, x):
    """The 64-channel channelizer + discriminator scan, channel-sharded:
    each rank's output rows and the leading sizes of its state leaves."""
    from sdrtpu_torch.graph.block import tree_map
    from sdrtpu_torch.kernels.demod import Quadrature
    from sdrtpu_torch.shard.channelizer import Channelizer

    mesh = _mesh(n_channel, 1)
    C = len(centers)
    ch = Channelizer(centers, fs, if_rate, x.shape[-1], method="fft",
                     device="cpu")
    quad = Quadrature(75000.0, if_rate, device="cpu")
    st = shard_channel_state(
        mesh, {"ch": ch.init_state(), "q": quad.init_state()}, C)
    with torch.inference_mode():
        s1, y = ch(st["ch"], torch.as_tensor(x))
        s2, a = quad(st["q"], y)
    rows = []
    tree_map(lambda t: rows.append(tuple(t.shape)),
             {"ch": s1, "q": s2})
    return {"a": a.numpy(), "channel_index": mesh.index("channel"),
            "state_shapes": rows}


def failing_rank():
    """Rank 1 raises; the parent must report it."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    return "ok"
