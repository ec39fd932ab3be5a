"""Overlap-save halo exchange for time-axis sharding (torch.distributed).

PyTorch counterpart of ``sdrtpu/shard/overlap.py``.  When the time axis
of a stream is split across ranks, each rank's FIR needs the last
``taps - 1`` samples of its left neighbour's span: the *halo*.  It is
passed point to point over the mesh's ``time`` group
(`halo_exchange_left`, the counterpart of ``lax.ppermute``).

The global stream tail (from the previous block of the whole stream) is
used by time-rank 0; the new global tail is the last time-rank's tail,
which every rank receives as the sum over the time group of each rank's
contribution (zeros but on the last rank), as the reference's ``psum``.

Each function takes the GLOBAL block, as the reference's does, copies
only this rank's span to its device, and returns this rank's part of
the output (`mesh.all_gather` puts the spans back together).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..graph.block import tree_map
from ..kernels.fir import correlate_valid
from .mesh import Mesh, _real, all_reduce_sum, local_span

_TWO_PI = 2.0 * np.pi


def halo_exchange_left(x_local: torch.Tensor, halo_len: int, mesh: Mesh,
                       axis_name: str = "time") -> torch.Tensor:
    """Each time-rank's left neighbour's trailing ``halo_len`` samples.

    Time-rank 0 receives zeros (a fresh stream's zero history).  One
    batched send/receive per rank: every rank but the last sends its
    tail right, every rank but the first receives.
    """
    tail = x_local[..., -halo_len:].contiguous()
    left = torch.zeros_like(tail)
    n, i = mesh.size(axis_name), mesh.index(axis_name)
    if n == 1:
        return left
    members, group = mesh.members(axis_name), mesh.group(axis_name)
    ops = []
    if i < n - 1:
        ops.append(dist.P2POp(dist.isend, _real(tail), members[i + 1],
                              group))
        mesh.traffic["halo"] += tail.nbytes
    recv = _real(left)  # a view: receiving into it fills ``left``
    if i > 0:
        ops.append(dist.P2POp(dist.irecv, recv, members[i - 1], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return left


def _last_rank_tail(mesh: Mesh, x_local: torch.Tensor, n_tail: int,
                    axis_name: str) -> torch.Tensor:
    """The last time-rank's trailing ``n_tail`` samples, on every rank."""
    contrib = x_local[..., -n_tail:]
    if mesh.index(axis_name) != mesh.size(axis_name) - 1:
        contrib = torch.zeros_like(contrib)
    return all_reduce_sum(mesh, contrib.contiguous(), axis_name)


def time_sharded_fir(mesh: Mesh, taps, x, global_tail: torch.Tensor,
                     axis_name: str = "time"):
    """Streaming FIR over a time-sharded block.

    ``x``: the (n,) global block; ``global_tail``: (taps-1,) carried from
    the previous stream block (the same on every rank).  Returns
    ``(new_global_tail, y_local)``, ``y_local`` this rank's span of the
    output, from the shift-and-add `correlate_valid` (the same sum, in
    the same tap order, as an unsharded ``Fir(method="direct")``).
    """
    halo = len(taps) - 1
    x_local = local_span(mesh, x, axis_name)
    left = halo_exchange_left(x_local, halo, mesh, axis_name)
    if mesh.index(axis_name) == 0:
        left = global_tail.to(mesh.device, x_local.dtype)
    y_local = correlate_valid(torch.cat([left, x_local], dim=-1), taps)
    return _last_rank_tail(mesh, x_local, halo, axis_name), y_local


def time_sharded_relock(mesh: Mesh, op, x, x_tail: torch.Tensor,
                        relock: int, axis_name: str = "time"):
    """Time-shard a SEQUENTIAL-carry stream op via prefix relock.

    Feedback loops (PLL, AGC, de-emphasis, clock recovery) carry state
    that cannot be split exactly across time spans.  Every rank runs
    ``op`` from a reset state over [``relock``-sample prefix ++ local
    span] and drops the prefix outputs: the loops re-acquire on the
    prefix, so only the residual acquisition error after ``relock``
    samples survives.  The prefix comes from the left neighbour; rank 0
    uses the carried ``x_tail`` (the previous global block's trailing
    input samples; zeros for a fresh stream).  No op state crosses a
    rank or block boundary: the only carried value is the input tail.

    ``op`` must be rate-preserving (out_len(n) == n) with its time axis
    last in every output.  Returns ``(new_x_tail, y_local)``.
    """
    x_local = local_span(mesh, x, axis_name)
    left = halo_exchange_left(x_local, relock, mesh, axis_name)
    if mesh.index(axis_name) == 0:
        left = x_tail.to(mesh.device, x_local.dtype)
    _, y = op(op.init_state(), torch.cat([left, x_local], dim=-1))
    y = tree_map(lambda a: a[..., relock:], y)
    return _last_rank_tail(mesh, x_local, relock, axis_name), y


def time_sharded_channelizer(mesh: Mesh, chain, x, state,
                             axis_name: str = "time"):
    """Run an `FftDecimatorChain` with its time axis sharded over ``mesh``.

    ``chain`` must be built with ``block_len = N / n_time`` (each rank's
    local span); ``x`` is the (N,) global wideband block; ``state`` is
    this rank's chain state: the whole of `chain.init_state()` (or a
    previous call's), or its channel rows from `shard_channel_state` on
    a mesh whose channel axis is larger than 1.

    Two things cross rank boundaries:

    - the convolution halo: each rank needs the previous rank's last
      ``tpad - 1`` input samples (`halo_exchange_left`); time-rank 0
      uses the carried global stream tail;
    - the residual IF-rate rotator phase: time-rank ``s`` starts ``s *
      block_len`` input samples into the global block, so its phase is
      ``mod(phase + s * delta, 2pi)`` in float32, ``delta`` the chain
      rotator's per-local-block advance: computed locally, with no
      communication.

    Returns ``(new_state, y_local)``: ``y_local`` (C_local, N / (n_time
    R)) this rank's span; ``new_state`` the same on every time-rank
    (tail = the last rank's input tail, phase advanced by the global
    block).
    """
    halo = chain.tpad - 1
    n, i = mesh.size(axis_name), mesh.index(axis_name)
    x_local = local_span(mesh, x, axis_name).to(torch.complex64)
    left = halo_exchange_left(x_local, halo, mesh, axis_name)
    if i == 0:
        left = state["tail"]
    rot = state["rot"]
    phase, delta = rot["phase"], rot["delta"]
    local = {**state, "tail": left,
             "rot": {**rot, "phase": torch.remainder(
                 phase + delta * float(i), _TWO_PI)}}
    _, y = chain(local, x_local)
    new_state = {**state,
                 "tail": _last_rank_tail(mesh, x_local, halo, axis_name),
                 "rot": {**rot, "phase": torch.remainder(
                     phase + n * delta, _TWO_PI)}}
    return new_state, y
