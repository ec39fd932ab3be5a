"""Process mesh construction and sharding helpers (torch.distributed).

PyTorch counterpart of ``sdrtpu/shard/mesh.py``.  The framework's
parallel axes:

- ``channel``: VFOs / scanner channels.  Embarrassingly parallel; no
  collectives.
- ``time``: successive spans of the IQ stream.  Convolutions need halo
  exchange between neighbour spans (`overlap.py`); scan carries stay per
  channel.

A mesh is a (channel, time) grid of process ranks, one rank per device,
laid out as the reference lays out its devices (rank ``r`` of the mesh
sits at channel ``r // n_time``, time ``r % n_time``).  Each rank holds
plain local tensors, as ``shard_map``'s manual axes do (no DTensor: the
hand kernels' ctypes launch takes a plain tensor), and talks to the
others only through the helpers here and in `overlap.py`.  An axis of
size 1 gets no process group and its collectives are no-ops, so a
(1, 1) mesh runs in one process without ``torch.distributed``.

Every collective adds the bytes this rank moves to ``Mesh.traffic``
(``"halo"``: sent to a neighbour; ``"allgather"``: received from the
others; ``"allreduce"``: the reduced tensor's size), which is how a run
reports what crossed between devices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..graph.block import tree_map


class Mesh:
    """A ("channel", "time") grid of ranks and this process's place in it.

    ``ranks[c][t]`` is the global rank at channel ``c``, time ``t``;
    ``device`` is the device this rank's tensors live on.
    """

    axis_names = ("channel", "time")

    def __init__(self, ranks, device):
        self.ranks = [list(row) for row in ranks]
        n_channel, n_time = len(self.ranks), len(self.ranks[0])
        self.shape = {"channel": n_channel, "time": n_time}
        self.device = torch.device(device)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        flat = [r for row in self.ranks for r in row]
        if self.rank not in flat:
            raise ValueError(f"rank {self.rank} is not in the mesh {ranks}")
        pos = flat.index(self.rank)
        self._index = {"channel": pos // n_time, "time": pos % n_time}
        self._groups: dict = {}
        self.traffic = {"halo": 0, "allgather": 0, "allreduce": 0}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._index[axis]

    def members(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        c, t = self._index["channel"], self._index["time"]
        if axis == "time":
            return list(self.ranks[c])
        return [row[t] for row in self.ranks]

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None when the
        axis has size 1)."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh(channel={self.shape['channel']}, "
                f"time={self.shape['time']}, rank={self.rank}, "
                f"device={self.device})")


def _default_device():
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return torch.device("cpu")
    resolve_device("cuda")  # raises without a card
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_channel: int | None = None, n_time: int = 1, devices=None,
              device=None) -> Mesh:
    """Build a ("channel", "time") mesh over the process group.

    ``devices``: the global ranks to lay out (default: every rank of the
    default group); ``device``: where this rank's tensors live (default:
    its CUDA card under NCCL, the CPU under gloo; ``"cuda"`` when
    ``torch.distributed`` is not initialised).  Every rank of the default
    group must call this, in the same order as its other mesh builds:
    each axis's subgroups are created by every rank in one fixed order,
    and each group then runs one warm-up all-reduce, so that its first
    point-to-point exchange finds the communicator ready.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    if n_channel is None:
        n_channel = len(ranks) // n_time
    if n_channel * n_time > len(ranks):
        raise ValueError(f"a ({n_channel}, {n_time}) mesh needs "
                         f"{n_channel * n_time} ranks, have {len(ranks)}")
    grid = np.asarray(ranks[: n_channel * n_time]).reshape(n_channel, n_time)
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups = {}
    for axis, lines in (("time", grid.tolist()),
                        ("channel", grid.T.tolist())):
        if len(lines[0]) == 1:
            continue
        for line in lines:  # every rank creates every group, in order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    # raises for a rank outside the grid, once the others have their groups
    mesh = Mesh(grid.tolist(), resolve_device(
        device if device is not None else _default_device()))
    mesh._groups = groups
    for group in groups.values():
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)
    return mesh


def _real(t: torch.Tensor) -> torch.Tensor:
    """A contiguous real view for the wire (complex as (..., 2) pairs)."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str,
               dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated in axis order
    along ``dim`` (each rank's piece must have the same shape)."""
    n = mesh.size(axis)
    if n == 1:
        return t
    wire = _real(t)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=mesh.group(axis))
    mesh.traffic["allgather"] += (n - 1) * wire.nbytes
    if t.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat(parts, dim=dim)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum of every rank's ``t`` along ``axis`` (the reference's psum)."""
    if mesh.size(axis) == 1:
        return t
    wire = _real(t).clone()
    dist.all_reduce(wire, group=mesh.group(axis))
    mesh.traffic["allreduce"] += wire.nbytes
    return torch.view_as_complex(wire) if t.is_complex() else wire


def channel_sharding(mesh: Mesh):
    """Leading-axis channel sharding: a function giving this rank its rows
    of a (C, ...) array, on the mesh's device."""
    n, c = mesh.size("channel"), mesh.index("channel")

    def place(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"{rows} channel rows do not split over {n} "
                             f"channel ranks")
        k = rows // n
        return x[c * k:(c + 1) * k].to(mesh.device).clone()

    return place


def replicated(mesh: Mesh):
    """Replication: a function giving this rank the whole array on the
    mesh's device."""
    def place(x):
        if isinstance(x, torch.Tensor):
            return x.to(mesh.device).clone()
        return torch.as_tensor(np.array(x, copy=True), device=mesh.device)

    return place


def shard_channel_state(mesh: Mesh, state, n_channels: int):
    """This rank's part of ``state``: its rows of every leaf whose leading
    dimension is ``n_channels``, every other leaf whole, on the mesh's
    device.  Leaves may be numpy arrays or tensors on any device."""
    cs, rep = channel_sharding(mesh), replicated(mesh)

    def place(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == n_channels:
            return cs(x)
        return rep(x)

    return tree_map(place, state)


def local_span(mesh: Mesh, x, axis: str = "time") -> torch.Tensor:
    """This rank's span of the last axis of a global block ``x`` (numpy or
    a tensor on any device), copied alone to the mesh's device."""
    n, i = mesh.size(axis), mesh.index(axis)
    N = x.shape[-1]
    if N % n:
        raise ValueError(f"block of {N} does not split over {n} {axis} ranks")
    span = N // n
    piece = x[..., i * span:(i + 1) * span]
    if isinstance(piece, torch.Tensor):
        return piece.to(mesh.device).contiguous()
    return torch.as_tensor(np.ascontiguousarray(piece), device=mesh.device)
