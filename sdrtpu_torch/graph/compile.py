"""Host-boundary wrapper for a stream op (counterpart of
``sdrtpu/graph/compile.py``).

`CompiledOp` takes host numpy state and blocks in, runs the op on its
device, and gives host numpy state and outputs back: the shape of the
reference's ``CompiledOp`` for callers that keep state on the host.  It
compiles nothing (each op already runs its kernels eagerly); the name is
kept so a reader finds the counterpart.

The reference's ``CplxPair``, ``realify`` and ``complexify`` have no
counterpart: they exist because its TPU backend cannot carry complex
arrays across the host boundary, and torch carries complex64 there as it
is.  Its ``to_numpy`` is `convert.to_numpy` (one leaf) and
`convert.state_to_numpy` (a nest).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import state_from_jax, state_to_numpy, to_numpy
from .block import tree_map


class CompiledOp:
    """A stream op with host numpy state and I/O.

    ``init_state()`` is the op's initial state as numpy; ``__call__(state,
    x)`` takes numpy state (or any nest `convert.state_from_jax` takes)
    and a numpy or tensor block, runs ``op`` on ``device`` (default: the
    op's) under ``torch.inference_mode`` and returns ``(state, y)`` as
    numpy.
    """

    def __init__(self, op, device=None):
        self.op = op
        self.device = torch.device(device if device is not None
                                   else op.device)

    def init_state(self):
        return state_to_numpy(self.op.init_state())

    def __call__(self, state, x):
        st = state_from_jax(state, device=self.device)
        x = (x if isinstance(x, torch.Tensor)
             else torch.as_tensor(np.asarray(x))).to(self.device)
        with torch.inference_mode():
            st, y = self.op(st, x)
        return state_to_numpy(st), tree_map(to_numpy, y)
