"""Stream-op protocol (PyTorch counterpart of ``sdrtpu/graph/block.py``).

    state0 = op.init_state()
    state1, y = op(state0, x)          # x: (..., n_in) -> y: (..., n_out)

``state`` is a nest of dicts and tuples of torch tensors on the op's
device: filter tails, oscillator phases, loop carries.  Ops run eagerly;
``scan_call`` over K stacked blocks is a Python loop of ``__call__``.
Scalar carries (e.g. a de-emphasis output of shape ``()``) broadcast to
their steady shape on the first block, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

Nest = Any


def tree_map(fn: Callable, *trees: Nest) -> Nest:
    """Apply ``fn`` leafwise over nests of dicts, tuples and lists; a
    ``None`` (an output that is switched off) stays ``None``."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_stack(outs: Sequence[Nest]) -> Nest:
    """Stack a list of same-structure output nests along a new axis 0."""
    return tree_map(lambda *leaves: torch.stack(leaves), *outs)


class StreamOp:
    """Base class (duck-typed; subclassing optional)."""

    def init_state(self) -> Nest:
        return ()

    def out_len(self, n: int) -> int:
        return n

    def __call__(self, state: Nest, x):  # pragma: no cover - interface
        raise NotImplementedError

    def scan_call(self, state: Nest, xs):
        """Process K stacked blocks ``xs: (K, ..., n)`` one after another.

        Returns the final state and the per-block outputs stacked along a
        new leading axis, as ``lax.scan`` of ``__call__`` does in the
        reference.
        """
        outs = []
        for xb in xs:
            state, y = self(state, xb)
            outs.append(y)
        return state, tree_stack(outs)


class Chain(StreamOp):
    """Sequential composition of stream ops; state is the tuple of member
    states, applied in order."""

    def __init__(self, ops: Sequence[StreamOp]):
        self.ops = list(ops)

    def init_state(self) -> Nest:
        return tuple(op.init_state() for op in self.ops)

    def out_len(self, n: int) -> int:
        for op in self.ops:
            n = op.out_len(n)
        return n

    def __call__(self, state, x):
        new_states = []
        for op, st in zip(self.ops, state):
            st, x = op(st, x)
            new_states.append(st)
        return tuple(new_states), x
