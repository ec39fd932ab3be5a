"""Carry stream state between ``sdrtpu`` and ``sdrtpu_torch``.

A pipeline's state is everything it carries from one block to the next:
filter tails, rotator phases, the channelizer's fold table ``hf``, the
demodulator and de-emphasis carries.  Both packages lay it out the same
way (dicts and tuples with the same keys and shapes), so a state converts
leaf by leaf.  With these, both packages can start from one mid-stream
state.

``state_from_jax`` takes the reference's state as numpy leaves (its
``init_state()``, or ``np.asarray`` of a carried state; any array with
``__array__`` works) and returns torch tensors on ``device``.
``state_to_numpy`` goes back.  Neither imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .graph.block import tree_map


def state_from_jax(state, device="cuda"):
    """Nest of array leaves -> the same nest of torch tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda leaf: torch.as_tensor(np.array(leaf, copy=True), device=dev),
        state)


def state_to_numpy(state):
    """Nest of torch tensors -> the same nest of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
