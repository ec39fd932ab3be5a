"""Carry stream state between ``sdrtpu`` and ``sdrtpu_torch``.

A pipeline's state is everything it carries from one block to the next:
filter tails, rotator phases, the channelizer's fold table ``hf``, the
demodulator and de-emphasis carries.  Both packages lay it out the same
way (dicts and tuples with the same keys and shapes), so a state converts
leaf by leaf.  With these, both packages can start from one mid-stream
state.

``state_from_jax`` takes the reference's state as numpy leaves (its
``init_state()``, or ``np.asarray`` of a carried state; any array with
``__array__`` works) and returns torch tensors on ``device``.  Scalar
leaves (a mixer phase, an AGC average, the CTCSS detector's booleans and
int32 tone, the M&M's int32 offset and complex64 error memory, the RDS
demodulator's uint8 differential carry, `QuadratureMod`'s float32
phase) become 0-d tensors of the same dtype; the digital chains
(`Costas`, `MeteorCostas`, `FastAgc`, `MuellerMuller`, `MeteorDemod`,
`Psk`, `Gfsk`, `RdsDemod`, `FalconDemod`, `KgSstvDemod`) and the
modulators (`RrcInterpolator`, `GfskMod`), `MultistageDecimator`'s tuple
of stage tails, the sparse fold's tables (``hf`` of the live alias
rows and the int32 ``fold_idx``), the PFB channelizer's state (its
complex64 ``tail``, the int32 ``bins``, the bin-rate rotator ``rot``
with its phase and tables, the ``resamp`` tails), `AtvLineSync`'s
float32 tail and `VorReceiver`'s ``bpf`` tail and ``fm`` previous
sample keep the reference's keys and dtypes, so their states convert
this way too.  The reference's
receiver keeps complex leaves as planar ``(re, im)`` pairs across its
compiled step (a named tuple with those two fields); such a pair is
joined into one complex leaf.  ``state_to_numpy`` goes back, to complex
numpy leaves, which the reference splits again with its own ``realify``.
Neither imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .graph.block import tree_map


def _is_planar_pair(node) -> bool:
    return (isinstance(node, tuple)
            and getattr(node, "_fields", None) == ("re", "im"))


def _join_planar(tree):
    """Replace every planar ``(re, im)`` pair by one complex numpy leaf."""
    if _is_planar_pair(tree):
        re, im = np.asarray(tree.re), np.asarray(tree.im)
        return (re + 1j * im).astype(np.result_type(re.dtype, np.complex64))
    if isinstance(tree, dict):
        return {k: _join_planar(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_join_planar(v) for v in tree)
    return tree


def state_from_jax(state, device="cuda"):
    """Nest of array leaves -> the same nest of torch tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda leaf: torch.as_tensor(np.array(leaf, copy=True), device=dev),
        _join_planar(state))


def to_numpy(x) -> np.ndarray:
    """A torch tensor on any device, or anything numpy takes, as a numpy
    array: what the host layers (decoders' bit layers, sinks, scanners)
    do at their boundary."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_to_numpy(state):
    """Nest of torch tensors -> the same nest of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
