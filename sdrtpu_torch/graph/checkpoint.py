"""DSP state checkpoint and resume (PyTorch counterpart of
``sdrtpu/graph/checkpoint.py``).

The whole streaming state is an explicit nest of dicts and tuples, so a
checkpoint is its leaves, flattened in a fixed order, in one ``.npz``
beside a description of the nest.  Leaves are written as numpy arrays
(torch tensors are fetched to the host) and come back as numpy arrays in
the nest of ``like``; complex leaves are stored as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_flatten(tree) -> tuple[list, str]:
    """(leaves, structure): leaves in dict-key order as stored, tuples
    and lists in sequence order; ``structure`` describes the nest with
    ``*`` for each leaf."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ",".join(f"{k!r}:{walk(v)}"
                                  for k, v in sorted(node.items())) + "}"
        if isinstance(node, (tuple, list)):
            return "(" + ",".join(walk(v) for v in node) + ")"
        leaves.append(node)
        return "*"

    return leaves, walk(tree)


def tree_unflatten(like, leaves):
    """The nest of ``like`` filled with ``leaves`` in `tree_flatten` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state) -> None:
    leaves, structure = tree_flatten(state)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    # through a file handle: np.savez(str) appends ".npz" to bare paths,
    # which np.load on the verbatim path would then not find
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_state(path: str, like):
    """Restore a state saved with `save_state`; ``like`` gives the nest
    (e.g. ``op.init_state()``).  Leaves come back as numpy arrays."""
    data = np.load(path)
    leaves_like, structure = tree_flatten(like)
    n = len(leaves_like)
    n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
    saved = bytes(data["__treedef__"]).decode()
    if n_saved != n or saved != structure:
        raise ValueError(
            "checkpoint treedef mismatch — was the chain reconfigured?")
    return tree_unflatten(like, [data[f"leaf_{i}"] for i in range(n)])
