"""One stream step replayed as a captured CUDA graph per input key.

A step ``fn(state, x) -> (state, out)`` whose kernels and shapes are
fixed by its input key (the device, shape and dtype of ``x`` and of
every state tensor), and which reads nothing back to the host, launches
the same chain of kernels on every call.  `GraphedStep` captures that
chain once (`torch.cuda.graph`) and replays it with one launch:

- on the CPU, and on the first call of a key on the card, ``fn`` runs
  eagerly: that pass creates the cuBLAS handles and whatever ``fn``
  builds lazily, which a capture cannot do;
- on the second call of the key it captures ``fn`` on static inputs and
  replays it; from then on it replays.

A replay copies ``x`` and the state into the graph's static inputs,
launches the graph, and clones its one flat output buffer, whose views
it returns: a returned tensor is never written by a later replay.  The
state leaves are packed in the input buffer as in the output buffer, so
when the caller passes back exactly the views of the last replay (the
steady state), one copy moves the whole state in; otherwise each tensor
is copied, such as a state another function replaced between calls.

A hand kernel's wrapper counts its launches in its ``launches``
attribute (`count_launches`, called by `_build.launch`), and a replay
runs no Python: while a thread captures, the launches it counts go to
the graph's tally instead (the capture ran nothing on the card), and
each replay adds the tally, so a counter counts the kernels the card
runs.  Other threads' launches go to the counters as ever.

One lock serialises every `GraphedStep` call on the card: two threads
that replay one graph would interleave their copies into its static
inputs, and captures share PyTorch's capture stream and the gc switch.
"""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict

import torch

from .block import tree_map

_ALIGN = 16  # bytes: each tensor of a flat buffer starts on a multiple
_MAX_KEYS = 4  # graphs kept, the keys used last (a cell uses one)
_LOCK = threading.RLock()  # held by every GraphedStep call on the card
_capturing = threading.local()  # .tally: {wrapper: launches} of a capture


def count_launches(fn, n: int = 1) -> None:
    """Count ``n`` launches of the hand kernel wrapper ``fn`` in its
    ``launches`` attribute, or, while this thread captures a graph, in
    the graph's tally, which each replay adds."""
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        fn.launches += n
    elif n:
        tally[fn] = tally.get(fn, 0) + n


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _rebuild(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def _layout(tensors) -> tuple[list, int]:
    """Each tensor's ``(offset, nbytes, shape, dtype)`` in one byte
    buffer, and the buffer's length."""
    specs, end = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        specs.append((end, nbytes, tuple(t.shape), t.dtype))
        end += -(-nbytes // _ALIGN) * _ALIGN
    return specs, end


def _views(buf: torch.Tensor, specs) -> list:
    return [buf[o:o + n].view(dtype).view(shape)
            for o, n, shape, dtype in specs]


class _Captured:
    """One key's graph, its static inputs and its flat output."""

    def __init__(self, fn, state, leaves, x):
        dev = x.device
        self.x = torch.empty_like(x, memory_format=torch.contiguous_format)
        in_specs, n_in = _layout(leaves)
        self.inp = torch.empty(n_in, dtype=torch.uint8, device=dev)
        self.in_views = _views(self.inp, in_specs)
        static_state = _rebuild(state, self.in_views)
        self.graph = torch.cuda.CUDAGraph()
        # another graph destroyed during a capture ends it with an error;
        # the automatic gc destroys those that unreachable cycles hold,
        # so it stays off until the capture ends
        gc_was_on = gc.isenabled()
        gc.disable()
        _capturing.tally = {}
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                res = fn(static_state, self.x)
                new_state = _leaves(res[0])
                got = new_state + _leaves(res[1])
                self.out_specs, n_out = _layout(got)
                self.out = torch.empty(n_out, dtype=torch.uint8, device=dev)
                for view, t in zip(_views(self.out, self.out_specs), got):
                    view.copy_(t)
        finally:
            self.launched = list(_capturing.tally.items())
            _capturing.tally = None
            if gc_was_on:
                gc.enable()
        self.template = tree_map(lambda _: 0, res)
        # whether the returned state is packed as the static input is
        self.packed_alike = self.out_specs[:len(new_state)] == in_specs
        self.last = None  # (buffer, state views) of the last replay

    def __call__(self, leaves, x):
        self.x.copy_(x)
        last = self.last
        if last is not None and all(a is b for a, b in zip(leaves, last[1])):
            self.inp.copy_(last[0][:self.inp.numel()])
        else:
            for view, t in zip(self.in_views, leaves):
                view.copy_(t)
        self.graph.replay()
        for fn, n in self.launched:
            fn.launches += n
        buf = self.out.clone()
        views = _views(buf, self.out_specs)
        if self.packed_alike:
            self.last = (buf, views[:len(leaves)])
        return _rebuild(self.template, views)


class GraphedStep:
    """``fn(state, x) -> (state, out)`` replayed as one CUDA graph per
    input key, for the `_MAX_KEYS` keys used last.  The caller passes
    the same ``fn`` on every call; it is not kept, so a step held by the
    object whose method ``fn`` is makes no reference cycle.

    Counters: ``captures``, ``replays`` (every call that ran a graph, the
    capturing call included) and ``eager_passes``; in a steady state on
    the card, ``replays`` grows by one a call.  Safe to call from several
    threads: on the card each call holds the module's lock.
    """

    def __init__(self):
        self._graphs = OrderedDict()  # key -> _Captured, None before capture
        self.captures = self.replays = self.eager_passes = 0

    def __call__(self, fn, state, x):
        if x.device.type != "cuda":
            self.eager_passes += 1
            return fn(state, x)
        with _LOCK:
            return self._on_card(fn, state, x)

    def _on_card(self, fn, state, x):
        leaves = _leaves(state)
        key = (x.device, x.shape, x.dtype,
               *((t.device, t.shape, t.dtype) for t in leaves))
        if key not in self._graphs:
            self._graphs[key] = None
            if len(self._graphs) > _MAX_KEYS:
                self._graphs.popitem(last=False)
            self.eager_passes += 1
            return fn(state, x)
        self._graphs.move_to_end(key)
        graph = self._graphs[key]
        if graph is None:
            graph = self._graphs[key] = _Captured(fn, state, leaves, x)
            self.captures += 1
        self.replays += 1
        return graph(leaves, x)
