"""The flagship's IF back end replayed as a CUDA graph, against its eager
body on the card.

Needs an NVIDIA GPU; skips without a card.  Imports no JAX, so on a
machine without it run it as

    python -m pytest tests/test_torch_if_graph_cuda.py -q --noconftest

Tolerance: none.  A replay launches the kernels the eager body launches,
so the audio and every state leaf are ``torch.equal`` to
`WbfmMultiVfoPipeline._if_chain` run eagerly on the same inputs, pass by
pass, at the live cell's IF shape (8, 12 500) and the batch cell's
sub-window (8, 100 000), for each pilot mode and for a de-emphasis pole
long enough to take `first_order_recurrence` (the "fft" pilot filter of
the three complex pilot modes and the recurrence each keep a table on
the card that a capture reads).
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402

FS, BLOCK = 10e6, 500_000
OFFS = np.linspace(-0.4, 0.4, 8) * FS
LIVE, BATCH = 12_500, 100_000


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs exist only on the card")


def _pipe(pilot_mode="envelope", tau=50e-6):
    return WbfmMultiVfoPipeline(OFFS, FS, BLOCK, skip_rotator=True,
                                pilot_mode=pilot_mode, tau=tau,
                                device="cuda")


def _counts(pipe):
    g = pipe._if_graph
    return g.eager_passes, g.captures, g.replays


def _if(rng, n):
    """(8, n) complex64 IF on the card: a random-walk FM carrier in noise."""
    ph = np.cumsum(rng.standard_normal((8, n)) * 0.6, axis=-1)
    x = np.exp(1j * ph) + 0.05 * (rng.standard_normal((8, n))
                                  + 1j * rng.standard_normal((8, n)))
    return torch.as_tensor(x.astype(np.complex64), device="cuda")


def _parts(state):
    return (state["demod"], state["audio"], state["deemph"])


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _graphed(pipe, state, y):
    """One pass through the dispatching IF back end: the full state with
    the three parts replaced, and the audio."""
    st = dict(state)
    a = pipe._if_back_end(st, state, y)
    return st, a


def _clone(tree):
    return tree_map(torch.clone, tree)


@pytest.mark.cuda
@pytest.mark.parametrize("pilot_mode,tau", [
    ("envelope", 50e-6), ("normalized", 50e-6), ("regression", 50e-6),
    ("pll", 50e-6), ("envelope", 1e-3)],
    ids=["envelope", "normalized", "regression", "pll", "long-tau"])
@pytest.mark.parametrize("n", [LIVE, BATCH], ids=["live", "batch"])
def test_replays_match_the_eager_body_pass_by_pass(n, pilot_mode, tau):
    """Six passes: two eager (the initial state's key, then the steady
    one), a capture, three replays; each bit-equal to the eager body,
    and what pass k returned is unchanged after pass k+1."""
    _card()
    rng = np.random.default_rng(16)
    pipe = _pipe(pilot_mode, tau)
    assert (pipe.deemph._fir is None) == (tau > 50e-6)
    assert (pipe.demod.pilot_fir.method == "fft") == (
        pilot_mode != "envelope")
    state = pipe.init_state()
    ref = _parts(state)
    kept = None
    for _ in range(6):
        y = _if(rng, n)
        state, a = _graphed(pipe, state, y)
        ref, a_ref = pipe._if_chain(ref, y)
        assert a.shape == (2, 8, n * 24 // 125)
        _equal(a, a_ref)
        _equal(_parts(state), ref)
        if kept is not None:
            _equal(kept[0], kept[1])
        kept = ((a, _parts(state)), _clone((a, _parts(state))))
    assert _counts(pipe) == (2, 1, 4)


@pytest.mark.cuda
def test_a_retune_reaches_the_next_replay():
    _card()
    rng = np.random.default_rng(17)
    pipe = _pipe()
    state = pipe.init_state()
    for _ in range(4):
        state, _ = _graphed(pipe, state, _if(rng, LIVE))
    assert pipe._if_graph.replays == 2
    before = _parts(state)
    state = pipe.retune_state(state, OFFS + np.array([3e3, 0, 0, 0, 0, 0, 0,
                                                      -2e3]))
    assert not torch.equal(state["demod"]["quad"]["rot"],
                           before[0]["quad"]["rot"])
    y = _if(rng, LIVE)
    ref = pipe._if_chain(_parts(state), y)
    stale = pipe._if_chain(before, y)
    state, a = _graphed(pipe, state, y)
    assert pipe._if_graph.replays == 3
    _equal((_parts(state), a), ref)
    assert not torch.equal(a, stale[1])


@pytest.mark.cuda
def test_a_new_shape_captures_and_the_old_key_still_replays():
    _card()
    rng = np.random.default_rng(18)
    pipe = _pipe()
    state = pipe.init_state()
    ref = _parts(state)
    counts = []
    for n in [LIVE] * 4 + [BATCH] * 3 + [LIVE] * 2:
        y = _if(rng, n)
        state, a = _graphed(pipe, state, y)
        ref, a_ref = pipe._if_chain(ref, y)
        _equal((_parts(state), a), (ref, a_ref))
        counts.append(_counts(pipe))
    # live: eager (initial key), eager, capture, replay; batch: eager,
    # capture, replay; live again: replays of the first graph
    assert counts == [(1, 0, 0), (2, 0, 0), (2, 1, 1), (2, 1, 2),
                      (3, 1, 2), (3, 2, 3), (3, 2, 4),
                      (3, 2, 5), (3, 2, 6)]


@pytest.mark.cuda
def test_a_graph_that_the_gc_frees_does_not_end_another_capture():
    """An unreachable cycle that holds a captured graph, freed by the
    automatic gc while another step captures, would invalidate that
    capture: the capturing step allocates enough Python objects for a
    collection to fall inside its capture, and must still replay."""
    _card()
    from sdrtpu_torch.graph.cuda_graph import GraphedStep

    def scaled(state, x):
        junk = [[] for _ in range(20_000)]  # several gc generations' worth
        y = 2.0 * x + state
        return y[-1:] + len(junk) * 0.0, y

    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    old = GraphedStep()
    state = torch.zeros(1, device="cuda")
    for _ in range(3):
        state, _ = old(scaled, state, x)
    assert old.captures == 1
    new = GraphedStep()
    st = torch.zeros(1, device="cuda")
    st, _ = new(scaled, st, x)
    gc.collect(0)  # the next collection is one the capture triggers
    box = [old]
    box.append(box)  # the only holder of `old`'s graph: a young cycle
    del old, box
    st2, y = new(scaled, st, x)
    assert new.captures == 1
    want = scaled(st, x)
    assert torch.equal(y, want[1]) and torch.equal(st2, want[0])


@pytest.mark.cuda
def test_a_steady_pass_neither_syncs_nor_copies_from_pageable_memory():
    """Under the profiler, one steady pass: no ``cudaStreamSynchronize``
    and no pageable host-to-device copy, one graph launch, and at most
    four launch and copy calls in all (the IF and the state in, the
    replay, the clone of its output)."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(19)
    pipe = _pipe()
    state = pipe.init_state()
    for _ in range(4):
        state, _ = _graphed(pipe, state, _if(rng, BATCH))
    y = _if(rng, BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, a = _graphed(pipe, state, y)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert "sdrtpu.if_back_end" in names
    assert not [n for n in names if "Pageable" in n], names
    calls = [n for n in names
             if n.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                              "cudaMemcpy", "cudaStreamSynchronize"))]
    assert calls.count("cudaGraphLaunch") == 1, calls
    assert "cudaStreamSynchronize" not in calls, calls
    assert len(calls) <= 4, calls


@pytest.mark.cuda
def test_the_sharded_flagship_replays_the_pipelines_graph():
    """`ShardedWbfmPipeline` on a one-card (1, 1) mesh: its IF back end
    is the pipeline's, so it replays from the third block on, bit-equal
    to the same sharded pipeline with the eager body in its place."""
    _card()
    from sdrtpu_torch.shard.flagship import ShardedWbfmPipeline
    from sdrtpu_torch.shard.mesh import make_mesh

    def eager(self, st, state, y):
        (st["demod"], st["audio"], st["deemph"]), a = self._if_chain(
            _parts(state), y)
        return a

    mesh = make_mesh(1, 1, device="cuda")
    graphed = ShardedWbfmPipeline(OFFS, FS, BLOCK, mesh, skip_rotator=True)
    plain = ShardedWbfmPipeline(OFFS, FS, BLOCK, mesh, skip_rotator=True)
    plain.pipe._if_back_end = eager.__get__(plain.pipe)
    rng = np.random.default_rng(20)
    st_g = st_p = graphed.init_state()
    for _ in range(5):
        x = torch.as_tensor((rng.standard_normal(BLOCK) + 1j
                             * rng.standard_normal(BLOCK)
                             ).astype(np.complex64), device="cuda")
        st_g, a_g = graphed(st_g, x)
        st_p, a_p = plain(st_p, x)
        _equal((_parts(st_g), a_g), (_parts(st_p), a_p))
    assert _counts(graphed.pipe) == (2, 1, 3)
