"""`graph.cuda_graph` on the CPU: the packing of a state into one flat
buffer, and `GraphedStep`'s eager path (the replays are held against the
eager body on the card in tests/test_torch_if_graph_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.graph import cuda_graph  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402


def _state():
    """A nest like the IF back end's: a complex scalar and row, real
    tails of odd lengths, an empty part and a float64 leaf."""
    rng = np.random.default_rng(5)
    return (
        {"quad": {"prev": torch.tensor(0.3 - 0.2j, dtype=torch.complex64),
                  "rot": torch.as_tensor(rng.standard_normal(8),
                                         dtype=torch.float32)},
         "eq": (),
         "pilot_fir": torch.as_tensor(rng.standard_normal((8, 316)),
                                      dtype=torch.float32)},
        ((), torch.as_tensor(rng.standard_normal((2, 8, 3)),
                             dtype=torch.float32)),
        torch.as_tensor(rng.standard_normal((2, 8, 1)), dtype=torch.float64),
        torch.as_tensor((rng.standard_normal(5) + 1j
                         * rng.standard_normal(5)).astype(np.complex64)),
    )


def test_a_state_packs_into_one_buffer_and_back():
    state = _state()
    leaves = cuda_graph._leaves(state)
    assert len(leaves) == 6
    specs, n = cuda_graph._layout(leaves)
    offsets = [o for o, *_ in specs]
    assert all(o % cuda_graph._ALIGN == 0 for o in offsets + [n])
    assert offsets == sorted(set(offsets))
    buf = torch.zeros(n, dtype=torch.uint8)
    views = cuda_graph._views(buf, specs)
    for v, t in zip(views, leaves):
        v.copy_(t)
    back = cuda_graph._rebuild(state, cuda_graph._views(buf.clone(), specs))

    def same(a, b):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)

    tree_map(same, back, state)
    assert back[0]["eq"] == () and back[1][0] == ()


def test_on_the_cpu_every_call_is_eager():
    calls = []

    def step(state, x):
        calls.append(x.shape)
        return state + x.sum(), 2 * x

    g = cuda_graph.GraphedStep()
    state = torch.zeros(())
    for n in (4, 4, 4, 7):
        state, out = g(step, state, torch.ones(n))
        assert torch.equal(out, 2 * torch.ones(n))
    assert float(state) == 19.0
    assert (g.eager_passes, g.captures, g.replays) == (4, 0, 0)
    assert len(calls) == 4
