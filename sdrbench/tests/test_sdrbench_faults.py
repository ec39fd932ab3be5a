"""A run on the CPU at a small size with the timed path broken
underneath: ``correct`` comes out false for each fault the cells can
have, and true with nothing broken."""

import pytest
import torch

from sdrbench import harness
from sdrbench.systems import wbfm_pipeline


def stale_state(call):
    """Each call starts from the state it was given and returns it."""
    def f(self, entry, state, xs):
        _, out = call(self, entry, state, xs)
        return state, out
    return f


def half_left_out(call):
    """Half of the blocks of each call computed, the other half's
    outputs copied from them."""
    def f(self, entry, state, xs):
        k = xs.shape[0]
        if k == 1:
            # one block a call: every other call's outputs repeat the
            # last ones
            f.n = getattr(f, "n", 0) + 1
            if f.n % 2 == 0 and hasattr(f, "last"):
                return state, {n: t.clone() for n, t in f.last.items()}
            state, out = call(self, entry, state, xs)
            f.last = out
            return state, out
        state, out = call(self, entry, state, xs[: k // 2])
        return state, {n: torch.cat([t, t]) for n, t in out.items()}
    return f


def altered(call):
    """One audio sample of every block changed where it is produced."""
    def f(self, entry, state, xs):
        state, out = call(self, entry, state, xs)
        out["audio"][:, 0, 0, 100] += 1e-3
        return state, out
    return f


@pytest.mark.parametrize("cell", ["wbfm8.batch", "wbfm8.live"])
@pytest.mark.parametrize("fault", [None, stale_state, half_left_out,
                                   altered])
def test_fault_fails_the_run(monkeypatch, tiny_cell, cell, fault):
    if fault is not None:
        monkeypatch.setattr(wbfm_pipeline.System, "call",
                            fault(wbfm_pipeline.System.call))
    out = harness.run_cell(tiny_cell(cell), 11, 0.3, False, "cpu", 0.0)
    assert out["correct"] is (fault is None), out["checks"]
