"""`graph.cuda_graph` on the CPU: the packing of a state into one flat
buffer, `GraphedStep`'s eager path, the hand kernels' launch counting
under capture (through a stand-in graph) and `RadioChain`'s eager path (the replays
are held against the eager bodies on the card in
tests/test_torch_if_graph_cuda.py and tests/test_torch_radio_graph_cuda.py)."""

import contextlib

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


def test_bool_and_int_leaves_pack_too():
    """A CTCSS gate's state: float, complex, bool and int32 scalars."""
    from sdrtpu_torch.kernels.ctcss import CtcssSquelch

    state = CtcssSquelch(50000.0, 12, device="cpu").init_state()
    leaves = cuda_graph._leaves(state)
    assert {torch.bool, torch.int32} <= {t.dtype for t in leaves}
    specs, n = cuda_graph._layout(leaves)
    buf = torch.zeros(n, dtype=torch.uint8)
    for v, t in zip(cuda_graph._views(buf, specs), leaves):
        v.copy_(t)
    back = cuda_graph._leaves(cuda_graph._rebuild(
        state, cuda_graph._views(buf.clone(), specs)))
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


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


class _StandInGraph:
    """`torch.cuda.CUDAGraph` on the CPU: the capture ran the step
    eagerly, and a replay runs nothing."""

    def replay(self):
        pass


@contextlib.contextmanager
def _stand_in_capture(graph, capture_error_mode):
    yield


def _counter(name):
    def fn():
        cuda_graph.count_launches(fn)
    fn.__name__ = name
    fn.launches = 0
    return fn


def test_a_replay_adds_what_its_capture_counted(monkeypatch):
    """The launches a capture counts go to the graph's tally, not to the
    counters (the capture ran nothing on the card), and each replay adds
    the tally; counters the capture did not touch are left alone."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    scan, unused = _counter("scan"), _counter("unused")

    def step(state, x):
        scan()
        scan()
        y = x.cumsum(-1) + state
        return y[..., -1:], y

    scan.launches, unused.launches = 5, 7
    state, x = torch.zeros(1), torch.ones(16)
    leaves = cuda_graph._leaves(state)
    g = cuda_graph._Captured(step, state, leaves, x)
    assert g.launched == [(scan, 2)]
    assert (scan.launches, unused.launches) == (5, 7)
    for k in range(1, 4):
        st, y = g(leaves, x)
        assert st.shape == (1,) and y.shape == (16,)
        assert (scan.launches, unused.launches) == (5 + 2 * k, 7)
    scan()
    assert scan.launches == 12


def test_another_threads_launches_during_a_capture_reach_the_counter(
        monkeypatch):
    """A launch counted on another thread while this one captures is a
    real launch: it goes to the counter, and no replay repeats it."""
    import threading

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    scan = _counter("scan")

    def step(state, x):
        scan()
        other = threading.Thread(target=lambda: [scan() for _ in range(3)])
        other.start()
        other.join()
        return state + 1, x

    state, x = torch.zeros(1), torch.ones(4)
    leaves = cuda_graph._leaves(state)
    g = cuda_graph._Captured(step, state, leaves, x)
    assert g.launched == [(scan, 1)] and scan.launches == 3
    g(leaves, x)
    assert scan.launches == 4


def _package_hand_counts() -> list[str]:
    """Every ``x.launches += ...`` in the port outside `graph.cuda_graph`
    and every read of ``current_stream`` outside `_build`."""
    import ast
    import pathlib

    import sdrtpu_torch

    found = []
    for path in pathlib.Path(sdrtpu_torch.__file__).parent.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (path.name != "cuda_graph.py"
                    and isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Attribute)
                    and node.target.attr == "launches"):
                found.append(f"{path.name}:{node.lineno}")
            if (path.name != "_build.py" and isinstance(node, ast.Attribute)
                    and node.attr == "current_stream"):
                found.append(f"{path.name}:{node.lineno}")
    return found


def _meta_args(name):
    """Arguments of hand wrapper ``name`` on the meta device, shaped so
    that only the device is wrong."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    c64 = torch.complex64
    prev = np.array([[0, 1], [2, 3], [0, 1], [2, 3]])
    return {
        "chunk_poly": (m(64, dtype=c64), 16, 4, 8, 2),
        "decim_fir": (m(1, 29, dtype=c64), m(1, 64, dtype=c64), m(30), 8),
        "mix_decimate": (m(3, dtype=c64), m(1024, dtype=c64),
                         m(1, 2, dtype=c64), m(1, 1024, dtype=c64), m(4),
                         m(1), 2),
        "agc_scan": (m(1, 8), m(1, 8), m(1), *[0.5] * 7),
        "pll_scan": (m(1, 8, dtype=c64), m(1), m(1), 0.1, 0.01, -1.0, 1.0),
        "costas_scan": (m(1, 8, dtype=c64), m(1), m(1), 0.1, 0.01, -1.0,
                        1.0, 1),
        "mm_scan": (m(1, 15), m(128, 8), 8, 4, m(1, dtype=torch.int32),
                    m(1, 3), m(1, 4, dtype=c64), 3.9, 4.1, 1e-6, 0.01),
        "viterbi_decode": (m(1, 8, 2), np.zeros((4, 2, 2), np.float32),
                           prev, prev >> 1),
        "costas_mm_scan": (m(1, 8, dtype=c64), m(1, 7, dtype=c64), m(1),
                           m(1), 0.1, 0.01, -1.0, 1.0, 1, m(128, 8), 6,
                           [m(1, dtype=torch.int32), m(1), m(1), m(1),
                            *[m(1, dtype=c64)] * 4], 3.9, 4.1, 1e-6, 0.01),
    }[name]


_HAND_WRAPPERS = {
    "chunk_poly": "sdrtpu_torch.kernels.chunks",
    "decim_fir": "sdrtpu_torch.kernels.fir",
    "mix_decimate": "sdrtpu_torch.kernels.fused_channelizer",
    "agc_scan": "sdrtpu_torch.kernels.loops",
    "pll_scan": "sdrtpu_torch.kernels.loops",
    "costas_scan": "sdrtpu_torch.kernels.loops",
    "mm_scan": "sdrtpu_torch.kernels.clock",
    "viterbi_decode": "sdrtpu_torch.fec.viterbi",
    "costas_mm_scan": "sdrtpu_torch.kernels.clock",
}


@pytest.mark.parametrize("name", list(_HAND_WRAPPERS))
def test_every_hand_kernel_counts_through_count_launches(name):
    """No module of the port adds to a ``launches`` counter by hand (a
    wrapper that did would count its captured launches once at capture
    and never on a replay) or reads the current stream: hand wrapper
    ``name`` launches through `_build.launch` alone, which does both,
    keeps an int counter, and raises off the CPU and the card."""
    import ast
    import importlib
    import pathlib

    assert _package_hand_counts() == []
    module = importlib.import_module(_HAND_WRAPPERS[name])
    fn = getattr(module, name)
    assert isinstance(fn.launches, int)
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    body = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == name)
    launches = [node for node in ast.walk(body)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "launch"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "_build"]
    assert len(launches) == 1
    assert isinstance(launches[0].args[0], ast.Name)
    assert launches[0].args[0].id == name
    with pytest.raises(ValueError, match=f"{name}: unsupported device meta"):
        fn(*_meta_args(name))


_CHAINS = {
    **{mode: dict(mode=mode) for mode in
       ("wfm", "nfm", "am", "usb", "lsb", "dsb", "cw", "raw")},
    "nfm-options": dict(mode="nfm", noise_blanker=True, squelch_db=-60.0,
                        fm_if_nr=True, ctcss_tone=12, high_pass=True),
}


@pytest.mark.parametrize("name", list(_CHAINS))
def test_a_radio_chain_on_the_cpu_runs_its_body_eagerly(name):
    """On the CPU every call of a `RadioChain` is an eager pass of its
    body, and returns exactly what the body returns."""
    from sdrtpu_torch.apps.radio import RadioChain

    chain = RadioChain(device="cpu", **_CHAINS[name])
    rng = np.random.default_rng(18)
    n = chain.block_multiple() * max(1, 600 // chain.block_multiple())
    state = ref = chain.init_state()
    for _ in range(3):
        x = torch.as_tensor((0.3 * np.exp(1j * np.cumsum(
            rng.standard_normal(n))) + 0.01 * rng.standard_normal(n)
        ).astype(np.complex64))
        state, a = chain(state, x)
        ref, a_ref = chain._step(ref, x)
        assert a.shape == (2, chain.out_len(n))
        assert torch.equal(a, a_ref)
        tree_map(lambda u, v: torch.equal(u, v) or pytest.fail("state"),
                 state, ref)
    g = chain._graph
    assert (g.eager_passes, g.captures, g.replays) == (3, 0, 0)
