"""The strided decimating FIR kernel (`decim_fir`) against the
shift-and-add it replaces on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_decim_fir_cuda.py -q --noconftest

Tolerance: none.  The kernel sums the taps in tap order and rounds each
product and each sum on its own, as the shift-and-add's one PyTorch
kernel a product and one a sum do, so its outputs are ``torch.equal`` to
`correlate_valid` of ``tail ++ x`` run on the card, and its new tail to
the old ``ext[..., n:]``: at the 13 stages of the mixed receiver's three
per-VFO DDCs (am, usb, cw off 10 Msps, 2 000 000-sample blocks) at their
block lengths, over a grid of strides, tap counts, tails longer and
shorter than the block, complex64 and float32 and one or three rows,
replayed in a CUDA graph, and through a three-VFO `IQFrontend` over four
blocks against the concatenating step it replaced.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.graph.block import tree_map  # noqa: E402
from sdrtpu_torch.graph.cuda_graph import GraphedStep  # noqa: E402
from sdrtpu_torch.kernels import fir  # noqa: E402

FS, BLOCK = 10e6, 2_000_000
DDC_VFOS = {"am": (1_400_000.0, "am"), "usb": (3_600_000.0, "usb"),
            "cw": (-4_100_000.0, "cw")}
# (vfo, stage, decimation, taps, input length) of each DDC stage a block
STAGES = [
    ("am", 0, 8, 30, 2_000_000), ("am", 1, 8, 32, 250_000),
    ("am", 2, 5, 30, 31_250), ("am", 3, 2, 32, 6_250),
    ("usb", 0, 8, 30, 2_000_000), ("usb", 1, 5, 20, 250_000),
    ("usb", 2, 5, 30, 50_000), ("usb", 3, 2, 32, 10_000),
    ("cw", 0, 8, 30, 2_000_000), ("cw", 1, 8, 30, 250_000),
    ("cw", 2, 5, 20, 31_250), ("cw", 3, 5, 30, 6_250),
    ("cw", 4, 2, 32, 1_250),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _frontend(device):
    from sdrtpu_torch.apps.receiver import IQFrontend, VfoConfig

    fe = IQFrontend(FS, {n: VfoConfig(o, m) for n, (o, m) in DDC_VFOS.items()},
                    spectrum=False, device=device)
    fe.bind(BLOCK)
    return fe


@functools.cache
def _ddc_stages():
    """{vfo: [(decimation, taps), ...]} of the receiver's per-VFO DDCs."""
    fe = _frontend("cpu")
    return {name: [(s.decimation, s.taps)
                   for s in fe.vfos[name].ddc.predecim.stages]
            for name in DDC_VFOS}


def _iq(rng, shape, dtype="c64"):
    x = rng.standard_normal(shape)
    if dtype == "f32":
        return torch.as_tensor(x.astype(np.float32), device="cuda")
    x = x + 1j * rng.standard_normal(shape)
    return torch.as_tensor(x.astype(np.complex64), device="cuda")


def _shift_and_add(tail, x, taps, M):
    ext = torch.cat([tail, x], dim=-1)
    return ext[..., x.shape[-1]:], fir.correlate_valid(ext, taps, stride=M)


@pytest.mark.cuda
def test_the_table_is_the_receivers_ddc():
    _need_card()
    got = [(name, i, M, len(taps))
           for name, stages in _ddc_stages().items()
           for i, (M, taps) in enumerate(stages)]
    assert got == [s[:4] for s in STAGES]
    n = {}
    for name, i, M, _, length in STAGES:
        assert length == n.get(name, BLOCK)
        n[name] = length // M


@pytest.mark.cuda
@pytest.mark.parametrize("vfo,stage,M,T,n", STAGES,
                         ids=[f"{s[0]}{s[1]}" for s in STAGES])
def test_a_receiver_ddc_stage_equals_the_shift_and_add(vfo, stage, M, T, n):
    _need_card()
    taps = _ddc_stages()[vfo][stage][1]
    rng = np.random.default_rng(20 + stage)
    tail, x = _iq(rng, (T - 1,)), _iq(rng, (n,))
    h = torch.as_tensor(taps.astype(np.float32), device="cuda")
    before = fir.decim_fir.launches
    got_tail, y = fir.decim_fir(tail, x, h, M)
    assert fir.decim_fir.launches == before + 1
    want_tail, want = _shift_and_add(tail, x, taps, M)
    torch.cuda.synchronize()
    assert y.shape == (n // M,) and got_tail.shape == (T - 1,)
    assert torch.equal(y, want)
    assert torch.equal(got_tail, want_tail)


def _grid():
    cases = []
    for M in (1, 2, 5, 8):
        for T in (1, 20, 32, 95):
            lengths = [1000 * M + 3] + ([max(1, (T - 1) // 2 - 1)]
                                        if T > 2 else [])
            for n in lengths:
                for dtype in ("c64", "f32"):
                    for rows in ("1row", "3rows", "3rows-broadcast-tail"):
                        cases.append((M, T, n, dtype, rows))
    return cases + [(1, 7000, 20_000, "c64", "1row"),
                    (64, 100, 6_400, "f32", "3rows")]


@pytest.mark.cuda
@pytest.mark.parametrize("M,T,n,dtype,rows", _grid())
def test_decim_fir_equals_the_shift_and_add_over_a_grid(M, T, n, dtype, rows):
    """Strides 1, 2, 5, 8; 1, 20, 32, 95 taps; a block longer than the
    tail (ragged: n not a multiple of M) and, where the taps allow, one
    shorter; complex64 and float32; one row, three rows, three rows off
    one broadcast tail (a 1-D initial state).  Also 7 000 taps (the tile
    takes more than 48 KB of shared memory) and a stride of 64."""
    _need_card()
    rng = np.random.default_rng(M * 1000 + T + n)
    taps = rng.standard_normal(T).astype(np.float32)
    lead = () if rows == "1row" else (3,)
    if rows == "3rows-broadcast-tail":
        tail = _iq(rng, (T - 1,), dtype).expand(lead + (T - 1,))
    else:
        tail = _iq(rng, lead + (T - 1,), dtype)
    x = _iq(rng, lead + (n,), dtype)
    h = torch.as_tensor(taps, device="cuda")
    got_tail, y = fir.decim_fir(tail, x, h, M)
    want_tail, want = _shift_and_add(tail, x, taps, M)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == lead + ((n - 1) // M + 1,)
    assert torch.equal(y, want)
    assert got_tail.shape == want_tail.shape
    assert torch.equal(got_tail, want_tail)


@pytest.mark.cuda
def test_decim_fir_refuses_what_it_does_not_take():
    _need_card()
    x = torch.zeros(64, dtype=torch.complex64, device="cuda")
    h = torch.ones(30, device="cuda")
    tail = torch.zeros(29, dtype=torch.complex64, device="cuda")
    with pytest.raises(ValueError, match="complex64 or float32"):
        fir.decim_fir(tail.to(torch.complex128), x.to(torch.complex128), h, 8)
    with pytest.raises(ValueError, match="float32 taps"):
        fir.decim_fir(tail, x, h.double(), 8)
    with pytest.raises(ValueError, match="float32 taps"):
        fir.decim_fir(tail, x, h.cpu(), 8)
    with pytest.raises(ValueError, match="tail"):
        fir.decim_fir(tail[:28], x, h, 8)
    with pytest.raises(ValueError, match="bad shape"):
        fir.decim_fir(tail, x, h, 0)
    with pytest.raises(ValueError, match="does not fit"):
        fir.decim_fir(torch.zeros(29_999, dtype=torch.complex64,
                                  device="cuda"),
                      x, torch.ones(30_000, device="cuda"), 1)


@pytest.mark.cuda
def test_each_stage_of_a_ddc_is_one_launch():
    """The cw DDC's decimator, five stages, launches the kernel five
    times a block, and nothing else of it counts."""
    _need_card()
    fe = _frontend("cuda")
    dec = fe.vfos["cw"].ddc.predecim
    state = dec.init_state()
    x = _iq(np.random.default_rng(3), (BLOCK,))
    before = fir.decim_fir.launches
    for _ in range(2):
        state, y = dec(state, x)
    assert fir.decim_fir.launches == before + 2 * len(dec.stages) == before + 10
    assert y.shape == (BLOCK // 3200,)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.cuda
def test_a_graphed_decimating_fir_replays_bit_equal_to_its_eager_pass():
    """A `DecimatingFir` (the receiver's first stage) through a
    `GraphedStep`: an eager pass, a capture, replays; each pass's output
    and state ``torch.equal`` to the eager step's, one launch counted a
    pass."""
    _need_card()
    M, taps = _ddc_stages()["am"][0]
    op = fir.DecimatingFir(taps, M, device="cuda")
    step = GraphedStep()
    rng = np.random.default_rng(7)
    state = ref = op.init_state()
    for _ in range(5):
        x = _iq(rng, (BLOCK,))
        before = fir.decim_fir.launches
        state, y = step(op.__call__, state, x)
        assert fir.decim_fir.launches == before + 1
        ref, y_ref = op(ref, x)
        assert torch.equal(y, y_ref) and torch.equal(state, ref)
    assert (step.eager_passes, step.captures, step.replays) == (1, 1, 4)


def _old_decimating_fir_call(self, state, x):
    """`DecimatingFir.__call__` as it was before `decim_fir`."""
    n = x.shape[-1]
    x = x.to(self.dtype)
    state = state.expand(x.shape[:-1] + (self.ntaps - 1,))
    ext = torch.cat([state, x], dim=-1)
    y = fir.correlate_valid(ext, self.taps, stride=self.decimation)
    return (ext[..., n:] if self.ntaps > 1 else state), y


@pytest.mark.cuda
def test_a_three_vfo_frontend_is_bit_equal_to_the_old_ddc(monkeypatch):
    """The am, usb and cw VFOs (each its own DDC and radio chain) over
    four 2 000 000-sample blocks: every audio sample and state leaf
    equal to the same frontend's with `DecimatingFir`'s old
    concatenating step, 13 launches a block."""
    _need_card()
    fe = _frontend("cuda")
    rng = np.random.default_rng(11)
    xs = [_iq(rng, (BLOCK,)) * 0.05 for _ in range(4)]

    def run():
        state, outs = fe.init_state(), []
        for x in xs:
            state, (audios, _) = fe(state, x)
            outs.append(audios)
        return state, outs

    before = fir.decim_fir.launches
    new = run()
    assert fir.decim_fir.launches == before + 13 * 4
    monkeypatch.setattr(fir.DecimatingFir, "__call__",
                        _old_decimating_fir_call)
    old = run()
    assert fir.decim_fir.launches == before + 13 * 4
    la, lb = _leaves(new), _leaves(old)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        if not isinstance(a, torch.Tensor):
            assert a == b
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
