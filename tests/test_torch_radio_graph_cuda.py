"""The radio chains replayed as CUDA graphs, against their eager bodies on
the card.

Needs an NVIDIA GPU; skips without a card.  Imports no JAX, so on a
machine without it run it as

    python -m pytest tests/test_torch_radio_graph_cuda.py -q --noconftest

Tolerance: none.  A replay launches the kernels the eager body launches,
so the audio and every state leaf are ``torch.equal`` to
`RadioChain._step` run eagerly on the same inputs, pass by pass, at the
IF length of a 200 ms block of each mode of `MODE_INFO`, for chains with
every IF and AF option on, each WFM pilot mode, mono WFM and both
de-emphasis branches; and through the mixed receiver's `IQFrontend`
(fused groups, per-VFO DDCs) and `Receiver.set_mode`, also while
another thread pushes.  The hand kernels' counters (`agc_scan.launches`,
`pll_scan.launches`) grow on a replay as on an eager pass: one launch
per AGC or PLL and block.  The regression pilot's one-row fit is held
bit-equal to itself over repeated runs.
"""

import gc
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.apps.radio import MODE_INFO, RadioChain  # noqa: E402
from sdrtpu_torch.graph.block import tree_map  # noqa: E402
from sdrtpu_torch.fec.viterbi import viterbi_decode  # noqa: E402
from sdrtpu_torch.kernels import loops  # noqa: E402
from sdrtpu_torch.kernels.chunks import chunk_poly  # noqa: E402
from sdrtpu_torch.kernels.clock import mm_scan  # noqa: E402
from sdrtpu_torch.kernels.fused_channelizer import mix_decimate  # noqa: E402

FS, BLOCK = 10e6, 2_000_000  # the mixed receiver's 200 ms block
CHAINS = {
    **{mode: dict(mode=mode) for mode in MODE_INFO},
    "nfm-options": dict(mode="nfm", noise_blanker=True, squelch_db=-60.0,
                        fm_if_nr=True, ctcss_tone=12, high_pass=True),
    "wfm-options": dict(mode="wfm", noise_blanker=True, squelch_db=-60.0,
                        fm_if_nr=True, high_pass=True, rds=True),
    "wfm-mono": dict(mode="wfm", stereo=False),
    "wfm-envelope": dict(mode="wfm", pilot_mode="envelope"),
    "wfm-regression": dict(mode="wfm", pilot_mode="regression"),
    "wfm-pll": dict(mode="wfm", pilot_mode="pll"),
    "am-deemphasis": dict(mode="am", deemphasis=75e-6),
    "usb-long-deemphasis": dict(mode="usb", deemphasis=1e-3),
}
AGC_MODES = ("am", "usb", "lsb", "dsb", "cw")  # one agc_scan a block
COUNTED = (loops.agc_scan, loops.pll_scan, loops.costas_scan, chunk_poly,
           mix_decimate, mm_scan, viterbi_decode)  # the hand kernels


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs exist only on the card")


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


def _clone(tree):
    return tree_map(torch.clone, tree)


def _iq(rng, n):
    """(n,) complex64 on the card: a random-walk FM carrier in noise."""
    ph = np.cumsum(rng.standard_normal(n) * 0.6)
    x = 0.3 * np.exp(1j * ph) + 0.01 * (rng.standard_normal(n)
                                        + 1j * rng.standard_normal(n))
    return torch.as_tensor(x.astype(np.complex64), device="cuda")


def _if_len(chain):
    n = round(0.2 * chain.if_rate)
    assert n % chain.block_multiple() == 0
    return n


def _counts():
    return [fn.launches for fn in COUNTED]


def _growth(before):
    return {fn.__name__: fn.launches - b
            for fn, b in zip(COUNTED, before) if fn.launches != b}


def _counted(name):
    cfg = CHAINS[name]
    if cfg["mode"] in AGC_MODES:
        return {"agc_scan": 1}
    if cfg.get("pilot_mode") == "pll":
        return {"pll_scan": 1}
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHAINS))
def test_replays_match_the_eager_body_pass_by_pass(name):
    """Six passes: one eager (`init_state` has the steady state's key),
    a capture, replays; each bit-equal to the eager body, what pass k
    returned unchanged after pass k+1, and each hand kernel counted once
    a block on every pass."""
    _card()
    rng = np.random.default_rng(18)
    chain = RadioChain(device="cuda", **CHAINS[name])
    n = _if_len(chain)
    state = ref = chain.init_state()
    kept = None
    for _ in range(6):
        x = _iq(rng, n)
        before = _counts()
        state, a = chain(state, x)
        assert _growth(before) == _counted(name)
        before = _counts()
        ref, a_ref = chain._step(ref, x)
        assert _growth(before) == _counted(name)
        assert a.shape == (2, chain.out_len(n))
        _equal(a, a_ref)
        _equal(state, ref)
        if kept is not None:
            _equal(kept[0], kept[1])
        kept = ((a, state), _clone((a, state)))
    g = chain._graph
    assert (g.eager_passes, g.captures, g.replays) == (1, 1, 5)
    assert len(g._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHAINS))
def test_a_steady_pass_neither_syncs_nor_copies_from_pageable_memory(name):
    """Under the profiler, one steady pass: no ``cudaStreamSynchronize``
    and no pageable host-to-device copy, one graph launch, and at most
    four launch and copy calls in all (the IF and the state in, the
    replay, the clone of its output)."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(19)
    chain = RadioChain(device="cuda", **CHAINS[name])
    n = _if_len(chain)
    state = chain.init_state()
    for _ in range(4):
        state, _ = chain(state, _iq(rng, n))
    x = _iq(rng, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, a = chain(state, x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert "sdrtpu.rx.radio" in names
    assert not [m for m in names if "Pageable" in m], names
    calls = [m for m in names
             if m.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                              "cudaMemcpy", "cudaStreamSynchronize"))]
    assert calls.count("cudaGraphLaunch") == 1, calls
    assert "cudaStreamSynchronize" not in calls, calls
    assert len(calls) <= 4, calls


class _Eager:
    """A chain's `GraphedStep` replaced by its eager body."""

    def __call__(self, fn, state, x):
        return fn(state, x)


# the mixed receiver's VFOs (the benchmark's rx8_mixed_10msps)
RX8 = {"w0": (-3.2e6, "wfm"), "w1": (-1.1e6, "wfm"), "w2": (2.3e6, "wfm"),
       "n0": (0.6e6, "nfm"), "n1": (-2.0e6, "nfm"), "am": (1.4e6, "am"),
       "usb": (3.6e6, "usb"), "cw": (-4.1e6, "cw")}


def _rx8_frontend():
    from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig

    fe = IQFrontend(FS, {n: VfoConfig(off, mode) for n, (off, mode)
                         in RX8.items()}, device="cuda")
    Receiver(fe, block_len=BLOCK)  # binds: fuses the WFM and NFM groups
    return fe


def _wideband(gen):
    """(BLOCK,) complex64 on the card: a carrier at each VFO in noise."""
    t = torch.arange(BLOCK, device="cuda", dtype=torch.float64) / FS
    x = 1e-3 * torch.randn(BLOCK, dtype=torch.complex64, device="cuda",
                           generator=gen)
    for off, _ in RX8.values():
        f = off + 500.0 * float(torch.rand((), generator=gen,
                                           device="cuda"))
        x = x + 0.05 * torch.exp(1j * 2 * np.pi * f * t).to(torch.complex64)
    return x


@pytest.mark.cuda
def test_the_mixed_receivers_chains_replay_bit_equal_to_eager_chains():
    """The benchmark's eight VFOs through `IQFrontend`: the WFM and NFM
    chains take rows of their group's channelizer, the others their own
    DDC's output.  Six blocks against a twin frontend whose chains run
    their bodies eagerly: every audio stream, the waterfall and every
    state leaf equal; one graph launch a chain and block once steady,
    and three AGC launches a block on either frontend."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    graphed, eager = _rx8_frontend(), _rx8_frontend()
    assert len(graphed._groups) == 2
    for v in eager.vfos.values():
        v.radio._graph = _Eager()
    gen = torch.Generator(device="cuda").manual_seed(17)
    st_g, st_e = graphed.init_state(), eager.init_state()
    with torch.inference_mode():
        for b in range(7):
            x = _wideband(gen)
            before = loops.agc_scan.launches
            if b < 6:
                st_g, out_g = graphed(st_g, x)
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    st_g, out_g = graphed(st_g, x)
                    torch.cuda.synchronize()
            assert loops.agc_scan.launches == before + 3
            st_e, out_e = eager(st_e, x)
            assert loops.agc_scan.launches == before + 6
            _equal((st_g, out_g), (st_e, out_e))
    names = [e.name for e in prof.events()]
    assert names.count("cudaGraphLaunch") == len(RX8), names
    for name, v in graphed.vfos.items():
        g = v.radio._graph
        assert g.captures == 1 and g.replays >= 4, (name, vars(g))


def _vfo_eager(vfo, state, x):
    """`Vfo.__call__` with the chain's body run eagerly."""
    st = dict(state)
    st["xl"], y = vfo.xlator(state["xl"], x)
    st["ddc"], y = vfo.ddc(state["ddc"], y)
    st["radio"], audio = vfo.radio._step(state["radio"], y)
    return st, audio


@pytest.mark.cuda
def test_a_set_mode_swap_captures_a_new_graph_and_frees_the_old():
    """A `Receiver` with two VFOs of their own (AM, USB): the AM VFO goes
    to NFM, back to AM (its cached chain replays its own graph, with no
    new capture) and to NFM again with a cache of one, which drops the
    AM chain and frees its graph.  Every block of the switched VFO
    equals `Vfo.__call__` run eagerly from the same state, and each
    block launches one AGC a VFO in AM or USB."""
    _card()
    from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig

    fe = IQFrontend(FS, {"v": VfoConfig(1.4e6, "am"),
                         "u": VfoConfig(3.6e6, "usb")},
                    spectrum=False, device="cuda")
    audio = {"v": [], "u": []}
    rx = Receiver(fe, block_len=BLOCK,
                  audio_sinks={k: a.append for k, a in audio.items()})
    gen = torch.Generator(device="cuda").manual_seed(18)

    def push(blocks, agcs):
        for _ in range(blocks):
            x = _wideband(gen).cpu().numpy()
            vfo, st = fe.vfos["v"], rx._state["vfos"]["v"]
            with torch.inference_mode():
                want = _vfo_eager(vfo, st, torch.as_tensor(x, device="cuda"))
            before = loops.agc_scan.launches
            rx.push(x)
            assert loops.agc_scan.launches == before + agcs
            _equal(rx._state["vfos"]["v"], want[0])
            assert np.array_equal(audio["v"][-1], want[1].cpu().numpy())

    def counts(chain):
        g = chain._graph
        return g.eager_passes, g.captures, g.replays

    # a chain has one key: `set_mode` runs the new chain twice (eager,
    # capture), so every push after it replays
    push(4, agcs=2)  # eager, capture, replay, replay
    am = fe.vfos["v"].radio
    assert counts(am) == (1, 1, 3)
    rx.set_mode("v", "nfm")
    nfm = fe.vfos["v"].radio
    assert nfm is not am and nfm.mode == "nfm"
    assert counts(nfm) == (1, 1, 1)
    push(3, agcs=1)  # replays
    assert counts(nfm) == (1, 1, 4)
    rx.set_mode("v", "am")  # the cached chain replays its own graph
    assert fe.vfos["v"].radio is am
    push(2, agcs=2)
    assert counts(am) == (1, 1, 7)
    am_graphs = [weakref.ref(g) for g in am._graph._graphs.values()]
    assert len(am_graphs) == 1 and am_graphs[0]() is not None
    rx.MODE_CACHE_SIZE = 1
    rx.set_mode("v", "nfm")  # drops the am chain from the cache
    assert fe.vfos["v"].radio is nfm
    del am
    gc.collect()
    assert am_graphs[0]() is None
    push(2, agcs=1)
    assert counts(nfm) == (1, 1, 8)


@pytest.mark.cuda
def test_set_mode_from_another_thread_leaves_the_pushed_vfos_bit_equal():
    """One thread pushes ten blocks through a `Receiver` of three VFOs
    of their own while another switches one of them between AM and NFM
    eight times.  The two VFOs never switched give, block by block, the
    audio of an eager twin receiver fed the same blocks on one thread,
    and end in its state: the switches' warm passes, which replay the
    same graphs, neither reach the pushed blocks nor the stored state."""
    _card()
    from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig

    cfg = {"v": VfoConfig(1.4e6, "am"), "u": VfoConfig(3.6e6, "usb"),
           "n": VfoConfig(0.6e6, "nfm")}
    kept = ("u", "n")

    def receiver():
        fe = IQFrontend(FS, dict(cfg), spectrum=False, device="cuda")
        audio = {k: [] for k in kept}
        rx = Receiver(fe, block_len=BLOCK,
                      audio_sinks={k: a.append for k, a in audio.items()})
        return rx, audio

    graphed, audio_g = receiver()
    eager, audio_e = receiver()
    for v in eager.frontend.vfos.values():
        v.radio._graph = _Eager()
    gen = torch.Generator(device="cuda").manual_seed(21)
    blocks = [_wideband(gen).cpu().numpy() for _ in range(10)]
    for x in blocks:
        eager.push(x)
    graphed.push(blocks[0])  # the eager pass, outside the race
    switched = []

    def switch():
        for k in range(8):
            switched.append(graphed.set_mode("v", ("nfm", "am")[k % 2]))

    t = threading.Thread(target=switch)
    t.start()
    for x in blocks[1:]:
        graphed.push(x)
    t.join()
    assert len(switched) == 8
    torch.cuda.synchronize()
    for k in kept:
        assert len(audio_g[k]) == len(audio_e[k]) == len(blocks)
        for a, b in zip(audio_g[k], audio_e[k]):
            assert np.array_equal(a, b), k
        _equal(graphed._state["vfos"][k], eager._state["vfos"][k])
        g = graphed.frontend.vfos[k].radio._graph
        assert g.captures == 1 and len(g._graphs) == 1, (k, vars(g))


@pytest.mark.cuda
def test_a_one_row_pilot_fit_is_the_same_on_every_run():
    """The regression pilot's fit of one 50 000-sample row: 200 runs on
    the same input give the same bits (a one-row float32 cumsum on the
    card is a device-wide scan whose sums may change from run to run;
    `_unwrap` scans it as one of two rows)."""
    _card()
    rng = np.random.default_rng(22)
    n = 50_000
    ph = 2 * np.pi * 19e3 / 250e3 * np.arange(n) + np.cumsum(
        rng.standard_normal(n) * 0.05)
    p = torch.as_tensor((np.exp(1j * ph) + 0.1 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64), device="cuda")[None]
    first = loops.pilot_phase_fit(p, 19e3, 250e3)
    for _ in range(200):
        assert torch.equal(loops.pilot_phase_fit(p, 19e3, 250e3), first)
