"""The port's spans (`sdrtpu_torch.metrics.span`): a shared no-op with no
profiler, and under ``torch.profiler`` host ranges at the pipeline's
entries, sub-windows, channelizer, IF back end and waterfall, and at the
receiver's frontend, per-VFO DDCs and radio chains, nested as the layers
are, with every output bit-equal to a run without them.

The pipeline is the benchmark's flagship cut as its CPU tests cut it:
two VFOs off 10 Msps, an 8192-bin waterfall, 500 000-sample blocks, and
sub-windows of two blocks."""

import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from sdrtpu_torch import metrics
from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig
from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline
from sdrtpu_torch.graph.checkpoint import tree_flatten

FS = 10e6
BLOCK = 500_000
LAYERS = ("sdrtpu.channelizer", "sdrtpu.if_back_end", "sdrtpu.waterfall")


@pytest.fixture(scope="module")
def pipe():
    offsets = np.linspace(-0.4 * FS, 0.4 * FS, 2)
    return WbfmMultiVfoPipeline(offsets, FS, BLOCK, spectrum=True,
                                fft_size=8192, skip_rotator=True,
                                sub_samples=2 * BLOCK, device="cpu")


@pytest.fixture(scope="module")
def blocks():
    g = torch.Generator().manual_seed(15)
    x = torch.randn(4, BLOCK, 2, generator=g) * 0.1
    return torch.view_as_complex(x)


def run(pipe, entry, xs):
    if entry == "call":
        return pipe(pipe.init_state(), xs[0])
    return pipe.scan_call(pipe.init_state(), xs)


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, -e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("sdrtpu."))
    return out, [(s, -e, n) for s, e, n in spans]


def tree(spans):
    """The spans as (name, [children]) by containment in time."""
    root, stack = ("", []), []
    for s, e, n in spans:
        while stack and not (stack[-1][0] <= s and e <= stack[-1][1]):
            stack.pop()
        node = (n, [])
        (stack[-1][2] if stack else root)[1].append(node)
        stack.append((s, e, node))
    return root[1]


def siblings_apart(spans, names):
    """The spans named ``names`` follow one another without overlap."""
    mine = [(s, e) for s, e, n in spans if n in names]
    return all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))


def test_span_off_is_one_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    a, b = metrics.span("sdrtpu.a"), metrics.span("sdrtpu.b", 3)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_profiler_flag_is_set_exactly_while_recording():
    """The flag `span` reads: a torch upgrade that drops it fails here."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert not isinstance(metrics.span("sdrtpu.x"),
                              contextlib.nullcontext)
    assert autograd_profiler._is_profiler_enabled is False


LAYER_NODES = [(n, []) for n in LAYERS]


@pytest.mark.parametrize("entry,want", [
    ("call", [("sdrtpu.wbfm.call", LAYER_NODES)]),
    ("scan_call", [("sdrtpu.wbfm.scan_call",
                    [("sdrtpu.wbfm.window", LAYER_NODES)] * 2)]),
])
def test_spans_nest_as_the_layers(pipe, blocks, entry, want):
    _, spans = traced(lambda: run(pipe, entry, blocks))
    assert tree(spans) == want
    assert siblings_apart(spans, LAYERS)
    assert siblings_apart(spans, ("sdrtpu.wbfm.window",))


@pytest.mark.parametrize("entry", ["call", "scan_call"])
def test_outputs_bit_equal_with_the_profiler_on(pipe, blocks, entry):
    plain = run(pipe, entry, blocks)
    on, spans = traced(lambda: run(pipe, entry, blocks))
    assert spans
    (want, nest), (got, nest_on) = tree_flatten(plain), tree_flatten(on)
    assert nest == nest_on
    for a, b in zip(want, got, strict=True):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_iq_frontend_step_spans_its_channelizer():
    fs, block = 1e6, 96_000
    fe = IQFrontend(fs, {"w1": VfoConfig(200e3, "wfm"),
                         "w2": VfoConfig(-250e3, "wfm")},
                    fft_size=1024, fft_rate=125.0, device="cpu")
    fe.bind(block)
    x = torch.zeros(block, dtype=torch.complex64)
    _, spans = traced(lambda: fe(fe.init_state(), x))
    assert tree(spans) == [("sdrtpu.rx.frontend", [
        ("sdrtpu.waterfall", []), ("sdrtpu.channelizer", []),
        ("sdrtpu.rx.radio", []), ("sdrtpu.rx.radio", [])])]


# the mixed receiver cut small: a fused WFM pair, and an NFM and a CW VFO
# each alone at its IF rate, so each keeps its own DDC
RX_VFOS = {"w1": (200e3, "wfm"), "w2": (-250e3, "wfm"), "n": (100e3, "nfm"),
           "c": (-400e3, "cw")}
RX_LAYERS = ("sdrtpu.waterfall", "sdrtpu.channelizer", "sdrtpu.rx.ddc",
             "sdrtpu.rx.radio")


@pytest.fixture(scope="module")
def rx():
    fe = IQFrontend(1e6, {n: VfoConfig(o, m) for n, (o, m) in RX_VFOS.items()},
                    fft_size=1024, fft_rate=125.0, device="cpu")
    block = 2 * fe.block_multiple()
    g = torch.Generator().manual_seed(17)
    x = torch.view_as_complex(torch.randn(2, block, 2, generator=g) * 0.1)
    return fe, x


def push(fe, xs):
    """Every block through a new `Receiver`'s `push`: each sink's
    outputs."""
    audio = {n: [] for n in RX_VFOS}
    spec = []
    Receiver(fe, block_len=xs.shape[-1],
             audio_sinks={n: audio[n].append for n in audio},
             spectrum_sink=spec.append).push(xs.reshape(-1).numpy())
    return audio, spec


def test_receiver_spans_nest_as_its_layers(rx):
    fe, xs = rx
    _, spans = traced(lambda: push(fe, xs))
    step = [("sdrtpu.waterfall", []), ("sdrtpu.channelizer", []),
            ("sdrtpu.rx.radio", []), ("sdrtpu.rx.radio", []),
            ("sdrtpu.rx.ddc", []), ("sdrtpu.rx.radio", []),
            ("sdrtpu.rx.ddc", []), ("sdrtpu.rx.radio", [])]
    assert tree(spans) == [("sdrtpu.rx.frontend", step)] * len(xs)
    assert siblings_apart(spans, RX_LAYERS)


def test_radio_spans_carry_their_mode(monkeypatch, rx):
    from sdrtpu_torch.apps import radio

    fe, xs = rx
    opened = []

    def recording(name, args=None):
        opened.append((name, args))
        return metrics.span(name, args)

    monkeypatch.setattr(radio, "span", recording)
    fe(fe.init_state(), xs[0])
    assert opened == [("sdrtpu.rx.radio", m)
                      for m in ("wfm", "wfm", "nfm", "cw")]


def test_receiver_opens_no_span_without_the_profiler(monkeypatch, rx):
    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    fe, xs = rx
    audio, spec = push(fe, xs)
    assert len(spec) == len(xs) and all(len(a) == len(xs)
                                        for a in audio.values())


def test_receiver_outputs_bit_equal_with_the_profiler_on(rx):
    fe, xs = rx
    plain = push(fe, xs)
    on, spans = traced(lambda: push(fe, xs))
    assert spans
    (want, nest), (got, nest_on) = tree_flatten(plain), tree_flatten(on)
    assert nest == nest_on
    for a, b in zip(want, got, strict=True):
        assert np.array_equal(a, b)
