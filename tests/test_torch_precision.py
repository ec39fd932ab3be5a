"""`sdrtpu_torch._precision.fp32_contractions`: the port's contractions
run in full float32 whatever TF32 settings the caller made, and the
caller's settings come back afterwards (also when the body raises).

On the CPU no contraction runs in TF32, so these tests hold the settings
themselves: inside the helper PyTorch reports full float32 for cuBLAS
and no TF32 for cuDNN; outside, what the caller set.  Each test puts the
process's defaults back.  The card-only test
`tests/test_torch_tf32_cuda.py` holds the bits.  No tolerance: the
settings are compared for equality.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch._precision import fp32_contractions  # noqa: E402


@pytest.fixture
def restore_defaults():
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


def _settings():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("caller", [("high", True), ("medium", True),
                                    ("highest", False), ("high", False)])
def test_sets_and_restores_both_flags(caller, restore_defaults):
    torch.set_float32_matmul_precision(caller[0])
    torch.backends.cudnn.allow_tf32 = caller[1]
    with fp32_contractions():
        assert _settings() == ("highest", False)
        assert not torch.backends.cuda.matmul.allow_tf32
    assert _settings() == caller


def test_restores_when_the_body_raises(restore_defaults):
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    with pytest.raises(RuntimeError, match="boom"):
        with fp32_contractions():
            raise RuntimeError("boom")
    assert _settings() == ("high", True)


def test_nests(restore_defaults):
    torch.set_float32_matmul_precision("high")
    with fp32_contractions():
        with fp32_contractions():
            assert _settings()[0] == "highest"
        assert _settings()[0] == "highest"
    assert _settings()[0] == "high"


def test_threads_share_one_pin(restore_defaults):
    """Two threads inside the helper at once, interleaved as two chains
    in two threads would be: A enters, B enters, A leaves while B is
    still inside (B's contraction must still see full float32), then B
    leaves and the caller's settings are back."""
    import threading

    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen, errors = {}, []

    def thread_a():
        try:
            with fp32_contractions():
                a_in.set()
                assert b_in.wait(10)
            a_out.set()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def thread_b():
        try:
            assert a_in.wait(10)
            with fp32_contractions():
                b_in.set()
                assert a_out.wait(10)
                seen["b_after_a_left"] = _settings()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert seen["b_after_a_left"] == ("highest", False)
    assert _settings() == ("high", True)


def test_newer_interface_is_kept_to():
    """A caller that set ``fp32_precision`` (PyTorch's newer interface)
    gets it back, and the helper never reads the older interface, which
    raises after such a write.  Run in its own process: the newer
    interface cannot be undone in this one."""
    if not hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        pytest.skip("this PyTorch has only the older interface")
    code = (
        "import torch\n"
        "from sdrtpu_torch._precision import fp32_contractions\n"
        "m = torch.backends.cuda.matmul\n"
        "m.fp32_precision = 'tf32'\n"
        "torch.backends.cudnn.conv.fp32_precision = 'tf32'\n"
        "with fp32_contractions():\n"
        "    assert m.fp32_precision == 'ieee'\n"
        "    assert torch.backends.cudnn.conv.fp32_precision == 'ieee'\n"
        "assert m.fp32_precision == 'tf32'\n"
        "assert torch.backends.cudnn.conv.fp32_precision == 'tf32'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_every_contraction_site_runs_inside(monkeypatch, restore_defaults):
    """The banded-Toeplitz FIR, the polyphase resampler, the dense and
    the sparse alias fold, K2's plain version and the feed-forward
    interpolator each contract with TF32 off while the caller has it
    on."""
    from sdrtpu_torch.kernels import clock, fir, fused_channelizer, resample
    from sdrtpu_torch.shard import channelizer

    seen = []
    real_matmul, real_einsum = torch.matmul, torch.einsum
    real_mm = torch.Tensor.__matmul__

    def spy(fn):
        def wrapped(*a, **k):
            seen.append(torch.get_float32_matmul_precision())
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torch, "matmul", spy(real_matmul))
    monkeypatch.setattr(torch, "einsum", spy(real_einsum))
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy(real_mm))
    torch.set_float32_matmul_precision("high")
    rng = np.random.default_rng(0)
    x = torch.as_tensor((rng.standard_normal(4000)
                         + 1j * rng.standard_normal(4000)).astype(np.complex64))
    fir.matmul_correlate_valid(x, rng.standard_normal(317))
    rs = resample.PolyphaseResampler(24, 125, rng.standard_normal(300),
                                     device="cpu")
    rs(rs.init_state(), x[:2000])
    for db in (None, -100.0):
        rr = resample.RationalResampler(10e6, 250e3, device="cpu")
        stages = [(np.asarray(s.taps), s.decimation)
                  for s in rr.predecim.stages]
        ch = channelizer.FftDecimatorChain([1e5, -2.2e6], 10e6, stages,
                                           40000, sparse_thresh_db=db,
                                           device="cpu")
        assert ch._sparse == (db is not None)
        ch(ch.init_state(), torch.zeros(40000, dtype=torch.complex64))
    st = fused_channelizer.FusedChannelizerStage(
        [1e5], 2e6, rng.standard_normal(20), 4, 2048, device="cpu")
    st(st.init_state(), x[:2048])
    ff = clock.FeedforwardSymbolSync(4, device="cpu")
    ff(ff.init_state(), x[:400])
    assert len(seen) >= 6 and set(seen) == {"highest"}, seen
    assert torch.get_float32_matmul_precision() == "high"
