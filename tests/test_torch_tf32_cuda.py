"""The port's float32 contractions on the card with TF32 turned on
globally: the same bits as with PyTorch's default flags.

Needs an NVIDIA GPU; skips without a card.  Imports no JAX, so on a
machine without it run it as

    python -m pytest tests/test_torch_tf32_cuda.py -q --noconftest

Tolerance: none.  Each contraction that stands in for one the reference
pins to full precision runs inside `fp32_contractions`, so a caller's
``set_float32_matmul_precision("high")`` and ``cudnn.allow_tf32`` do not
reach it: outputs are ``torch.equal`` to the default-flag run, and the
caller's flags are still set afterwards.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")


@pytest.fixture
def flags():
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


def _contractions():
    """name -> a function returning the contraction's output on the card
    at a shape of the main paths."""
    from sdrtpu_torch.kernels import fir, fused_channelizer, resample, taps
    from sdrtpu_torch.kernels.wfm import BroadcastFm
    from sdrtpu_torch.shard import channelizer

    rng = np.random.default_rng(9)

    def cplx(n):
        return torch.as_tensor((rng.standard_normal(n) + 1j
                                * rng.standard_normal(n)).astype(np.complex64),
                               device="cuda")

    x = cplx(500_000)
    real = x.real.contiguous()
    pilot = BroadcastFm(75000.0, 250e3, pilot_mode="envelope",
                        device="cuda").pilot_fir
    assert pilot.method == "mm"
    h = pilot.taps
    rs = resample.PolyphaseResampler(
        24, 125, taps.low_pass(15e3, 4e3, 6e6) * 24, dtype=torch.float32,
        device="cuda")
    rr = resample.RationalResampler(10e6, 250e3, device="cuda")
    stages = [(np.asarray(s.taps), s.decimation) for s in rr.predecim.stages]
    offs = np.linspace(-0.4, 0.4, 8) * 10e6
    dense = channelizer.FftDecimatorChain(offs, 10e6, stages, 500_000,
                                          skip_rotator=True, device="cuda")
    sparse = channelizer.FftDecimatorChain(offs, 10e6, stages, 500_000,
                                           sparse_thresh_db=-100.0,
                                           device="cuda")
    assert sparse._sparse
    k2 = fused_channelizer.FusedChannelizerStage(
        offs, 10e6, np.asarray(stages[0][0]), stages[0][1], 500_000,
        device="cuda")
    st = k2.init_state()
    args = (st["tail"], x, k2._coarse, k2._fine, k2._taps, st["phase"],
            k2.decim)
    return {
        "pilot fir": lambda: pilot(pilot.init_state(), real[:62_500])[1],
        "pilot taps on complex": lambda: fir.matmul_correlate_valid(
            x[:62_500], h, H=pilot._H),
        "resampler 24/125": lambda: rs(rs.init_state(), real[:250_000])[1],
        "dense fold": lambda: dense(dense.init_state(), x)[1],
        "sparse fold": lambda: sparse(sparse.init_state(), x)[1],
        "K2 plain version": lambda: fused_channelizer.mix_decimate_ref(
            *args),
    }


@pytest.mark.cuda
def test_tf32_on_gives_the_default_bits(flags):
    _need_card()
    fns = _contractions()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    want = {k: fn() for k, fn in fns.items()}
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    got = {k: fn() for k, fn in fns.items()}
    torch.cuda.synchronize()
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cudnn.allow_tf32
    for k in fns:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_tf32_would_change_an_unpinned_matmul(flags):
    """The check has teeth: the same product outside the helper does
    change under TF32 on this card."""
    _need_card()
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.standard_normal((512, 512)).astype(np.float32),
                        device="cuda")
    torch.set_float32_matmul_precision("highest")
    full = a @ a
    torch.set_float32_matmul_precision("high")
    tf32 = a @ a
    assert not torch.equal(full, tf32)
