"""The Costas and Mueller & Muller scan kernels against their plain
PyTorch loops, on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_sync_loops_cuda.py -q --noconftest

Tolerances: the kernels round every product and sum on their own and sum
the interpolator taps in the plain loop's order, so they agree with the
plain loops to the last place except where PyTorch divides by a Python
scalar (the phase wrap multiplies by the reciprocal) or its sinf/cosf
differ by an ulp.  `costas_scan`: 1e-5 of the peak on the output and
1e-4 rad on the carried phase and frequency.  `mm_scan`: equal valid
counts, symbols within 1e-5 of the block peak, carried offset equal;
the same at the wider banks (16 taps x 256 phases, 8 x 1024, 32 x 1600
above the default 48 KB of shared memory), with the taps summed as the
plain version's pairwise tree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import clock, loops  # noqa: E402


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _psk(rng, rows, n, order):
    sym = np.exp(2j * np.pi * rng.integers(0, order, (rows, n)) / order)
    x = sym * np.exp(1j * (0.004 * np.arange(n) + 0.3))
    x = x + 0.05 * (rng.standard_normal((rows, n))
                    + 1j * rng.standard_normal((rows, n)))
    return torch.as_tensor(x.astype(np.complex64), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,mode", [
    (1, 500, loops.COSTAS_ORDER2), (1, 3000, loops.COSTAS_ORDER4),
    (1, 3000, loops.COSTAS_BROKEN), (1, 1000, loops.COSTAS_ORDER8),
    (2, 700, loops.COSTAS_ORDER4), (1, 257, loops.COSTAS_ORDER4)])
def test_costas_scan_kernel_matches_plain(rows, n, mode):
    _need_card()
    rng = np.random.default_rng(5)
    x = _psk(rng, rows, n, 8 if mode == loops.COSTAS_ORDER8 else 4)
    alpha, beta = loops.critically_damped(0.005)
    args = (x, torch.full((rows,), 0.2, device="cuda"),
            torch.zeros(rows, device="cuda"), float(np.float32(alpha)),
            float(np.float32(beta)), float(np.float32(-np.pi)),
            float(np.float32(np.pi)), mode)
    before = loops.costas_scan.launches
    y, ph, fr = loops.costas_scan(*args)
    torch.cuda.synchronize()
    assert loops.costas_scan.launches == before + 1
    y_ref, ph_ref, fr_ref = loops.costas_scan_ref(*args)
    peak = y_ref.abs().max().item()
    assert (y - y_ref).abs().max().item() <= 1e-5 * peak
    assert loops._wrap_pi(ph - ph_ref).abs().max().item() <= 1e-4
    assert (fr - fr_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cplx,n,taps,phases", [
    (True, 3000, 8, 128), (False, 500, 8, 128), (True, 4500, 8, 128),
    (True, 3000, 16, 256), (False, 3000, 16, 256), (True, 3000, 8, 1024),
    (False, 2000, 8, 1024), (True, 2000, 12, 300), (False, 2000, 32, 1600)])
def test_mm_scan_kernel_matches_plain(cplx, n, taps, phases):
    _need_card()
    rng = np.random.default_rng(6)
    omega = 25.0 / 12.0 if cplx else 5000.0 / 1187.5
    mm = clock.MuellerMuller(omega, 1e-6, 0.01, 0.01, complex_mode=cplx,
                             interp_phase_count=phases,
                             interp_tap_count=taps, device="cuda")
    if cplx:
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    else:
        x = np.repeat(rng.choice([-1.0, 1.0], n // 4 + 1), 4)[:n]
        x = x + 0.1 * rng.standard_normal(n)
    x = torch.as_tensor(x.astype(np.complex64 if cplx else np.float32),
                        device="cuda")
    st = mm.init_state()
    for blk in (x[: n // 3], x[n // 3:]):  # a carried state in the 2nd
        ext = torch.cat([st["tail"], blk])[None].contiguous()
        fstate = torch.stack([st["phase"], st["freq"], st["last_out"]])[None]
        cstate = torch.stack([st[k] for k in ("p1", "p2", "c1", "c2")])[None]
        args = (ext, mm._bank, blk.shape[-1], mm.max_out(blk.shape[-1]),
                st["offset"].reshape(1), fstate, cstate,
                float(np.float32(omega * 0.99)),
                float(np.float32(omega * 1.01)), float(np.float32(1e-6)),
                float(np.float32(0.01)))
        before = clock.mm_scan.launches
        got = clock.mm_scan(*args)
        torch.cuda.synchronize()
        assert clock.mm_scan.launches == before + 1
        want = clock.mm_scan_ref(*args)
        assert int(got[1].sum()) == int(want[1].sum())
        assert torch.equal(got[1], want[1])
        peak = want[0].abs().max().item()
        assert (got[0] - want[0]).abs().max().item() <= 1e-5 * peak
        assert torch.equal(got[2], want[2])
        st, _ = mm(st, blk)


@pytest.mark.cuda
def test_mm_scan_refuses_a_bank_it_cannot_hold():
    """More than 32 taps, or a bank past one block's shared memory."""
    _need_card()
    for phases, taps in ((128, 33), (100_000, 8)):
        bank = torch.zeros((phases, taps), device="cuda")
        ext = torch.zeros((1, 100 + taps - 1), device="cuda")
        with pytest.raises(ValueError):
            clock.mm_scan(ext, bank, 100, 60, torch.zeros(1, dtype=torch.int32,
                                                          device="cuda"),
                          torch.zeros((1, 3), device="cuda"),
                          torch.zeros((1, 4), dtype=torch.complex64,
                                      device="cuda"), 3.9, 4.1, 1e-6, 0.01)
