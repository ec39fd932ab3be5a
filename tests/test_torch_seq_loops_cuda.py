"""The AGC and PLL scan kernels against their plain PyTorch loops, on the
card.

Needs an NVIDIA GPU and nvcc; skips without a card.  Imports no JAX, so
on a machine without it run it as

    python -m pytest tests/test_torch_seq_loops_cuda.py -q --noconftest

Tolerances: the kernel rounds every product and sum on its own, as the
plain loop's separate PyTorch kernels do, and the plain AGC divides a
tensor by a tensor (IEEE division, as the kernel), so `agc_scan`'s gains
and final average equal `agc_scan_ref`'s to the bit (a NaN equal to any
NaN), in both of the kernel's walks: the threshold walk, and the general
walk a row outside its domain takes (an average of -0.0, a negative
|x|).  The PLL's plain loop wraps by a division by a tensor (IEEE
division, as the kernel) and calls torch.atan2, torch.cos and
torch.sin, which on the card are the kernel's atan2f, cosf and sinf, so
`pll_scan`'s VCO phasor and carried phase and frequency equal
`pll_scan_ref`'s to the bit too, in both of its walks: the bounded walk
(no division) and the general walk a row from a phase past
loops.PLL_PHASE_BOUND takes.
Shapes: the receiver's (AGC: 750 steps for AM at 15 kHz, 1200 for SSB at
24 kHz, 150 for CW at 3 kHz at 50 ms blocks, and the receiver path's
4 800, 3 000 and 600 steps at 200 ms blocks; PLL: 12 500 and 25 000
steps at 250 kHz, the pll and rds paths' blocks), one and several rows,
real and complex input, the average starting at 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import loops  # noqa: E402


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _same_bits(a, b) -> bool:
    """Equal to the bit, a NaN equal to any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,cplx,walk", [
    (1, 750, False, "threshold"), (1, 1200, False, "threshold"),
    (1, 150, False, "threshold"), (1, 750, True, "threshold"),
    (5, 1200, True, "threshold"), (3, 257, False, "threshold"),
    (2, 6000, False, "threshold"), (1, 4800, False, "threshold"),
    (1, 3000, False, "threshold"), (1, 600, False, "threshold"),
    (1, 4800, False, "general: average -0.0"),
    (2, 3000, False, "general: a negative |x|")])
def test_agc_scan_kernel_matches_plain(rows, n, cplx, walk):
    _need_card()
    rng = np.random.default_rng(31)
    x = 1e-3 * rng.standard_normal((rows, n))
    if cplx:
        x = x + 1e-3j * rng.standard_normal((rows, n))
    x[:, :4] = 0.0                 # silence first: the average stays 0
    x[:, n // 2:n // 2 + 3] *= 3e4  # a burst trips the clipping look-ahead
    x = torch.as_tensor(x.astype(np.complex64 if cplx else np.float32),
                        device="cuda")
    fs = 15000.0
    agc = loops.Agc(1.0, 50.0 / fs, 5.0 / fs, max_gain=10e6,
                    max_output_amp=10.0, init_gain=np.inf, device="cuda")
    in_amp = x.abs().float().contiguous()
    smax = in_amp.flip(-1).cummax(-1).values.flip(-1).contiguous()
    amp0 = torch.zeros(rows, device="cuda")
    if walk == "general: average -0.0":
        amp0 = torch.full((rows,), -0.0, device="cuda")
    elif walk == "general: a negative |x|":
        in_amp[0, n // 3] = -1e-4
    atk, dcy = np.float32(50.0 / fs), np.float32(5.0 / fs)
    coef = (float(np.float32(1) - atk), float(atk),
            float(np.float32(1) - dcy), float(dcy), 1.0, 1e7, 10.0)
    before = loops.agc_scan.launches
    g, amp = loops.agc_scan(in_amp, smax, amp0, *coef)
    torch.cuda.synchronize()
    assert loops.agc_scan.launches == before + 1
    g_ref, amp_ref = loops.agc_scan_ref(in_amp, smax, amp0, *coef)
    assert bool(torch.isfinite(g).all())
    assert _same_bits(g, g_ref)
    assert _same_bits(amp, amp_ref)
    # the look-ahead fired: the gain falls by half or more at a step
    assert int((g_ref[:, 1:] < 0.5 * g_ref[:, :-1]).sum()) >= rows
    if walk != "threshold":
        return
    # through the op: same launch, state shape follows the rows
    st, y = agc(agc.init_state(), x if rows > 1 else x[0])
    assert loops.agc_scan.launches == before + 2
    assert st.shape == ((rows,) if rows > 1 else ())
    assert _same_bits(torch.view_as_real(y.reshape(rows, n)) if cplx
                      else y.reshape(rows, n),
                      torch.view_as_real(x * g_ref) if cplx else x * g_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,phase0,nan_row", [
    (1, 12500, 0.0, None), (3, 1000, 0.0, None), (2, 255, 0.0, None),
    (2, 25000, 0.0, None), (1, 12500, 100.0, None), (2, 1000, -0.0, 1)])
def test_pll_scan_kernel_matches_plain(rows, n, phase0, nan_row):
    _need_card()
    rng = np.random.default_rng(32)
    fs = 250000.0
    t = np.arange(n)
    f = 19000.0 + 40.0 * np.arange(rows)[:, None]
    x = (0.1 * np.exp(1j * (2 * np.pi * f / fs * t + 0.7))
         + 0.01 * (rng.standard_normal((rows, n))
                   + 1j * rng.standard_normal((rows, n))))
    if nan_row is not None:
        x[nan_row, n // 2] = np.nan  # a NaN sample: the carry turns NaN
    x = torch.as_tensor(x.astype(np.complex64), device="cuda")
    w = lambda hz: 2 * np.pi * hz / fs
    pll = loops.Pll(25000.0 / fs, init_freq=w(19000.0), min_freq=w(18750.0),
                    max_freq=w(19250.0), device="cuda")
    phase0 = torch.full((rows,), phase0, device="cuda")
    freq0 = torch.full((rows,), float(np.float32(w(19000.0))), device="cuda")
    coef = pll._coefficients()
    # phase 100 rad: a row outside the bounded walk's domain
    assert loops.pll_bounded(float(phase0[0]), coef[0], *coef[2:]) == (
        abs(float(phase0[0])) < 4)
    before = loops.pll_scan.launches
    vco, phase, freq = loops.pll_scan(x, phase0, freq0, *coef)
    torch.cuda.synchronize()
    assert loops.pll_scan.launches == before + 1
    vco_ref, phase_ref, freq_ref = loops.pll_scan_ref(x, phase0, freq0, *coef)
    assert _same_bits(torch.view_as_real(vco), torch.view_as_real(vco_ref))
    assert _same_bits(phase, phase_ref)
    assert _same_bits(freq, freq_ref)
    # locked onto the pilot by the end of the block
    clean = [r for r in range(rows) if r != nan_row]
    lock = torch.angle(vco[clean, -100:] * torch.conj(x[clean, -100:]))
    if n >= 1000:
        assert float(lock.abs().max()) < 0.5
    if nan_row is not None:
        assert bool(torch.isnan(phase[nan_row]))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _need_card()
    x = torch.zeros((2, 8), device="cuda")
    with pytest.raises(ValueError, match="contiguous 2-D"):
        loops.agc_scan(x.t(), x.t(), torch.zeros(8, device="cuda"),
                       0.9, 0.1, 0.9, 0.1, 1.0, 1e4, 10.0)
    with pytest.raises(ValueError, match="shapes disagree"):
        loops.pll_scan(x.to(torch.complex64), torch.zeros(3, device="cuda"),
                       torch.zeros(2, device="cuda"), 0.1, 0.01, -1.0, 1.0)
