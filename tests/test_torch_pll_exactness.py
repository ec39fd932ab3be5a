"""The `pll_scan` kernel's step and its row domain, checked on the CPU.

`pll_scan` (``csrc/seq_loops.cu``) walks a row in one of two ways,
decided once a row: a bounded row wraps both the phase error and the
new phase by a compare, a select and a subtraction (`wrap_pi_turn`, no
division),
any other row by the division (`wrap_pi`).  The two wraps give the same
bits below `loops.COSTAS_WRAP_TURN` (tests/test_torch_scan_exactness.py
checks every float32 around both thresholds), so a bounded row is right
as long as both wrap arguments stay below it at every step.

A numpy model of the kernel's step (float32 throughout, every product
and sum rounded on its own, the clip as max then min letting a NaN
through) runs each walk on the plain version's angles and is held to
the bit against `pll_scan_ref` on the CPU, a NaN equal to any NaN: on
a phase that wraps on 45 % of the steps, a NaN sample, a phase of
-0.0 over silent samples, a frequency pinned at each clip bound, and
the pll path's own pilot (a `BroadcastFm(pilot_mode="pll")` block's
`pll_scan` call).  The bounded model asserts at every step that both
wrap arguments lie below the turn.

The row predicate `loops.pll_bounded` (the kernel's `pll_params_bounded`
and its phase test) holds every row the paths drive, keeps both wrap
arguments below the turn for the adversarial corners of its domain,
and classes rows outside it as such.

The plain loops' wrap `loops._wrap_pi` divides by a tensor (one IEEE
division on either device); on the CPU it gives the same bits as the
scalar divisor it replaced, over sweeps of float32 phases.

No tolerance anywhere: every comparison is of bits.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import loops  # noqa: E402
from sdrtpu_torch.kernels.wfm import BroadcastFm  # noqa: E402

F32 = np.float32
TWO_PI = F32(loops._TWO_PI)
T = F32(loops.COSTAS_WRAP_FAST)
TURN = F32(loops.COSTAS_WRAP_TURN)
PI = F32(np.pi)
FS = 250000.0


def _rad(hz: float) -> float:
    return float(F32(2 * np.pi * hz / FS))


def _pilot_pll() -> loops.Pll:
    """The WFM pilot PLL of the pll and rds paths (`BroadcastFm`'s)."""
    return BroadcastFm(samplerate=FS, stereo=True, pilot_mode="pll",
                       device="cpu").pilot_pll


def _full_wrap(v):
    """The kernel's `wrap_pi`: one IEEE division, rint half to even."""
    return F32(v - TWO_PI * F32(np.rint(F32(v / TWO_PI))))


def _turn_wrap(v):
    """The kernel's `wrap_pi_turn` (for |v| < TURN): v - 2pi * sign(v)
    from |v| >= T, else v - (-0)."""
    if np.isnan(v):
        return F32(v - F32(-0.0))
    assert abs(v) < TURN, v
    return F32(v - (F32(np.copysign(TWO_PI, v)) if abs(v) >= T
                    else F32(-0.0)))


def _clip(v, lo, hi):
    """max.NaN then min.NaN: a NaN passes, as torch.clamp."""
    v = v if (v > lo or np.isnan(v)) else lo
    return v if (v < hi or np.isnan(v)) else hi


def _pll_model(x, phase0, freq0, alpha, beta, fmin, fmax, walk):
    """`pll_scan` on one row as the kernel steps it, on the plain
    version's angles; returns (vco (1, n), phase (1,), freq (1,)) and
    the number of steps whose wrap took a turn."""
    ang = torch.atan2(x.imag, x.real).numpy()
    wrap = _turn_wrap if walk == "bounded" else _full_wrap
    alpha, beta, fmin, fmax = (F32(c) for c in (alpha, beta, fmin, fmax))
    phase, freq = F32(phase0), F32(freq0)
    phases = np.empty(len(ang), F32)
    turns = 0
    with np.errstate(invalid="ignore"):
        for i, a in enumerate(ang):
            phases[i] = phase
            err = wrap(F32(a - phase))
            freq = _clip(F32(freq + F32(beta * err)), fmin, fmax)
            v = F32(F32(phase + freq) + F32(alpha * err))
            phase = wrap(v)
            turns += bool(abs(v) >= T)
    ph = torch.from_numpy(phases)[None]
    return ((torch.complex(torch.cos(ph), torch.sin(ph)),
             torch.tensor([phase]), torch.tensor([freq])), turns)


def _same(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32))


def _path_pilot_call():
    """The arguments of the `pll_scan` call of one `BroadcastFm(pilot_
    mode="pll")` block (12 500 samples at 250 kHz, as the pll path's) of
    a stereo FM station with a 19 kHz pilot."""
    n = 12500
    t = np.arange(n) / FS
    left, right = np.sin(2 * np.pi * 400 * t), np.sin(2 * np.pi * 1000 * t)
    mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
           + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
    x = (0.3 * np.exp(1j * np.cumsum(2 * np.pi * 75000.0 * mpx / FS))
         ).astype(np.complex64)
    fm = BroadcastFm(samplerate=FS, stereo=True, pilot_mode="pll",
                     device="cpu")
    calls = []
    plain = loops.pll_scan

    def record(*args):
        calls.append(args)
        return plain(*args)

    loops.pll_scan = record
    try:
        with torch.inference_mode():
            fm(fm.init_state(), torch.as_tensor(x))
    finally:
        loops.pll_scan = plain
    assert len(calls) == 1
    args = calls[0]
    return (args[0].clone(), float(args[1][0]), float(args[2][0]),
            *args[3:])


CASES = ["wrap-heavy", "pilot", "nan", "phase -0", "freq at fmin",
         "freq at fmax", "pll path"]


def _case(case):
    """(x (n,) complex64, phase0, freq0, alpha, beta, fmin, fmax)."""
    if case == "pll path":
        return _path_pilot_call()
    rng = np.random.default_rng(CASES.index(case))
    n = 3000
    pilot = _pilot_pll()
    alpha, beta, fmin, fmax = pilot._coefficients()
    hz, phase0, freq0 = 19000.0, 0.0, _rad(19000.0)
    if case == "wrap-heavy":
        # a carrier at 0.45 of the rate in a loop clipped at +-pi: the
        # phase wraps on 45 % of the steps
        alpha, beta = (float(F32(c)) for c in loops.critically_damped(0.1))
        fmin, fmax = float(-PI), float(PI)
        hz, freq0 = 0.45 * FS, float(F32(2 * np.pi * 0.45))
    elif case == "freq at fmin":
        hz = 17000.0  # below the loop's reach: its frequency pins at fmin
    elif case == "freq at fmax":
        hz = 21000.0
    t = np.arange(n)
    x = (0.1 * np.exp(1j * (2 * np.pi * hz / FS * t + 0.7))
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    if case == "nan":
        x[n // 2] = np.nan
    if case == "phase -0":
        x[:16] = 0
        phase0 = -0.0
    return (torch.as_tensor(x.astype(np.complex64))[None], phase0, freq0,
            alpha, beta, fmin, fmax)


@pytest.mark.parametrize("walk", ["general", "bounded"])
@pytest.mark.parametrize("case", CASES)
def test_pll_step_model_is_the_plain_loop(case, walk):
    x, phase0, freq0, alpha, beta, fmin, fmax = _case(case)
    assert loops.pll_bounded(phase0, alpha, fmin, fmax)
    want = loops.pll_scan_ref(x, torch.tensor([phase0]),
                              torch.tensor([freq0]), alpha, beta, fmin, fmax)
    got, turns = _pll_model(x[0], phase0, freq0, alpha, beta, fmin, fmax,
                            walk)
    for g, w in zip(got, want):
        assert _same(g, w)
    n = x.shape[-1]
    assert turns > 100  # the wraps took a turn often
    if case == "wrap-heavy":
        assert turns > 0.4 * n
    if case == "nan":
        assert torch.isnan(want[1]).all() and torch.isnan(want[2]).all()
    if case == "phase -0":
        # the silent samples emit the phase of -0.0: sin(-0) = -0
        assert torch.signbit(want[0][0, 0].imag)
    if case.startswith("freq at"):
        bound = F32(fmin if case.endswith("fmin") else fmax)
        assert F32(want[2][0]) == bound


def test_driven_rows_are_bounded():
    """The pilot PLL of the pll and rds paths, from its initial phase,
    and the loops of the card checks' rows."""
    pilot = _pilot_pll()
    alpha, _, fmin, fmax = pilot._coefficients()
    phase0 = float(pilot.init_state()[0])
    assert (fmin, fmax) == (_rad(18750.0), _rad(19250.0))
    assert loops.pll_bounded(phase0, alpha, fmin, fmax)
    assert loops.pll_bounded(-0.0, alpha, fmin, fmax)
    # every phase a bounded row's wrap leaves keeps the row bounded
    assert loops.pll_bounded(float(PI), alpha, fmin, fmax)
    assert loops.pll_bounded(loops.PLL_PHASE_BOUND, alpha, fmin, fmax)
    # the loop's default bounds, +-pi
    alpha, _, fmin, fmax = loops.Pll(0.1, device="cpu")._coefficients()
    assert loops.pll_bounded(0.0, alpha, fmin, fmax)


def _reach(alpha, fmin, fmax, phase_bound):
    """The largest |wrap argument| of a bounded row's steps, over its
    adversarial corners: angles at +-float32(pi) and +-0, a phase at
    +-``phase_bound``, +-float32(pi) (what a wrap leaves) and +-0, the
    frequency at either bound, the error at +-float32(pi) and +-0; each
    sum rounded as the kernel rounds it."""
    alpha, fmin, fmax = F32(alpha), F32(fmin), F32(fmax)
    corners = [PI, -PI, F32(0.0), F32(-0.0)]
    phases = corners + [F32(phase_bound), F32(-phase_bound)]
    worst = F32(0)
    for ph in phases:
        for ang in corners:
            worst = max(worst, abs(F32(ang - ph)))
        for fr in (fmin, fmax):
            for err in corners:
                worst = max(worst, abs(F32(F32(ph + fr) + F32(alpha * err))))
    return worst


def test_adversarial_wrap_arguments_stay_within_a_turn():
    pilot = _pilot_pll()
    alpha, _, fmin, fmax = pilot._coefficients()
    assert _reach(alpha, fmin, fmax, loops.PLL_PHASE_BOUND) < TURN
    # every float32 a turn's wrap takes (|v| < TURN) it leaves within
    # float32(pi): the error, and the phase after the first step
    v = np.linspace(-float(TURN), float(TURN), 200001)[1:-1].astype(F32)
    assert max(abs(_turn_wrap(F32(u))) for u in v[::97]) <= PI
    # wherever the predicate holds, so does the bound, and its margin is
    # no wider than the sums' rounding needs: random loops on both sides
    rng = np.random.default_rng(5)
    inside = 0
    for _ in range(400):
        alpha = float(F32(rng.uniform(0, 2)))
        fmin, fmax = (float(F32(v)) for v in sorted(rng.uniform(-6, 6, 2)))
        if loops.pll_bounded(0.0, alpha, fmin, fmax):
            inside += 1
            assert _reach(alpha, fmin, fmax, loops.PLL_PHASE_BOUND) < TURN
        else:
            assert _reach(alpha, fmin, fmax, loops.PLL_PHASE_BOUND) > F32(
                0.99) * TURN
    assert 50 < inside < 350


@pytest.mark.parametrize("row", [
    "phase0 100", "phase0 3.3", "phase0 nan", "phase0 -inf", "fmin nan",
    "alpha 3", "bounds +-7"])
def test_rows_outside_the_domain(row):
    pilot = _pilot_pll()
    alpha, _, fmin, fmax = pilot._coefficients()
    phase0 = 0.0
    what, value = row.split(" ")
    if what == "phase0":
        phase0 = float(value)
    elif what == "fmin":
        fmin = float("nan")
    elif what == "alpha":
        alpha = 3.0
    else:
        fmin, fmax = -7.0, 7.0
    assert not loops.pll_bounded(phase0, alpha, fmin, fmax)


def test_kernel_bound_is_the_predicate_bound():
    """The kernel's kPllPhaseBound is loops.PLL_PHASE_BOUND, and its
    parameter test is the predicate's formula."""
    src = (Path(loops.__file__).resolve().parents[1] / "csrc"
           / "seq_loops.cu").read_text()
    bound = re.search(r"constexpr float kPllPhaseBound = ([0-9.]+)f;", src)
    assert bound and float(bound.group(1)) == loops.PLL_PHASE_BOUND
    assert re.search(
        r"kPllPhaseBound \+ fmaxf\(fabsf\(fmin\), fabsf\(fmax\)\) \+\s+"
        r"fabsf\(alpha\) \* kPllPhaseBound;", src)
    assert "reach < 0.999f * wrap_turn" in src


def _wrap_sweep(name: str) -> np.ndarray:
    """float32 phases: every 4 099th bit pattern (NaNs and infinities
    among them), the multiples of pi and 2pi up to 2 000 turns with 8
    ulps either side (where the quotient rounds half to even or lands
    on a turn), or 2^20 uniform phases within 64 turns."""
    if name == "bit patterns":
        bits = np.arange(0, 2**32, 4099, dtype=np.uint64).astype(np.uint32)
        return bits.view(F32)
    if name == "near half turns":
        k = np.arange(-4000, 4001, dtype=np.float64)
        centre = (k * np.pi).astype(F32)
        return np.concatenate([_ulps(centre, d) for d in range(-8, 9)])
    rng = np.random.default_rng(13)
    return rng.uniform(-128 * np.pi, 128 * np.pi, 2**20).astype(F32)


def _ulps(v: np.ndarray, d: int) -> np.ndarray:
    """``v`` moved by ``d`` float32 steps."""
    out = v.copy()
    for _ in range(abs(d)):
        out = np.nextafter(out, F32(np.inf) if d > 0 else F32(-np.inf))
    return out


@pytest.mark.parametrize("sweep", ["bit patterns", "near half turns",
                                   "uniform"])
def test_wrap_pi_tensor_divisor_is_the_scalar_divisor(sweep):
    """`loops._wrap_pi` (a tensor divisor) gives the bits on the CPU of
    phase - 2pi * round(phase / 2pi) with the Python scalar divisor, a
    NaN equal to any NaN."""
    v = _wrap_sweep(sweep)
    p = torch.from_numpy(v)
    got = loops._wrap_pi(p).numpy()
    want = (p - loops._TWO_PI * torch.round(p / loops._TWO_PI)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), v[~same][:8]
