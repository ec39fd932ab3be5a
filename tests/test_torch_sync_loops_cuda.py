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
1e-4 rad on the carried phase and frequency, NaN where the plain loop
has NaN and nowhere else.  `mm_scan`: equal valid
counts, symbols within 1e-5 of the block peak, carried offset equal;
the same at the wider banks (16 taps x 256 phases, 8 x 1024, 32 x 1600
above the default 48 KB of shared memory), with the taps summed as the
plain version's pairwise tree.

`costas_mm_scan` (both loops in one launch, the M&M walk a window behind
the Costas walk) against `costas_scan` then `mm_scan` on the card: equal
to the bit, no tolerance (the same step code on the same values), the
symbols, valid mask, every carry and the new tail; and 50 launches at the
Meteor block's shape, each on a row of its own, each equal to the two
launches.  Before each fused launch of the race check and of one case of
the match, the allocator's free blocks of the row's size are filled with
NaN (`_poison`), so a window read before the Costas warp wrote it reads
NaN or another row's samples, never the right ones.

`costas_identity_check` sweeps every float32 pattern through the forms
the Costas and PLL kernels put in place of the library's: `sincos_small`
and sincosf for sinf/cosf, `wrap_pi_fast` and `wrap_pi_turn`
(``csrc/phase_wrap.cuh``) for the division's wrap, the max.NaN /
min.NaN clip for the compare-and-select clip.  Tolerance: none, a NaN
equal to any NaN.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import clock, loops  # noqa: E402


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _same_bits(a, b) -> bool:
    """Equal to the bit, a NaN equal to any NaN (complex as pairs)."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32))


def _psk(rng, rows, n, order, cfo=0.004, case="psk"):
    sym = np.exp(2j * np.pi * rng.integers(0, order, (rows, n)) / order)
    x = sym * np.exp(1j * (cfo * np.arange(n) + 0.3))
    x = x + 0.05 * (rng.standard_normal((rows, n))
                    + 1j * rng.standard_normal((rows, n)))
    if case == "nan":
        x[:, n // 2] = np.nan
    if case == "phase -0":
        x[:, :16] = 0
    return torch.as_tensor(x.astype(np.complex64), device="cuda")


# cases past plain PSK: "wrap-heavy" (a carrier of 1/50 of the rate: the
# phase crosses +-pi every 50 steps), "general walk" (the same from a
# phase of 100 rad, past the bounded walk's reach: sincosf and the wrap
# by the division), "nan" (one NaN sample: NaN from there on, in both),
# "phase -0" (phase0 = -0.0 over 16 zero samples); n = 1025 and 2049
# leave a ragged last tile of the kernel's 1024
@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,mode,case", [
    (1, 500, loops.COSTAS_ORDER2, "psk"),
    (1, 3000, loops.COSTAS_ORDER4, "psk"),
    (1, 3000, loops.COSTAS_BROKEN, "psk"),
    (1, 1000, loops.COSTAS_ORDER8, "psk"),
    (2, 700, loops.COSTAS_ORDER4, "psk"),
    (1, 257, loops.COSTAS_ORDER4, "psk"),
    (1, 1025, loops.COSTAS_ORDER4, "psk"),
    (2, 2049, loops.COSTAS_ORDER4, "psk"),
    (1, 3000, loops.COSTAS_ORDER4, "wrap-heavy"),
    (1, 3000, loops.COSTAS_ORDER4, "general walk"),
    (1, 2000, loops.COSTAS_BROKEN, "general walk"),
    (1, 3000, loops.COSTAS_ORDER4, "nan"),
    (1, 3000, loops.COSTAS_ORDER4, "phase -0")])
def test_costas_scan_kernel_matches_plain(rows, n, mode, case):
    _need_card()
    rng = np.random.default_rng(5)
    turning = case in ("wrap-heavy", "general walk")
    cfo = 2 * np.pi / 50 if turning else 0.004
    x = _psk(rng, rows, n, 8 if mode == loops.COSTAS_ORDER8 else 4, cfo,
             case)
    phase0 = {"general walk": 100.0, "phase -0": -0.0}.get(case, 0.2)
    alpha, beta = loops.critically_damped(0.005)
    args = (x, torch.full((rows,), phase0, device="cuda"),
            torch.full((rows,), cfo if turning else 0.0, device="cuda"),
            float(np.float32(alpha)), float(np.float32(beta)),
            float(np.float32(-np.pi)), float(np.float32(np.pi)), mode)
    before = loops.costas_scan.launches
    y, ph, fr = loops.costas_scan(*args)
    torch.cuda.synchronize()
    assert loops.costas_scan.launches == before + 1
    y_ref, ph_ref, fr_ref = loops.costas_scan_ref(*args)
    # NaN exactly where the plain loop has NaN; the rest within tolerance
    nan = torch.isnan(y_ref)
    assert torch.equal(torch.isnan(y), nan)
    assert torch.equal(torch.isnan(ph), torch.isnan(ph_ref))
    assert torch.equal(torch.isnan(fr), torch.isnan(fr_ref))
    peak = y_ref[~nan].abs().max().item()
    assert (y - y_ref)[~nan].abs().max().item() <= 1e-5 * peak
    assert torch.nan_to_num(
        loops._wrap_pi(ph - ph_ref).abs()).max().item() <= 1e-4
    assert torch.nan_to_num((fr - fr_ref).abs()).max().item() <= 1e-4


def _nrz(rng, n, sps, noise):
    """Random +-1 symbols held for ``sps`` samples each (nearest-sample
    hold), noisy; at sps = 4 the draws of np.repeat(symbols, 4)[:n]."""
    nsym = int(n / sps) + 1
    x = rng.choice([-1.0, 1.0], nsym)[(np.arange(n) / sps).astype(int)]
    return x + noise * rng.standard_normal(n)


@pytest.mark.cuda
@pytest.mark.parametrize("cplx,n,taps,phases,shape", [
    (True, 3000, 8, 128, "test"), (False, 500, 8, 128, "test"),
    (True, 4500, 8, 128, "test"), (True, 3000, 16, 256, "test"),
    (False, 3000, 16, 256, "test"), (True, 3000, 8, 1024, "test"),
    (False, 2000, 8, 1024, "test"), (True, 2000, 12, 300, "test"),
    (False, 2000, 32, 1600, "test"), (True, 150_000, 8, 128, "meteor"),
    (False, 60_000, 8, 128, "falcon9")])
def test_mm_scan_kernel_matches_plain(cplx, n, taps, phases, shape):
    _need_card()
    rng = np.random.default_rng(6)
    omega = 25.0 / 12.0 if cplx else 5000.0 / 1187.5
    if shape == "meteor":
        from sdrtpu_torch.kernels.psk import MeteorDemod
        mm = MeteorDemod(device="cuda").recov
    elif shape == "falcon9":
        from sdrtpu_torch.decoders.falcon9 import FalconDemod
        mm = FalconDemod(device="cuda").recov
    else:
        mm = clock.MuellerMuller(omega, 1e-6, 0.01, 0.01, complex_mode=cplx,
                                 interp_phase_count=phases,
                                 interp_tap_count=taps, device="cuda")
    omega = mm.omega
    if cplx and shape == "meteor":
        x = (_nrz(rng, n, omega, 0.05)
             + 1j * _nrz(rng, n, omega, 0.05)) / np.sqrt(2)
    elif cplx:
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    else:
        x = _nrz(rng, n, omega if shape == "falcon9" else 4, 0.1)
    x = torch.as_tensor(x.astype(np.complex64 if cplx else np.float32),
                        device="cuda")
    # the paths' blocks are held in one launch against the plain version
    # on the CPU (~10 s); the rest in two, the second from a carried
    # state, against the plain version on the card
    cuts = (x[: n // 3], x[n // 3:]) if shape == "test" else (x,)
    hold = "cuda" if shape == "test" else "cpu"
    st = mm.init_state()
    for blk in cuts:
        ext = torch.cat([st["tail"], blk])[None].contiguous()
        fstate = torch.stack([st["phase"], st["freq"], st["last_out"]])[None]
        cstate = torch.stack([st[k] for k in ("p1", "p2", "c1", "c2")])[None]
        args = (ext, mm._bank, blk.shape[-1], mm.max_out(blk.shape[-1]),
                st["offset"].reshape(1), fstate, cstate,
                float(np.float32(omega * (1 - mm.omega_rel_limit))),
                float(np.float32(omega * (1 + mm.omega_rel_limit))),
                float(np.float32(mm.omega_gain)),
                float(np.float32(mm.mu_gain)))
        before = clock.mm_scan.launches
        got = clock.mm_scan(*args)
        torch.cuda.synchronize()
        assert clock.mm_scan.launches == before + 1
        want = clock.mm_scan_ref(*(a.to(hold) if torch.is_tensor(a) else a
                                   for a in args))
        assert int(got[1].sum()) == int(want[1].sum())
        for g, w in zip(got, want):
            assert _same_bits(g, w)
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


def _meteor_rows(rng, rows, n, case):
    """(rows, n) complex64 off QPSK held at the Meteor demodulator's 25/12
    samples a symbol: 100 Hz off at 150 ksps ("psk"), a carrier of 1/50
    of the rate ("wrap-heavy", "general walk"), the broken transmitter's
    phases ("broken"), one NaN half way ("nan"); any other case as
    "psk"."""
    k = np.arange(n)
    if case == "broken":
        ph = np.asarray(loops.BROKEN_PHASES)[rng.integers(0, 4, (rows, n))]
    else:
        ph = np.pi / 2 * rng.integers(0, 4, (rows, n)) + np.pi / 4
    ph = ph[:, k * 12 // 25]
    turn = (2 * np.pi / 50 if case in ("wrap-heavy", "general walk")
            else 2 * np.pi * 100.0 / 150_000.0)
    x = np.exp(1j * (ph + turn * k + 0.7))
    x = x + 0.05 * (rng.standard_normal((rows, n))
                    + 1j * rng.standard_normal((rows, n)))
    if case == "nan":
        x[:, n // 2] = np.nan
    return torch.as_tensor(x.astype(np.complex64), device="cuda")


def _two_launches(x, tail, phase0, freq0, alpha, beta, fmin, fmax, mode,
                  bank, n_out, carries, *gains):
    """`costas_scan` then `mm_scan` on the card, as `costas_mm_scan`
    returns them."""
    n = x.shape[1]
    y, ph, fr = loops.costas_scan(x, phase0, freq0, alpha, beta, fmin, fmax,
                                  mode)
    ext = torch.cat([tail, y], dim=-1)
    off, *f, p1, p2, c1, c2 = carries
    syms, valid, offset, fstate, cstate = clock.mm_scan(
        ext, bank, n, n_out, off, torch.stack(f, 1),
        torch.stack([p1, p2, c1, c2], 1), *gains)
    return (y, ph, fr, syms, valid, ext[:, n:],
            (offset - n, *fstate.unbind(1), *cstate.unbind(1)))


def _flat(out):
    return list(out[:-1]) + list(out[-1])


def _poison(like, count=4):
    """Hand ``count`` blocks of ``like``'s size, filled with NaN, back to
    the caching allocator, so the next tensors of that size start as
    NaN."""
    nan = complex(float("nan"), float("nan"))
    blocks = [torch.full_like(like, nan) for _ in range(count)]
    torch.cuda.synchronize()
    del blocks


def _meteor_args(rng, rows, n, mode, case):
    """`costas_mm_scan`'s positional arguments for `MeteorDemod`'s loops
    over ``rows`` rows of ``n`` samples, from carries a block in, and its
    `MuellerMuller`."""
    from sdrtpu_torch.kernels.psk import MeteorDemod

    d = MeteorDemod(device="cuda")
    mm, st = d.recov, d.recov.init_state()
    tail = 0.5 * _meteor_rows(rng, rows, mm.T - 1, "psk")
    carries = [st[k].to(dtype).expand(rows).clone()
               for k, dtype in clock._MM_LEAVES]
    carries[0] += 1  # the offset
    carries[1] += 0.4  # the phase
    turning = case in ("wrap-heavy", "general walk")
    phase0 = 100.0 if case == "general walk" else 0.2
    return (_meteor_rows(rng, rows, n, case), tail,
            torch.full((rows,), phase0, device="cuda"),
            torch.full((rows,), 2 * np.pi / 50 if turning else 0.0,
                       device="cuda"),
            *d.costas._coefficients(), mode, mm._bank, mm.max_out(n),
            carries, *mm._loop()), mm


# the Meteor block (150 000 samples, one row); n = 5 (below T - 1: the
# new tail holds old tail samples), 1 023, 1 024, 2 049 (tiles of 1 024,
# a window of 2 048) and 150 001; two rows; the wrap-heavy row and the
# general walk from 100 rad; the broken modulation's error; a NaN half
# way; three blocks, each from the carries the last gave, with and
# without the allocator's free blocks poisoned before each fused launch
@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,mode,case,blocks", [
    (1, 150_000, loops.COSTAS_ORDER4, "psk", 1),
    (1, 5, loops.COSTAS_ORDER4, "psk", 1),
    (1, 1023, loops.COSTAS_ORDER4, "psk", 1),
    (1, 1024, loops.COSTAS_ORDER4, "psk", 1),
    (1, 2049, loops.COSTAS_ORDER4, "psk", 1),
    (1, 150_001, loops.COSTAS_ORDER4, "psk", 1),
    (2, 20_000, loops.COSTAS_ORDER4, "psk", 1),
    (1, 20_000, loops.COSTAS_ORDER4, "wrap-heavy", 1),
    (1, 20_000, loops.COSTAS_ORDER4, "general walk", 1),
    (1, 20_000, loops.COSTAS_BROKEN, "broken", 1),
    (1, 20_000, loops.COSTAS_ORDER4, "nan", 1),
    (1, 30_000, loops.COSTAS_ORDER4, "psk", 3),
    (1, 150_000, loops.COSTAS_ORDER4, "poisoned", 3)])
def test_costas_mm_scan_matches_two_launches(rows, n, mode, case, blocks):
    _need_card()
    rng = np.random.default_rng(13)
    args, mm = _meteor_args(rng, rows, n, mode, case)
    x, fused, split = args[0], list(args), list(args)
    for b in range(blocks):
        blk = x[:, b * n // blocks:(b + 1) * n // blocks].contiguous()
        fused[0] = split[0] = blk
        fused[10] = split[10] = mm.max_out(blk.shape[1])  # n_out
        before = (loops.costas_scan.launches, clock.mm_scan.launches,
                  clock.costas_mm_scan.launches)
        if case == "poisoned":
            _poison(blk)
        got = clock.costas_mm_scan(*fused)
        torch.cuda.synchronize()
        assert (loops.costas_scan.launches, clock.mm_scan.launches,
                clock.costas_mm_scan.launches) == tuple(
                    c + 1 for c in before)
        want = _two_launches(*split)
        torch.cuda.synchronize()
        assert int(got[4].sum()) == int(want[4].sum()) > 0
        for k, (g, w) in enumerate(zip(_flat(got), _flat(want))):
            assert _same_bits(g, w), k
        # the next block from the carries each path gave
        fused[1:4] = [got[5], got[1], got[2]]
        fused[11] = list(got[6])
        split[1:4] = [want[5], want[1], want[2]]
        split[11] = list(want[6])


@pytest.mark.cuda
def test_costas_mm_scan_races_nowhere_over_50_launches():
    """The consumer warp reads each window only after the producer has
    published it: 50 launches at the Meteor block's shape, each on a row
    of its own and into NaN-filled memory (`_poison`), each equal to the
    bit to `costas_scan` then `mm_scan` on the same row."""
    _need_card()
    rng = np.random.default_rng(3)
    args, _ = _meteor_args(rng, 1, 150_000, loops.COSTAS_ORDER4, "psk")
    args = list(args)
    for _ in range(50):
        args[0] = _meteor_rows(rng, 1, 150_000, "psk")
        _poison(args[0])
        got = _flat(clock.costas_mm_scan(*args))
        torch.cuda.synchronize()
        want = _flat(_two_launches(*args))
        torch.cuda.synchronize()
        assert all(_same_bits(g, w) for g, w in zip(got, want))
        del got, want


# the counters of `costas_identity_check`, in its order
IDENTITY_COUNTS = ("patterns", "small_patterns", "sincosf_differ",
                   "sincos_small_differ", "wrap_fast_patterns",
                   "wrap_fast_differ", "wrap_turn_patterns",
                   "wrap_turn_differ", "clip_differ")


def _bits(v: float) -> int:
    return int(np.array(v, np.float32).view(np.uint32))


@pytest.mark.cuda
def test_phase_identities_hold_over_every_float32():
    """Over all 2^32 float32 patterns v: among those with |v| <= 4, where
    sincosf(v) and `sincos_small(v)` differ from sinf(v), cosf(v) in any
    bit; among those below loops.COSTAS_WRAP_FAST, where `wrap_pi_fast`
    differs from the division's wrap (counted over all); among those
    below COSTAS_WRAP_TURN, where `wrap_pi_turn` does, its turn's bits an
    immediate or a parameter; and where the clip differs from the
    compare-and-select clip at (-1, 1) and (-pi, pi).  No difference
    anywhere, and each domain holds the patterns its bound's bits give:
    2 * bits(t) below t, 2 * (bits(4) + 1) up to 4."""
    _need_card()
    from sdrtpu_torch import _build

    check = _build.bind("sync_loops", "costas_identity_check",
                        (ctypes.c_float,) * 2 + (ctypes.c_void_p,) * 2)
    counts = torch.zeros(len(IDENTITY_COUNTS), dtype=torch.int64,
                         device="cuda")
    rc = check(loops.COSTAS_WRAP_FAST, loops.COSTAS_WRAP_TURN,
               counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    got = dict(zip(IDENTITY_COUNTS, counts.tolist()))
    assert got == {
        "patterns": 2 ** 32,
        "small_patterns": 2 * (_bits(4.0) + 1),
        "wrap_fast_patterns": 2 * _bits(loops.COSTAS_WRAP_FAST),
        "wrap_turn_patterns": 2 * _bits(loops.COSTAS_WRAP_TURN),
        **{k: 0 for k in IDENTITY_COUNTS if k.endswith("_differ")}}
