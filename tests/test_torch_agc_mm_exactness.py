"""The identities the redesigned `agc_scan` and `mm_scan` rest on, and
numpy models of their walks, checked on the CPU against the plain
versions.

`agc_scan` (``csrc/seq_loops.cu``) takes the clip test of a step,
``RN(ia * min(RN(set_point / a), max_gain)) > max_out``, as ``a < A'``
with one threshold A' a sample (`agc_clip_threshold`: -inf where the
step never clips).  The identity is checked over every float32 ``a`` in
a window of 4 000 ulps around the threshold (and around its estimate
``set_point / G`` where it is -inf) for seeded ``ia`` spread over
1e-8 .. 1e3, and at the edges: ``ia`` 0, -0, subnormal, the largest
float32, +inf and NaN; ``max_gain`` NaN, 0 and below the threshold;
``set_point`` the smallest subnormal and the largest float32;
``max_out`` 0, subnormal, +inf.  The threshold walk's model (products
and thresholds off the chain, the average recorded and the gains formed
behind it, a silent sample as the decay branch with coefficient 1 and
addend +0) and the general walk (the plain step) are held to the bit
against `agc_scan_ref` over bursts that trip the clipping look-ahead,
from an average of 0 (``init_gain = inf``), of -0.0 and of 1e-3.

`mm_scan` (``csrc/sync_loops.cu``) walks a window's symbols in batches
of steps that need no bounds check: with ``min(fmin, fmax) >= |mu|`` and
a phase in [0, 1] the offset never falls and rises by at most ``dmax =
floor(RN(RN(1 + fmax) + |mu|))`` a symbol, so a batch of ``k`` symbols
stays inside the window and before ``n``.  For a power-of-two phase
count the bank row comes from the step's ``nphase`` as ``floor(nphase
* P) - floor(nphase) * P`` (exact: both products scale by 2^k), and the
error's product with ``p1`` is formed for both signs of the new symbol
before it is known.  The model is held to the bit against `mm_scan_ref`
at 8, 16 and 32 taps (complex and float), at power-of-two and other
phase counts, at loop bounds that push the window's edge (``fmax`` near
the window, ``mu_gain`` large), with ``n_out`` reached inside a window,
and on a row whose loop bounds leave the fast walk (checked steps only).

No tolerance anywhere: every comparison is of bits (a NaN equal to a
NaN).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.kernels import clock, loops  # noqa: E402

F32 = np.float32
INF_BITS = 0x7F800000
FMAX = F32(np.finfo(F32).max)
TINY = np.uint32(1).view(F32)  # the smallest subnormal


def _bits(x) -> np.ndarray:
    x = np.asarray(x, F32)
    return np.where(np.isnan(x), np.uint32(0x7FC00000), x.view(np.uint32))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.complex64:
        a, b = a.view(F32), b.view(F32)
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _min_nan(a, b):
    """jnp.minimum / torch.clamp(max=): a NaN in ``a`` goes through."""
    return np.where((a < b) | np.isnan(a), a, b).astype(F32)


# -- agc_scan ------------------------------------------------------------

def _first_true(pred, f, t):
    """The first u in (f, t] with pred(u), elementwise, for a pred that
    is monotone (false, then true) with pred(t) true; by halving."""
    f, t = np.asarray(f, np.int64).copy(), np.asarray(t, np.int64).copy()
    while True:
        live = t - f > 1
        if not live.any():
            return t.astype(np.uint32)
        m = f + (t - f) // 2
        p = pred(m.astype(np.uint32))
        t = np.where(live & p, m, t)
        f = np.where(live & ~p, m, f)


def agc_clip_threshold(ia, set_point, max_gain, max_out):
    """The kernel's `agc_clip_threshold` for every ``ia``: G, the largest
    float32 g with RN(ia * g) <= max_out (+0 for ia = +inf, where the
    product exceeds max_out exactly for g > +0); then A, the smallest a
    in [+0, +inf] with RN(set_point / a) <= G, where max_gain > G; else
    -inf (never clips: ia 0, -0 or NaN, max_out +inf)."""
    ia = np.asarray(ia, F32)
    sp, mg, mo = F32(set_point), F32(max_gain), F32(max_out)
    never = ~((ia > 0) & (mo < np.inf))
    ia1 = np.where(never | (ia == np.inf), F32(1), ia)
    zero = np.zeros(ia.shape, np.int64)
    top = np.full(ia.shape, INF_BITS, np.int64)
    with np.errstate(all="ignore"):
        over = _first_true(lambda u: ia1 * u.view(F32) > mo, zero, top)
        # ia = +inf: RN(inf * g) > max_out exactly where g > +0
        G = np.where(ia == np.inf, F32(0), (over - np.uint32(1)).view(F32))
        never = never | ~(mg > G)
        G1 = np.where(never, F32(1), G)
        A = _first_true(lambda u: sp / u.view(F32) <= G1, zero, top)
    return np.where(never, F32(-np.inf), A.view(F32)).astype(F32)


def _clips(ia, a, set_point, max_gain, max_out):
    """The plain step's clip test at average ``a`` (before the test)."""
    with np.errstate(all="ignore"):
        g = _min_nan((F32(set_point) / a).astype(F32), F32(max_gain))
        return (ia * g).astype(F32) > F32(max_out)


def _window(centre: np.ndarray, ulps: int) -> np.ndarray:
    """Every float32 from ``centre`` - ulps to + ulps (bit patterns,
    kept within [+0, +inf])."""
    c = np.asarray(centre, F32).view(np.uint32).astype(np.int64)
    u = c[:, None] + np.arange(-ulps, ulps + 1)[None, :]
    return np.clip(u, 0, INF_BITS).astype(np.uint32).view(F32)


def _check_threshold(ia, set_point, max_gain, max_out, ulps=2000):
    ia = np.asarray(ia, F32)
    thr = agc_clip_threshold(ia, set_point, max_gain, max_out)
    with np.errstate(all="ignore"):
        # where it never clips, look around the estimate set_point / G
        est = np.where(np.isfinite(thr), thr,
                       F32(set_point) / (F32(max_out) / ia).astype(F32))
    est = np.where(np.isfinite(est), est, F32(1)).astype(F32)
    a = _window(est, ulps)
    want = _clips(ia[:, None], a, set_point, max_gain, max_out)
    got = a < thr[:, None]
    bad = np.argwhere(want != got)
    assert not bad.size, (
        f"{len(bad)} averages where the threshold disagrees, first at ia "
        f"{ia[bad[0, 0]]!r}, a {a[tuple(bad[0])]!r}")
    # NaN averages never clip, and neither does the threshold test
    assert not (F32(np.nan) < thr).any()
    return thr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agc_threshold_identity(seed):
    """Seeded ia spread over 1e-8 .. 1e3 (log-uniform), the receiver's
    parameters (set point 1, max gain 1e7, max output 10): the step
    clips exactly where a < A'."""
    rng = np.random.default_rng(seed)
    ia = (10.0 ** rng.uniform(-8, 3, 120)).astype(F32)
    thr = _check_threshold(ia, 1.0, 1e7, 10.0)
    # both kinds are covered: gains capped by max_gain never clip
    assert np.isinf(thr).any() and np.isfinite(thr).any()


@pytest.mark.parametrize("set_point,max_gain,max_out", [
    (1.0, 1e7, 10.0), (0.3, 1e4, 1.0), (2.5, 50.0, 0.7),
    (1.0, np.inf, 10.0), (1.0, np.nan, 10.0), (1.0, 0.0, 10.0),
    (1.0, -3.0, 10.0), (1.0, 1e7, 0.0), (1.0, 1e7, float(TINY)),
    (1.0, 1e7, np.inf), (float(TINY), 1e7, 10.0), (float(FMAX), 1e7, 10.0),
    (float(FMAX), np.inf, float(FMAX))])
def test_agc_threshold_identity_at_the_edges(set_point, max_gain, max_out):
    """The edges of the domain and of the inputs: ia 0, -0, subnormal,
    tiny and huge normal, the largest float32, +inf and NaN, each over
    every average around its threshold."""
    ia = np.array([0.0, -0.0, TINY, 3 * TINY, 1e-40, 1e-30, 1e-8, 1e-3,
                   0.5, 1.0, 7.0, 1e3, 1e20, 1e38, FMAX, np.inf, np.nan],
                  F32)
    thr = _check_threshold(ia, set_point, max_gain, max_out, ulps=300)
    # 0, -0 and NaN never clip
    assert np.isneginf(thr[[0, 1, -1]]).all()


def _in_domain(in_amp, suffix_max, amp0, c, set_point, max_out):
    """The threshold walk's domain, decided once a row (the kernel's
    `agc_params_in_domain` and per-row test)."""
    def state_ok(v):
        return ~(v < 0) & (_bits(v) != 0x80000000)

    plus = all(_bits(F32(v)) <= INF_BITS for v in c)
    return (plus and 0 < set_point <= FMAX and max_out >= 0
            and bool(state_ok(np.asarray(amp0, F32)))
            and not (in_amp < 0).any() and bool(state_ok(suffix_max).all()))


def agc_model(in_amp, suffix_max, amp0, one_m_atk, atk, one_m_dcy, dcy,
              set_point, max_gain, max_out):
    """Numpy model of the kernel: per row, the threshold walk where the
    row is in its domain, else the general walk (the plain step).
    Returns (gain (rows, n), amp (rows,))."""
    c1a, atk, c1d, dcy = (F32(v) for v in (one_m_atk, atk, one_m_dcy, dcy))
    sp, mg, mo = F32(set_point), F32(max_gain), F32(max_out)
    gains = np.empty_like(in_amp)
    amps = np.empty(in_amp.shape[0], F32)
    for r in range(in_amp.shape[0]):
        ia, sm, amp = in_amp[r], suffix_max[r], F32(amp0[r])
        with np.errstate(all="ignore"):
            if _in_domain(ia, sm, amp, (c1a, atk, c1d, dcy), sp, mo):
                # off the chain: the products, the silent coefficients,
                # the thresholds
                live = ia != 0
                pa = (ia * atk).astype(F32)
                pd = np.where(live, (ia * dcy).astype(F32), F32(0))
                cd = np.where(live, c1d, F32(1)).astype(F32)
                thr = agc_clip_threshold(ia, sp, mg, mo)
                rec = np.empty_like(ia)
                for i in range(ia.size):  # the chain: lane 0
                    up = F32(F32(amp * c1a) + pa[i])
                    dn = F32(F32(amp * cd[i]) + pd[i])
                    a = up if ia[i] > amp else dn
                    amp = sm[i] if a < thr[i] else a
                    rec[i] = amp
                # behind the chain: the gains from the recorded averages
                gains[r] = np.where(live, _min_nan((sp / rec).astype(F32),
                                                   mg), F32(1))
            else:
                for i in range(ia.size):
                    up = F32(F32(amp * c1a) + F32(ia[i] * atk))
                    dn = F32(F32(amp * c1d) + F32(ia[i] * dcy))
                    a = up if ia[i] > amp else dn
                    a = a if ia[i] != 0 else amp
                    g = _min_nan(F32(sp / a), mg) if ia[i] != 0 else F32(1)
                    if F32(ia[i] * g) > mo:
                        a = sm[i]
                        g = _min_nan(F32(sp / a), mg)
                    amp = a
                    gains[r, i] = g
        amps[r] = amp
    return gains, amps


def _agc_rows(rng, rows, n, cplx=False):
    x = 1e-3 * rng.standard_normal((rows, n))
    if cplx:
        x = x + 1e-3j * rng.standard_normal((rows, n))
    x[:, :4] = 0.0
    x[:, n // 2:n // 2 + 3] *= 3e4
    x = torch.as_tensor(x.astype(np.complex64 if cplx else np.float32))
    in_amp = x.abs().float().contiguous()
    return in_amp, in_amp.flip(-1).cummax(-1).values.flip(-1).contiguous()


_ATK, _DCY = F32(50.0 / 15000.0), F32(5.0 / 15000.0)
AGC_COEF = (float(F32(1) - _ATK), float(_ATK), float(F32(1) - _DCY),
            float(_DCY), 1.0, 1e7, 10.0)


@pytest.mark.parametrize("case", [
    "receiver 4800", "receiver 3000", "receiver 600", "complex rows",
    "average 1e-3", "average -0.0", "a negative |x|", "other coefficients",
    "max_out 0", "max_gain NaN"])
def test_agc_model_is_the_plain_loop(case):
    rng = np.random.default_rng(11)
    rows, n = {"complex rows": (3, 1200)}.get(case, (1, 4800))
    if case.startswith("receiver"):
        n = int(case.split()[1])
    in_amp, smax = _agc_rows(rng, rows, n, cplx=case == "complex rows")
    amp0 = torch.zeros(rows)
    coef = list(AGC_COEF)
    if case == "average 1e-3":
        amp0 = torch.full((rows,), 1e-3)
    elif case == "average -0.0":
        amp0 = torch.full((rows,), -0.0)
    elif case == "a negative |x|":
        in_amp[0, n // 3] = -1e-4
    elif case == "other coefficients":
        at, dc = F32(0.37), F32(0.021)
        coef = [float(F32(1) - at), float(at), float(F32(1) - dc), float(dc),
                0.7, 300.0, 2.0]
    elif case == "max_out 0":
        coef[6] = 0.0
    elif case == "max_gain NaN":
        coef[5] = float("nan")
    want = loops.agc_scan_ref(in_amp, smax, amp0, *coef)
    got = agc_model(in_amp.numpy(), smax.numpy(), amp0.numpy(), *coef)
    assert _same(got[0], want[0].numpy())
    assert _same(got[1], want[1].numpy())
    if case in ("receiver 4800", "complex rows", "average 1e-3"):
        # the look-ahead fired: the gain falls by half or more at a step
        g = want[0]
        assert int((g[:, 1:] < 0.5 * g[:, :-1]).sum()) >= rows


# -- mm_scan -------------------------------------------------------------

K_WIN, K_OUT, K_BATCH_MIN = 2048, 1024, 4  # the kernel's kWin, kOut, kBatchMin


def _f2i_rd(v) -> int:
    """cvt.rmi.s32.f32: floor, NaN to 0, saturating."""
    if np.isnan(v):
        return 0
    return int(min(max(np.floor(np.float64(v)), -2.0 ** 31), 2.0 ** 31 - 1))


def _clip(v, lo, hi):
    """max.NaN then min.NaN: a NaN goes through."""
    if np.isnan(v):
        return v
    return min(max(v, lo), hi)


def _sgn(v):
    return F32(1) if v > 0 else F32(-1)


def _tree(p: np.ndarray):
    """`_tree_sum` / the kernel's `tree`: neighbours first."""
    p = p.astype(F32)
    while p.size > 1:
        p = (p[0::2] + p[1::2]).astype(F32)
    return p[0]


class _MmRow:
    """One row of the kernel's walk: the carry, the batch rule and the
    step, in float32 scalars."""

    def __init__(self, ext, bank, n, n_out, offset, fstate, cstate, fmin,
                 fmax, omega_gain, mu_gain):
        self.cplx = np.iscomplexobj(ext)
        self.ext, self.n, self.n_out = ext, n, n_out
        self.P, self.T = bank.shape
        self.Tp = next(w for w in (8, 16, 32) if w >= self.T)
        self.bank = np.zeros((self.P, self.Tp), F32)
        self.bank[:, :self.T] = bank
        self.fmin, self.fmax = F32(fmin), F32(fmax)
        self.og, self.mu = F32(omega_gain), F32(mu_gain)
        self.offset = int(offset)
        self.phase, self.freq, self.last = (F32(v) for v in fstate)
        self.p1, self.p2, self.c1, self.c2 = (np.complex64(v) for v in cstate)
        mu = abs(self.mu)
        reach = F32(F32(F32(1) + self.fmax) + mu)
        self.dmax = (_f2i_rd(reach) if self.fmin >= mu and self.fmax >= mu
                     and reach < F32(2 ** 20) else 0)
        span = (float(self.fmax) + abs(float(self.mu)) + 3.0) * self.P
        self.pow2 = self.P & (self.P - 1) == 0 and span < 2 ** 30
        self.fast_steps = 0

    def row(self, phase) -> int:
        ph = _f2i_rd(F32(phase * F32(self.P)))
        return min(max(ph, 0), self.P - 1)

    def taps(self, win, at, tap):
        w = win[at:at + self.Tp]
        if self.cplx:
            return np.complex64(complex(_tree(w.real * tap),
                                        _tree(w.imag * tap)))
        return _tree(w * tap)

    def loop(self, err):
        """clip, freq, nphase; the offset and phase advanced: returns
        (nphase, the offset's step)."""
        with np.errstate(all="ignore"):
            err = _clip(err, F32(-1), F32(1))
            self.freq = _clip(F32(self.freq + F32(self.og * err)),
                              self.fmin, self.fmax)
            nphase = F32(F32(self.phase + self.freq) + F32(self.mu * err))
            d = _f2i_rd(nphase)
            self.offset += d
            self.phase = F32(nphase - np.floor(nphase))
        return nphase, d

    def steps(self, win, rel, k, pow2):
        """`mm_step` k times from the window position ``rel``: the row of
        the first from the phase, of each next from the step before it
        (``pow2``: from nphase, as a batch at a power-of-two P does), the
        error's p1 product formed for both signs."""
        outs = []
        at, ph = rel, self.row(self.phase)
        one = F32(1)
        for _ in range(k):
            with np.errstate(all="ignore"):
                if self.cplx:
                    p1, c2 = self.p1, self.c2
                    bp = (F32(F32(one - c2.real) * p1.real),
                          F32(F32(one - c2.imag) * p1.imag))
                    bn = (F32(F32(-one - c2.real) * p1.real),
                          F32(F32(-one - c2.imag) * p1.imag))
                    out = self.taps(win, at, self.bank[ph])
                    sr, si = out.real > 0, out.imag > 0
                    a = F32(F32(F32(out.real - self.p2.real) * self.c1.real)
                            + F32(F32(out.imag - self.p2.imag)
                                  * self.c1.imag))
                    err = F32(a - F32((bp[0] if sr else bn[0])
                                      + (bp[1] if si else bn[1])))
                    self.p2, self.p1, self.c2 = self.p1, out, self.c1
                    self.c1 = np.complex64(complex(one if sr else -one,
                                                   one if si else -one))
                else:
                    lp, ln = F32(self.last * one), F32(self.last * -one)
                    out = self.taps(win, at, self.bank[ph])
                    err = F32(F32(_sgn(self.last) * out)
                              - (lp if out > 0 else ln))
                    self.last = out
            nphase, d = self.loop(err)
            at += d
            if pow2:
                ph = _f2i_rd(F32(nphase * F32(self.P))) - d * self.P
            else:
                ph = self.row(self.phase)
            outs.append(out)
        return outs

    def walk(self):
        L = self.ext.size
        syms, stored, done = [], 0, self.n_out == 0
        while not done:
            base = min(max(self.offset, 0), L - self.T)
            win = np.zeros(K_WIN, self.ext.dtype)
            part = self.ext[base:base + K_WIN]
            win[:part.size] = part
            produced = 0
            while True:
                if stored + produced == self.n_out or self.offset >= self.n:
                    done = True
                    break
                rel = min(max(self.offset, 0), L - self.T) - base
                if rel < 0 or rel + self.Tp > K_WIN or produced == K_OUT:
                    break
                if (self.dmax > 0 and self.offset >= 0
                        and 0 <= self.phase <= 1):
                    k = min(K_OUT - produced, self.n_out - stored - produced,
                            (K_WIN - self.Tp - rel) // self.dmax + 1,
                            (self.n - 1 - self.offset) // self.dmax + 1)
                    if k >= K_BATCH_MIN:
                        syms += self.steps(win, rel, k, self.pow2)
                        self.fast_steps += k
                        produced += k
                        continue
                syms += self.steps(win, rel, 1, False)
                produced += 1
            stored += produced
        return syms


def mm_model(ext, bank, n, n_out, offset0, fstate0, cstate0, fmin, fmax,
             omega_gain, mu_gain):
    """Numpy model of the kernel, `mm_scan_ref`'s arguments and results
    (numpy); also the symbols the batches walked."""
    rows = ext.shape[0]
    syms = np.zeros((rows, n_out), ext.dtype)
    valid = np.zeros((rows, n_out), bool)
    offset = np.zeros(rows, np.int32)
    fstate = np.zeros((rows, 3), F32)
    cstate = np.zeros((rows, 4), np.complex64)
    fast = 0
    for r in range(rows):
        w = _MmRow(ext[r], bank, n, n_out, offset0[r], fstate0[r],
                   cstate0[r], fmin, fmax, omega_gain, mu_gain)
        s = w.walk()
        syms[r, :len(s)] = s
        valid[r, :len(s)] = True
        offset[r] = w.offset
        fstate[r] = (w.phase, w.freq, w.last)
        cstate[r] = (w.p1, w.p2, w.c1, w.c2)
        fast += w.fast_steps
    return (syms, valid, offset, fstate, cstate), fast


def _qpsk(rng, nsym, sps=25.0 / 12.0):
    """QPSK at ``sps`` samples a symbol (nearest-sample hold), noisy."""
    n = int(nsym * sps)
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    x = sym[np.minimum((np.arange(n) / sps).astype(int), nsym - 1)]
    return x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


def _bpsk(rng, nsym, sps):
    n = int(nsym * sps)
    sym = rng.choice([-1.0, 1.0], nsym)
    x = sym[np.minimum((np.arange(n) / sps).astype(int), nsym - 1)]
    return x + 0.1 * rng.standard_normal(n)


@pytest.mark.parametrize("case", [
    "complex 8x128", "float 8x128", "complex 16x256", "float 16x256",
    "complex 32x128", "float 32x1600", "complex 12x300", "complex 8x1024",
    "rows", "n_out inside a window", "omega 150", "omega 700", "mu 0.9",
    "mu past fmin", "loose loop"])
def test_mm_model_is_the_plain_loop(case):
    """Two blocks a case (the second from the first's carry): the
    model's symbols, mask and carries equal `mm_scan_ref`'s to the bit,
    and the batches walked at least 80 % of the symbols where the loop
    bounds allow them."""
    rng = np.random.default_rng(21)
    spec = {"complex 8x128": (True, 8, 128), "float 8x128": (False, 8, 128),
            "complex 16x256": (True, 16, 256),
            "float 16x256": (False, 16, 256),
            "complex 32x128": (True, 32, 128),
            "float 32x1600": (False, 32, 1600),
            "complex 12x300": (True, 12, 300),
            "complex 8x1024": (True, 8, 1024)}.get(case, (True, 8, 128))
    cplx, taps, phases = spec
    omega = 25.0 / 12.0 if cplx else 5000.0 / 1187.5
    mu, og, rel, rows, n = 0.01, 1e-6, 0.01, 1, 3000
    if case == "rows":
        rows = 3
    if case in ("omega 150", "omega 700"):
        cplx, omega, n = False, float(case.split()[1]), 12000
    if case == "mu 0.9":
        mu = 0.9
    if case == "mu past fmin":
        mu = 3.0
    if case == "loose loop":
        og, mu, rel, phases = 1e-2, 0.2, 0.3, 64
    mm = clock.MuellerMuller(omega, og, mu, rel, complex_mode=cplx,
                             interp_phase_count=phases,
                             interp_tap_count=taps, device="cpu")
    nsym = int(n / omega) + 2
    x = np.stack([(_qpsk(rng, nsym, omega) if cplx
                   else _bpsk(rng, nsym, omega))[:n] for _ in range(rows)])
    x = torch.as_tensor(x.astype(np.complex64 if cplx else np.float32))
    st = {k: v.expand((rows,) + tuple(v.shape)) for k, v in
          mm.init_state().items()}
    fast = valid = 0
    for blk in (x[:, :n // 3], x[:, n // 3:]):
        m = blk.shape[-1]
        ext = torch.cat([st["tail"], blk], -1).contiguous()
        n_out = 300 if case == "n_out inside a window" else mm.max_out(m)
        args = (ext, mm._bank, m, n_out, st["offset"].reshape(rows),
                torch.stack([st["phase"], st["freq"], st["last_out"]], 1),
                torch.stack([st[k] for k in ("p1", "p2", "c1", "c2")], 1),
                float(F32(omega * (1 - rel))), float(F32(omega * (1 + rel))),
                float(F32(og)), float(F32(mu)))
        want = clock.mm_scan_ref(*args)
        got, f = mm_model(*(a.numpy() if torch.is_tensor(a) else a
                            for a in args))
        fast += f
        valid += int(want[1].sum())
        for g, w in zip(got, want):
            assert _same(g, w.numpy()) if g.dtype.kind in "fc" else \
                np.array_equal(g, w.numpy())
        st = {"tail": ext[:, m:], "offset": want[2] - m,
              "phase": want[3][:, 0], "freq": want[3][:, 1],
              "last_out": want[3][:, 2], "p1": want[4][:, 0],
              "p2": want[4][:, 1], "c1": want[4][:, 2], "c2": want[4][:, 3]}
    if case in ("mu past fmin", "omega 700"):
        # min(fmin, fmax) < |mu|; a window of fewer than kBatchMin
        # symbols at dmax = 708: checked steps only
        assert fast == 0
    elif case == "n_out inside a window":
        # the second block starts ~375 samples back (the first stopped at
        # its 300th slot), where the offset is negative: checked steps
        assert fast >= 300
    else:
        assert fast >= 0.8 * valid
