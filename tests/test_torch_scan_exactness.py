"""The identities the redesigned scan kernels rest on, checked on the CPU.

`costas_scan` (``csrc/sync_loops.cu``) wraps its phase by the division
only from `loops.COSTAS_WRAP_FAST` on; below it the wrap
``v - 2pi * round(v / 2pi)`` is ``v + 0``.  The threshold is checked
exhaustively in float32 over every value from 3.0 to 3.5 and from -3.5
to -3.0, and over +-0 and the subnormals: below T the two agree to the
bit, at T and above the quotient no longer rounds to zero.

`viterbi_decode` (``csrc/viterbi.cu``) takes the maximum over the states
as the maximum of int32 keys, a float's bits with the magnitude flipped
where it is negative; a numpy model of that map must give back
`np.max`'s bits and `np.argmax`'s first index.

Below `loops.COSTAS_WRAP_TURN` the quotient rounds to at most one turn,
and the kernel's branch-free wrap (two compares, no division) is the
division's to the bit there: checked over every float32 around both
thresholds.

Numpy/PyTorch models of the kernels, run on the CPU, are held to the
bit against the plain versions (`costas_scan_ref`, `viterbi_decode_ref`):
the Costas step with either wrap, the select-for-sign error and the
NaN-propagating clip, on inputs whose phase crosses +-pi often, with a
NaN sample and from a phase of -0.0; the Viterbi step with the
predecessors' metrics fetched per lane and half as the kernel's shuffles
fetch them, normalised after the fetch, at K = 3, 5 and 7 and R = 2, 3
and 4; and the Viterbi's traceback in 32 chunks from guessed starts,
checked chunk against chunk, against the serial traceback, with
warm-ups too short to guess right and on random decisions.

No tolerance anywhere: every comparison is of bits (a NaN equal to a
NaN).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.fec import viterbi as tv  # noqa: E402
from sdrtpu_torch.kernels import loops  # noqa: E402

F32 = np.float32
TWO_PI = F32(loops._TWO_PI)
T = F32(loops.COSTAS_WRAP_FAST)
TURN = F32(loops.COSTAS_WRAP_TURN)


def _floats(lo: float, hi: float) -> np.ndarray:
    """Every float32 from lo to hi (both of one sign), in order."""
    a, b = (np.array([lo, hi], F32).view(np.uint32)).tolist()
    a, b = min(a, b), max(a, b)
    return np.arange(a, b + 1, dtype=np.uint32).view(F32)


def _bits(x) -> np.ndarray:
    x = np.asarray(x, F32)
    return np.where(np.isnan(x), np.uint32(0x7FC00000), x.view(np.uint32))


def _full_wrap(v: np.ndarray) -> np.ndarray:
    """The kernel's `wrap_pi` (and `loops._wrap_pi`): one IEEE float32
    division, rint half to even, a product and a difference."""
    return (v - TWO_PI * np.rint(v / TWO_PI)).astype(F32)


def _fast_wrap(v: np.ndarray) -> np.ndarray:
    """The kernel's `wrap_pi_fast`."""
    return np.where(np.abs(v) < T, (v + F32(0)).astype(F32), _full_wrap(v))


def _turn_wrap(v: np.ndarray) -> np.ndarray:
    """The kernel's `wrap_pi_turn` (for |v| < TURN): v - 2pi * sign(v)
    from |v| >= T, else v - (-0)."""
    turn = np.copysign(TWO_PI, v).astype(F32)
    return (v - np.where(np.abs(v) >= T, turn, F32(-0.0))).astype(F32)


@pytest.mark.parametrize("where", ["3.0..3.5", "-3.5..-3.0",
                                   "zeros and subnormals"])
def test_wrap_threshold_is_exact(where):
    if where == "3.0..3.5":
        v = _floats(3.0, 3.5)
    elif where == "-3.5..-3.0":
        v = _floats(-3.5, -3.0)
    else:
        tiny = np.finfo(F32).tiny
        sub = _floats(0.0, np.nextafter(tiny, F32(0)))
        v = np.concatenate([sub, -sub])  # +-0 and every subnormal
    with np.errstate(invalid="ignore"):
        quotient = np.rint(v / TWO_PI)
    below = np.abs(v) < T
    # below T every quotient rounds to +-0, with the sign of v ...
    assert np.all(quotient[below] == 0)
    assert np.array_equal(np.signbit(quotient[below]), np.signbit(v[below]))
    # ... and the fast path is the full wrap to the bit (+0 from -0)
    assert np.array_equal(_bits(_fast_wrap(v)), _bits(_full_wrap(v)))
    assert np.array_equal(_bits((v[below] + F32(0)).astype(F32)),
                          _bits(_full_wrap(v[below])))
    # from T on no quotient rounds to zero: T is the largest threshold
    assert np.all(quotient[~below] != 0)
    if where != "zeros and subnormals":
        assert below.any() and (~below).any()


@pytest.mark.parametrize("where", ["3.0..3.5", "9.0..9.5", "-9.5..-9.0",
                                   "-3.5..-3.0", "zeros and subnormals"])
def test_one_turn_wrap_is_exact(where):
    """Below COSTAS_WRAP_TURN the quotient rounds to -1, +-0 or 1 and
    the branch-free wrap is the division's to the bit; at it the
    quotient rounds to 2."""
    if where == "zeros and subnormals":
        sub = _floats(0.0, np.nextafter(np.finfo(F32).tiny, F32(0)))
        v = np.concatenate([sub, -sub])
    else:
        lo, hi = (float(b) for b in where.replace("..", " ").split())
        v = _floats(lo, hi)
    quotient = np.rint(v / TWO_PI)
    inside = np.abs(v) < TURN
    assert np.all(np.abs(quotient[inside]) <= 1)
    assert np.all(np.abs(quotient[~inside]) >= 2)
    assert np.array_equal(_bits(_turn_wrap(v[inside])),
                          _bits(_full_wrap(v[inside])))
    if "9." in where:
        assert inside.any() and (~inside).any()
    # what it leaves stays within pi: a row that starts there stays there
    assert np.all(np.abs(_turn_wrap(v[inside])) <= F32(np.pi))


def test_wrap_threshold_neighbours():
    """T is float32(pi)'s successor; float32(pi) takes the fast path, T
    and its successor the full one, and both wrap by one turn."""
    pi = F32(np.pi)
    assert T == np.nextafter(pi, F32(np.inf))
    for v in (pi, -pi):
        assert abs(v) < T and np.rint(v / TWO_PI) == 0
    for v in (T, np.nextafter(T, F32(np.inf)), -T):
        assert not abs(v) < T
        assert abs(np.rint(v / TWO_PI)) == 1
        assert _bits(_fast_wrap(np.array([v]))) == _bits(_full_wrap(
            np.array([v])))


# -- the int32 key of the maximum ----------------------------------------

def _key(f: np.ndarray) -> np.ndarray:
    """The kernel's `key_of`: i ^ ((i >> 31) & 0x7fffffff), int32."""
    i = np.asarray(f, F32).view(np.int32)
    return i ^ ((i >> 31) & np.int32(0x7FFFFFFF))


def _float_of(k: np.ndarray) -> np.ndarray:
    """The kernel's `float_of`, the same map back."""
    k = np.asarray(k, np.int32)
    return (k ^ ((k >> 31) & np.int32(0x7FFFFFFF))).view(F32)


def _vectors(case: str, rng) -> list[np.ndarray]:
    out = []
    for _ in range(200):
        n = int(rng.integers(2, 65))
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 9)).astype(F32)
        if case == "specials":
            k = rng.integers(0, n, 3)
            v[k] = rng.choice(np.array([-1e9, -np.inf, -1e9, -0.0, 0.0,
                                        1e-40, -1e-40, 1e-45], F32), 3)
        elif case == "ties":
            v[rng.integers(0, n, n // 2)] = v.max()
        elif case == "metrics":  # as the decoder's: <= 0, -1e9 for unreached
            v = -np.abs(v)
            v[rng.random(n) < 0.5] = F32(-1e9)
            v[rng.integers(0, n)] = F32(0.0)
        elif case == "absent":
            v[rng.integers(0, n, 3)] = -np.inf
        out.append(v)
    return out


@pytest.mark.parametrize("case", ["normal", "specials", "ties", "metrics",
                                  "absent"])
def test_key_gives_the_maximum_and_the_first_argmax(case):
    rng = np.random.default_rng(["normal", "specials", "ties", "metrics",
                                 "absent"].index(case))
    for v in _vectors(case, rng):
        k = _key(v)
        assert np.array_equal(_float_of(k).view(np.uint32),
                              v.view(np.uint32))  # its own inverse
        # the key orders as the floats do
        order = np.argsort(v, kind="stable")
        assert (np.all(np.diff(k[order].astype(np.int64)) >= 0)
                or (v == 0).any())
        best = _float_of(k.max())
        want = v.max()
        if want == 0 and (v == 0).any() and not (
                np.signbit(v[v == 0]).all()):
            want = F32(0.0)  # the key ranks -0 below +0
        assert best.view(np.uint32) == F32(want).view(np.uint32)
        if not (v.max() == 0 and np.signbit(v[v == 0]).any()):
            # the first state holding the largest key is np.argmax's
            assert int(np.flatnonzero(k == k.max())[0]) == int(np.argmax(v))


def test_key_ranks_minus_zero_below_plus_zero():
    """The one place the key and float comparison differ; the decoder's
    metrics are never -0 (they start at +0 and -1e9, and x - y is -0
    only for x = -0), so it never decides there."""
    v = np.array([-1.0, -0.0, 0.0, -0.0], F32)
    k = _key(v)
    assert _float_of(k.max()).view(np.uint32) == 0
    assert int(np.flatnonzero(k == k.max())[0]) == 2
    assert k[1] < k[2]


# -- the kernels' steps, modelled on the CPU ---------------------------------

def _costas_model(x, phase0, freq0, alpha, beta, fmin, fmax, mode, walk):
    """`costas_scan` as the kernel computes a step: one sine and cosine,
    sign(a) * b as a select of +-b, the clip as max then min letting a
    NaN through; the wrap, on the ``"general"`` walk, by the division only
    from T on, and on the ``"bounded"`` walk from two compares."""
    phase = torch.tensor([phase0], dtype=torch.float32)
    freq = torch.tensor([freq0], dtype=torch.float32)
    f = torch.tensor
    ys = []

    def clip(v, lo, hi):
        v = torch.where(torch.isnan(v) | (v > lo), v, f(lo))
        return torch.where(torch.isnan(v) | (v < hi), v, f(hi))

    def sgn_mul(t, v):
        return torch.where(t > 0, v, -v)

    def wrap(v):
        if walk == "bounded":
            assert v.abs().item() < float(TURN) or torch.isnan(v).item()
            turn = torch.copysign(torch.tensor(loops._TWO_PI), v)
            return v - torch.where(v.abs() >= float(T), turn, f(-0.0))
        full = v - loops._TWO_PI * torch.round(v / loops._TWO_PI)
        return torch.where(v.abs() < float(T), v + 0.0, full)

    for xi in torch.as_tensor(x):
        neg = -phase
        c, s = torch.cos(neg), torch.sin(neg)
        re = xi.real * c - xi.imag * s
        im = xi.real * s + xi.imag * c
        if mode == loops.COSTAS_ORDER2:
            e = re * im
        elif mode == loops.COSTAS_ORDER4:
            e = sgn_mul(re, im) - sgn_mul(im, re)
        else:
            a, b = sgn_mul(re, im), sgn_mul(im, re)
            e = torch.where(re.abs() >= im.abs(), a - b * loops._K8,
                            a * loops._K8 - b)
        err = clip(e, -1.0, 1.0)
        freq = clip(freq + beta * err, fmin, fmax)
        phase = wrap(phase + freq + alpha * err)
        ys.append(torch.complex(re, im))
    return torch.cat(ys), phase, freq


def _same(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32))


@pytest.mark.parametrize("walk", ["general", "bounded"])
@pytest.mark.parametrize("case", ["order2", "order4", "order8",
                                  "wrap-heavy", "nan", "phase -0"])
def test_costas_step_model_is_the_plain_loop(case, walk):
    rng = np.random.default_rng(11)
    n = 1500
    mode = {"order2": loops.COSTAS_ORDER2,
            "order8": loops.COSTAS_ORDER8}.get(case, loops.COSTAS_ORDER4)
    order = {loops.COSTAS_ORDER2: 2, loops.COSTAS_ORDER8: 8}.get(mode, 4)
    # wrap-heavy: a carrier 1/50 of the rate, so the phase crosses +-pi
    # every 50 steps and the division runs on each crossing
    cfo = 2 * np.pi / 50 if case == "wrap-heavy" else 0.004
    x = np.exp(2j * np.pi * rng.integers(0, order, n) / order
               + 1j * (cfo * np.arange(n) + 0.3))
    x = (x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    phase0, freq0 = 0.2, (cfo if case == "wrap-heavy" else 0.0)
    if case == "nan":
        x[n // 2] = np.nan
    if case == "phase -0":
        x[:16] = 0
        phase0 = -0.0
    alpha, beta = (float(F32(v)) for v in loops.critically_damped(0.005))
    fmin, fmax = float(F32(-np.pi)), float(F32(np.pi))
    want = loops.costas_scan_ref(
        torch.as_tensor(x)[None], torch.tensor([phase0]),
        torch.tensor([freq0]), alpha, beta, fmin, fmax, mode)
    got = _costas_model(x, phase0, freq0, alpha, beta, fmin, fmax, mode,
                        walk)
    assert _same(got[0], want[0][0])
    assert _same(got[1], want[1]) and _same(got[2], want[2])
    if case == "wrap-heavy":
        ph = np.angle(want[0][0].numpy())  # the phase did go round
        assert np.count_nonzero(np.abs(np.diff(ph)) > np.pi) > 10


def _viterbi_model(sym: np.ndarray, exp_prev: np.ndarray, K: int):
    """`viterbi_decode`'s add-compare-select as the kernel's warp runs
    it: lane l holds states l and l + 32, the predecessors' unnormalised
    metrics come from lanes p0 % 32 and (p0 | 1) % 32 of half p0 // 32,
    the maximum through the int32 key, the subtract after the fetch.
    Returns the decisions (n, S) and the final metrics (S,)."""
    n, R = sym.shape
    S = 1 << (K - 1)
    H = 2 if S == 64 else 1
    lanes = np.arange(32)
    has = np.ones(32, bool) if H == 2 else lanes < S
    p0 = (lanes << 1) & (S - 1)
    src0, src1 = p0 & 31, (p0 | 1) & 31
    upper = p0 >= 32
    nm = np.full((H, 32), F32(-1e9))
    nm[0, 0] = 0.0
    mx = F32(0.0)
    choices = np.zeros((n, S), bool)
    for i in range(n):
        q0 = np.where(upper, nm[H - 1][src0], nm[0][src0])
        q1 = np.where(upper, nm[H - 1][src1], nm[0][src1])
        m0, m1 = (q0 - mx).astype(F32), (q1 - mx).astype(F32)
        keys = []
        for h in range(H):
            s = np.minimum(lanes + 32 * h, S - 1)
            e = exp_prev[s]  # (32, 2, R)
            prod = (sym[i][None, None, :] * e).astype(F32)
            bm = prod[..., 0]
            for r in range(1, R):
                bm = (bm + prod[..., r]).astype(F32)
            c0, c1 = (m0 + bm[:, 0]).astype(F32), (m1 + bm[:, 1]).astype(F32)
            pick = has & (c1 > c0)
            nm[h] = np.where(pick, c1, c0)
            keys.append(np.where(has, _key(nm[h]), np.iinfo(np.int32).min))
            choices[i, (lanes + 32 * h)[has]] = pick[has]
        mx = _float_of(np.max(keys))
    final = np.concatenate([(nm[h] - mx).astype(F32) for h in range(H)])
    return choices, final[:S]


@pytest.mark.parametrize("K", [3, 5, 7])
@pytest.mark.parametrize("R", [2, 3, 4])
def test_viterbi_step_model_is_the_plain_loop(K, R):
    rng = np.random.default_rng(K * 10 + R)
    polys = {2: (0o7, 0o5), 3: (0o5, 0o7, 0o7), 4: (0o5, 0o7, 0o7, 0o5)}[R]
    if K > 3:
        polys = {2: (0o27, 0o31), 3: (0o25, 0o33, 0o37),
                 4: (0o25, 0o27, 0o33, 0o37)}[R] if K == 5 else {
            2: (0o171, 0o133), 3: (0o133, 0o171, 0o145),
            4: (0o133, 0o171, 0o145, 0o133)}[R]
    enc = tv.ConvEncoder(K, polys)
    dec = tv.ViterbiDecoder(K, polys, device="cpu")
    n = 300
    soft = enc.encode_to_soft(rng.integers(0, 2, n))
    soft = (soft + 0.8 * rng.standard_normal(soft.shape)).astype(F32)
    sym = soft.reshape(n, R)
    choices, final = _viterbi_model(sym, np.asarray(dec.exp_prev, F32), K)
    bits, metrics = tv.viterbi_decode_ref(torch.as_tensor(sym)[None],
                                          dec.exp_prev, dec.prev,
                                          dec.prev_bit)
    assert np.array_equal(final.view(np.uint32),
                          metrics[0].numpy().view(np.uint32))
    # the traceback over the model's decisions gives the plain bits
    state = int(np.flatnonzero(_key(final) == _key(final).max())[0])
    got = np.empty(n, np.uint8)
    for i in range(n - 1, -1, -1):
        got[i] = state >> (K - 2)
        state = ((state << 1) | int(choices[i, state])) & ((1 << (K - 1)) - 1)
    assert np.array_equal(got, bits[0].numpy())


def _walk_back(choices, top, bottom, state, K, emit=None):
    """The kernel's `walk_back`: from ``state`` at step ``top`` down to
    ``bottom``; returns the state at step bottom - 1."""
    for i in range(top, bottom - 1, -1):
        if emit is not None:
            emit[i] = state >> (K - 2)
        state = ((state << 1) | int(choices[i, state])) & ((1 << (K - 1)) - 1)
    return state


def _chunked_traceback(choices, best, K, warmup):
    """The kernel's traceback: 32 chunks walked at once from guessed
    starts ``warmup`` steps above each, then each start held against the
    state the chunk above left, newest first, and walked again where it
    differs.  Returns the bits and how many chunks were walked again."""
    n = len(choices)
    L = -(-n // 32)
    top_lane = (n - 1) // L
    bits = np.full(n, 255, np.uint8)
    start, below = [0] * 32, [0] * 32
    for lane in range(top_lane + 1):
        lo, hi = lane * L, min(lane * L + L, n)
        s = best
        if lane != top_lane:
            frm = hi - 1 + warmup
            s = (_walk_back(choices, frm, hi, 0, K) if frm < n - 1
                 else _walk_back(choices, n - 1, hi, best, K))
        start[lane] = s
        below[lane] = _walk_back(choices, hi - 1, lo, s, K, bits)
    again = 0
    for lane in range(top_lane - 1, -1, -1):
        if start[lane] != below[lane + 1]:
            lo, hi = lane * L, min(lane * L + L, n)
            below[lane] = _walk_back(choices, hi - 1, lo, below[lane + 1], K,
                                     bits)
            again += 1
    return bits, again


@pytest.mark.parametrize("n", [1, 31, 33, 300, 2000])
@pytest.mark.parametrize("warmup", [0, 8, 512])
def test_chunked_traceback_is_the_serial_one(n, warmup):
    """On decisions of a real decode (paths merge) and on random
    decisions (they need not), with warm-ups too short for the starts to
    be right: the bits are always the serial traceback's."""
    K = 7
    rng = np.random.default_rng(n + warmup)
    enc = tv.ConvEncoder(K, (0o171, 0o133))
    dec = tv.ViterbiDecoder(K, (0o171, 0o133), device="cpu")
    soft = enc.encode_to_soft(rng.integers(0, 2, n))
    soft = (soft + 0.8 * rng.standard_normal(soft.shape)).astype(F32)
    decoded, _ = _viterbi_model(soft.reshape(n, 2),
                                np.asarray(dec.exp_prev, F32), K)
    for choices in (decoded, rng.random((n, 64)) < 0.5):
        best = int(rng.integers(0, 64))
        want = np.empty(n, np.uint8)
        _walk_back(choices, n - 1, 0, best, K, want)
        got, again = _chunked_traceback(choices, best, K, warmup)
        assert np.array_equal(got, want)
        assert again <= 31
