"""Plain CCSDS concatenated code of the Meteor-M2 LRPT downlink, in NumPy
and Python integers: the capture's encoder and the reference's decoder.

- Reed-Solomon RS(255,223) over GF(2^8) with the field polynomial
  0x187 and the code roots ``alpha^(11 (112 + i))`` for i < 32: CCSDS
  131.0-B's generator ``prod (x - alpha^(11 j))``, j = 112 .. 143, as
  libcorrect builds it from its first root 112 and root gap 11
  (``exp[(gap * (i + first)) % 255]``), with the bytes in the
  conventional basis, as libcorrect takes them (it has no dual-basis
  step); interleaved at depth 4: byte ``j`` of the 892-byte CVCDU goes to
  codeword ``j % 4``; each codeword is its 223 data bytes then its 32
  parity bytes (the highest power first), the 1020-byte codeblock byte
  ``4 r + i`` being byte ``r`` of codeword ``i``;
- the codeblock padded with 4 zero bytes to 1024 and XORed with the
  CCSDS pseudo-random sequence ``x^8 + x^7 + x^5 + x^3 + 1`` from all
  ones;
- the attached sync marker 0x1ACFFC1D ahead of each 1024-byte frame;
- the rate-1/2 K=7 convolutional code, polynomials 0o171 and 0o133 over
  the current bit and the six before it (newest first), the first
  output first, coded bit 0 sent as +1.

Decoding: a 64-state soft Viterbi over correlation metrics from an
unknown start state (every state at 0), traceback from the best last
state; the ASM search; the derandomizer; RS by syndromes,
Berlekamp-Massey, Chien search and Forney's formula.  Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np

ASM = 0x1ACFFC1D
ASM_BITS = np.array([(ASM >> (31 - i)) & 1 for i in range(32)], np.uint8)
FRAME_BYTES = 1024
FRAME_BITS = 32 + 8 * FRAME_BYTES  # 8224: ASM and frame
CVCDU_BYTES = 892
N, K, NROOTS, DEPTH = 255, 223, 32, 4
FCR, GAP = 112, 11
POLYS = (0o171, 0o133)

# GF(2^8), field polynomial 0x187
EXP = np.zeros(512, np.int64)
LOG = np.zeros(256, np.int64)
_v = 1
for _i in range(255):
    EXP[_i] = _v
    LOG[_v] = _i
    _v <<= 1
    if _v & 0x100:
        _v ^= 0x187
EXP[255:510] = EXP[:255]
# the products of every pair, by table (row a, column b)
MUL = np.zeros((256, 256), np.uint8)
MUL[1:, 1:] = EXP[(LOG[1:, None] + LOG[None, 1:]) % 255]
_MUL = MUL.tolist()
_EXP, _LOG = EXP.tolist(), LOG.tolist()


def gf_mul(a: int, b: int) -> int:
    return _MUL[a][b]


def gf_div(a: int, b: int) -> int:
    return 0 if a == 0 else _EXP[(_LOG[a] - _LOG[b]) % 255]


def alpha_pow(e: int) -> int:
    return _EXP[e % 255]


def root(i: int) -> int:
    """The code's root ``i``: alpha^(GAP (FCR + i))."""
    return alpha_pow(GAP * (FCR + i))


def _generator() -> list[int]:
    """prod (x - root(i)), highest power first."""
    g = [1]
    for i in range(NROOTS):
        r = root(i)
        out = g + [0]
        for j, c in enumerate(g):
            out[j + 1] ^= gf_mul(c, r)
        g = out
    return g


GENERATOR = _generator()


def rs_encode(data: np.ndarray) -> np.ndarray:
    """223 data bytes -> the 255-byte codeword, data first: the parity is
    ``data(x) x^32 mod g(x)``, by long division."""
    rem = np.zeros(N, np.uint8)
    rem[:K] = data
    g = np.array(GENERATOR[1:])
    for i in range(K):
        c = rem[i]
        if c:
            rem[i + 1:i + NROOTS + 1] ^= MUL[c, g]
    return np.concatenate([np.asarray(data, np.uint8), rem[K:]])


def _eval(poly: list[int], x: int) -> int:
    """Horner, highest power first."""
    y = 0
    for c in poly:
        y = gf_mul(y, x) ^ c
    return y


def rs_decode(code: np.ndarray) -> tuple[np.ndarray, int]:
    """255 received bytes -> (223 data bytes, bytes corrected), or the
    received data and -1 where more than 16 bytes are in error (the
    locator's degree and its roots disagree, or a syndrome remains).

    ``code[j]`` is the coefficient of ``x^(254 - j)``.  Syndromes ``S_i
    = c(root(i)) = sum Y X^i`` over the errors, an error ``E`` at power
    ``e`` having locator ``X = alpha^(GAP e)`` and ``Y = E alpha^(GAP
    FCR e)``; Berlekamp-Massey gives ``Lambda(x) = prod (1 - X x)``; the
    Chien search tries every power's ``X^-1``; Forney: ``Y = X
    Omega(X^-1) / Lambda'(X^-1)`` with ``Omega = S Lambda mod x^32``."""
    r = [int(b) for b in code]
    synd = [_eval(r, root(i)) for i in range(NROOTS)]
    if not any(synd):
        return np.asarray(code[:K], np.uint8), 0
    # Berlekamp-Massey, lowest power first
    lam, prev = [1] + [0] * NROOTS, [1] + [0] * NROOTS
    L, m, b = 0, 1, 1
    for n in range(NROOTS):
        d = synd[n]
        for i in range(1, L + 1):
            d ^= gf_mul(lam[i], synd[n - i])
        if d == 0:
            m += 1
            continue
        coef = gf_div(d, b)
        new = lam[:]
        for i in range(NROOTS + 1 - m):
            new[i + m] ^= gf_mul(coef, prev[i])
        if 2 * L <= n:
            L, prev, b, m = n + 1 - L, lam, d, 1
        else:
            m += 1
        lam = new
    if L > NROOTS // 2:
        return np.asarray(code[:K], np.uint8), -1
    lam = lam[:L + 1]
    # Chien search over every power e: Lambda(X^-1) == 0
    found = []
    for e in range(N):
        xinv = alpha_pow(-GAP * e)
        y, p = 0, 1
        for c in lam:
            y ^= gf_mul(c, p)
            p = gf_mul(p, xinv)
        if y == 0:
            found.append(e)
    if len(found) != L:
        return np.asarray(code[:K], np.uint8), -1
    omega = [0] * NROOTS
    for i, li in enumerate(lam):
        for j in range(NROOTS - i):
            omega[i + j] ^= gf_mul(li, synd[j])
    for e in found:
        xinv = alpha_pow(-GAP * e)
        num, p = 0, 1
        for c in omega:
            num ^= gf_mul(c, p)
            p = gf_mul(p, xinv)
        # Lambda'(x): the odd-power terms, each lowered by one
        den, p = 0, 1
        x2 = gf_mul(xinv, xinv)
        for i in range(1, L + 1, 2):
            den ^= gf_mul(lam[i], p)
            p = gf_mul(p, x2)
        if den == 0:
            return np.asarray(code[:K], np.uint8), -1
        mag = gf_mul(gf_div(num, den), alpha_pow(GAP * e * (1 - FCR)))
        r[N - 1 - e] ^= mag
    if any(_eval(r, root(i)) for i in range(NROOTS)):
        return np.asarray(code[:K], np.uint8), -1
    return np.array(r[:K], np.uint8), len(found)


def randomizer(n: int = FRAME_BYTES) -> np.ndarray:
    """The CCSDS pseudo-random bytes, x^8 + x^7 + x^5 + x^3 + 1 from all
    ones, most significant bit first (``ff 48 0e c0 9a ...``)."""
    reg, out = [1] * 8, []
    for _ in range(8 * n):
        out.append(reg[0])
        fb = reg[0] ^ reg[3] ^ reg[5] ^ reg[7]
        reg = reg[1:] + [fb]
    return np.packbits(np.array(out, np.uint8))


RAND = randomizer()


def frame_bits(cvcdu: np.ndarray) -> np.ndarray:
    """One 892-byte CVCDU -> its 8224 channel bits before the
    convolutional code: the ASM, then the randomized 1024-byte frame."""
    d = np.asarray(cvcdu, np.uint8).reshape(K, DEPTH)
    block = np.stack([rs_encode(d[:, i]) for i in range(DEPTH)], axis=1)
    frame = np.zeros(FRAME_BYTES, np.uint8)
    frame[:N * DEPTH] = block.reshape(-1)
    return np.concatenate([ASM_BITS, np.unpackbits(frame ^ RAND)])


def deframe_bytes(bits: np.ndarray) -> tuple[np.ndarray | None, list[int]]:
    """The 8192 bits after an ASM -> (CVCDU or None, each codeword's
    corrections, -1 where it failed)."""
    frame = np.packbits(bits) ^ RAND
    block = frame[:N * DEPTH].reshape(N, DEPTH)
    out = np.empty((K, DEPTH), np.uint8)
    nerr = []
    for i in range(DEPTH):
        data, n = rs_decode(block[:, i])
        out[:, i] = data
        nerr.append(n)
    return (None if min(nerr) < 0 else out.reshape(-1)), nerr


def _parity(v: np.ndarray) -> np.ndarray:
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


def conv_encode(bits: np.ndarray, cyclic: bool = True) -> np.ndarray:
    """Bits (n,) -> coded bits (2 n,), two a bit in polynomial order.
    ``cyclic``: the register starts with the stream's last six bits (a
    tail-biting loop, seamless when repeated); else with zeros."""
    b = np.asarray(bits, np.int64)
    head = b[-6:] if cyclic else np.zeros(6, np.int64)
    ext = np.concatenate([head, b])
    reg = np.zeros(len(b), np.int64)
    for k in range(7):  # bit 6 - k of the register: the bit k steps back
        reg |= ext[6 - k:6 - k + len(b)] << (6 - k)
    out = np.stack([_parity(reg & p) for p in POLYS], axis=1)
    return out.reshape(-1).astype(np.uint8)


def _trellis():
    """For each state (the last six bits, newest at bit 5) its two
    predecessors, the bit that leads in, and the branch's coded pair as
    an index 2 c0 + c1."""
    S = 64
    prev = np.zeros((S, 2), np.int64)
    pair = np.zeros((S, 2), np.int64)
    for ns in range(S):
        b = ns >> 5
        for x in (0, 1):
            s = ((ns & 31) << 1) | x
            reg = (b << 6) | s
            c = [bin(reg & p).count("1") & 1 for p in POLYS]
            prev[ns, x] = s
            pair[ns, x] = 2 * c[0] + c[1]
    return prev, pair


PREV, PAIR = _trellis()


def viterbi(soft: np.ndarray) -> np.ndarray:
    """Soft coded symbols (2 n,), positive for bit 0 -> (n,) bits: the
    path of the largest correlation, every start state equally likely,
    traced back from the best last state; one trellis step at a time."""
    y = np.asarray(soft, np.float64).reshape(-1, 2)
    n = len(y)
    # the four branch metrics of each step, by coded pair 2 c0 + c1
    bm = np.stack([y[:, 0] + y[:, 1], y[:, 0] - y[:, 1],
                   -y[:, 0] + y[:, 1], -y[:, 0] - y[:, 1]], axis=1)
    metric = np.zeros(64)
    choice = np.zeros((n, 64), bool)
    p0, p1 = PREV[:, 0], PREV[:, 1]
    b0, b1 = bm[:, PAIR[:, 0]], bm[:, PAIR[:, 1]]  # (n, 64) each
    for i in range(n):
        c0 = metric[p0] + b0[i]
        c1 = metric[p1] + b1[i]
        pick = c1 > c0
        choice[i] = pick
        metric = np.maximum(c0, c1)
        if not i % 1024:  # keep the metrics near 0
            metric -= metric.max()
    bits = np.empty(n, np.uint8)
    s = int(np.argmax(metric))
    for i in range(n - 1, -1, -1):
        bits[i] = s >> 5
        s = int(PREV[s, int(choice[i, s])])
    return bits


def asm_hits(bits: np.ndarray, tolerance: int = 3) -> list[tuple[int, bool]]:
    """Every position whose 32 bits lie within ``tolerance`` of the ASM
    (False) or of its complement (True, the 180-degree turn)."""
    b = np.asarray(bits, np.uint8)
    if len(b) < 32:
        return []
    win = np.lib.stride_tricks.sliding_window_view(b, 32)
    dist = np.count_nonzero(win != ASM_BITS, axis=1)
    return ([(int(i), False) for i in np.flatnonzero(dist <= tolerance)]
            + [(int(i), True) for i in np.flatnonzero(dist >= 32 - tolerance)])
