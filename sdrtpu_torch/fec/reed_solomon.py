"""Reed-Solomon codec over GF(2^8) (host copy of ``sdrtpu/fec/reed_solomon.py``).

Capability parity with the vendored libcorrect RS implementation
(``core/libcorrect/src/reed-solomon/{reed-solomon,encode,decode,
polynomial}.c``): arbitrary primitive polynomial, first consecutive root
(fcr), root gap (prim), and parity count.  The roots are libcorrect's
``exp[(prim * (fcr + j)) % 255]`` (``correct_reed_solomon_create``), the
form of CCSDS 131.0-B's generator ``prod (x - alpha^(11 j))``, j = 112
.. 143.  Defaults are the classic RS(255,223) CCSDS configuration used
by Meteor LRPT, whose codeword bytes are taken as they come, in the
conventional basis (libcorrect has no dual-basis step; the Falcon 9
decoder converts around it).

This departs from ``sdrtpu/fec/reed_solomon.py``, whose roots sit at
``alpha^(fcr + prim j)``: a different code wherever prim > 1, which
cannot decode a codeword of the CCSDS code.

Host NumPy: RS blocks are tiny (255 bytes) and control-flow heavy, so
syndrome/Berlekamp-Massey/Chien/Forney run on the host next to the
framing layer, off the card.  The syndromes, the Chien search and the
final check are each one table lookup and XOR reduction over every byte
and root at once; Berlekamp-Massey and Forney, at most ``nroots`` steps
on a few terms, stay scalar.
"""

from __future__ import annotations

import numpy as np


class ReedSolomon:
    def __init__(
        self,
        nroots: int = 32,
        prim_poly: int = 0x187,
        fcr: int = 112,
        prim: int = 11,
    ):
        """Defaults: CCSDS RS(255,223) (poly 0x187, fcr 112, prim 11)."""
        self.nroots = nroots
        self.n = 255
        self.k = 255 - nroots

        # GF(2^8) log/antilog tables
        exp = np.zeros(512, np.int32)
        log = np.zeros(256, np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= prim_poly
        exp[255:510] = exp[0:255]
        self.exp, self.log = exp, log
        # the same as Python ints, for the scalar steps
        self._exp, self._log = exp.tolist(), log.tolist()
        self.fcr = fcr
        self.prim = prim
        # iprim: multiplicative inverse of prim mod 255 (for root -> position)
        self.iprim = next(i for i in range(1, 255) if (i * prim) % 255 == 1)

        # generator polynomial with roots alpha^(prim * (fcr + j))
        g = np.array([1], np.int32)
        for j in range(nroots):
            root = exp[(prim * (fcr + j)) % 255]
            g = self._poly_mul(g, np.array([1, root], np.int32))
        self.genpoly = g  # degree nroots, g[0]=1
        # log of x^(n-1-i) at each root x: (nroots, n), for the syndromes
        root_log = (prim * (fcr + np.arange(nroots))) % 255
        self._synd_log = (root_log[:, None]
                          * np.arange(self.n - 1, -1, -1)) % 255
        # log of alpha^(i k): (255, nroots + 1), for the Chien search
        self._chien_log = (np.arange(255)[:, None]
                           * np.arange(nroots + 1)) % 255

    # -- field ops ---------------------------------------------------------
    def _mul(self, a, b):
        if a == 0 or b == 0:
            return 0
        return self._exp[self._log[a] + self._log[b]]

    def _poly_mul(self, p, q):
        out = np.zeros(len(p) + len(q) - 1, np.int32)
        for i, a in enumerate(p):
            if a == 0:
                continue
            for j, b in enumerate(q):
                if b == 0:
                    continue
                out[i + j] ^= self._mul(a, b)
        return out

    def _poly_eval(self, p, x):
        y = 0
        for c in p:
            y = self._mul(y, x) ^ int(c)
        return y

    def _eval_all(self, p, plog):
        """XOR over k of p[k] * exp[plog[..., k]]: the polynomial whose
        coefficients are ``p`` at every point a row of ``plog`` gives."""
        terms = self.exp[self.log[p] + plog]
        return np.bitwise_xor.reduce(np.where(p != 0, terms, 0), axis=-1)

    def _syndromes(self, r):
        """S_j = r(alpha^{prim * (fcr + j)}), r highest power first."""
        return self._eval_all(r, self._synd_log)

    # -- encode ------------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data (k,) uint8 -> codeword (255,) = data ++ parity (systematic)."""
        data = np.asarray(data, np.uint8)
        assert len(data) == self.k
        # LFSR division: parity = (data * x^nroots) mod genpoly
        parity = np.zeros(self.nroots, np.int32)
        for d in data:
            feedback = int(d) ^ int(parity[0])
            parity[:-1] = parity[1:]
            parity[-1] = 0
            if feedback:
                lf = self.log[feedback]
                for j in range(self.nroots):
                    gj = int(self.genpoly[j + 1])
                    if gj:
                        parity[j] ^= self.exp[(lf + self.log[gj]) % 255]
        return np.concatenate([data, parity.astype(np.uint8)])

    # -- decode ------------------------------------------------------------
    def decode(self, codeword: np.ndarray) -> tuple[np.ndarray, int]:
        """(255,) -> (corrected data (k,), n_corrected). n_corrected = -1 on
        decode failure (too many errors)."""
        r = np.asarray(codeword, np.uint8).astype(np.int32)
        assert len(r) == self.n
        exp, log = self._exp, self._log

        synd = self._syndromes(r).tolist()
        if not any(synd):
            return r[: self.k].astype(np.uint8), 0

        # Berlekamp-Massey
        C = [1] + [0] * self.nroots
        B = [1] + [0] * self.nroots
        L, m, b = 0, 1, 1
        for nn in range(self.nroots):
            d = synd[nn]
            for i in range(1, L + 1):
                if C[i] and synd[nn - i]:
                    d ^= exp[(log[C[i]] + log[synd[nn - i]]) % 255]
            if d == 0:
                m += 1
            elif 2 * L <= nn:
                T = C[:]
                coef = exp[(log[d] + 255 - log[b]) % 255]
                for i in range(self.nroots + 1 - m):
                    if B[i]:
                        C[i + m] ^= self._mul(coef, B[i])
                L = nn + 1 - L
                B = T
                b = d
                m = 1
            else:
                coef = exp[(log[d] + 255 - log[b]) % 255]
                for i in range(self.nroots + 1 - m):
                    if B[i]:
                        C[i + m] ^= self._mul(coef, B[i])
                m += 1

        lam = C[: L + 1]
        # Chien search: root alpha^i of Lambda means locator X = alpha^{-i}
        # = alpha^{l*prim}; l is the codeword *power*, array index = n-1-l.
        err_pos = []  # (array_index, locator_power l)
        lam_at = self._eval_all(np.array(lam), self._chien_log[:, : L + 1])
        for i in np.flatnonzero(lam_at == 0):
            l = (self.iprim * (255 - int(i))) % 255
            idx = self.n - 1 - l
            if 0 <= idx < self.n:
                err_pos.append((idx, l))
        if len(err_pos) != L:
            return r[: self.k].astype(np.uint8), -1

        # Forney: error magnitudes.  Omega = S(x)*Lambda(x) mod x^nroots
        omega = [0] * self.nroots
        for i in range(L + 1):
            for j in range(self.nroots - i):
                if lam[i] and synd[j]:
                    omega[i + j] ^= self._mul(lam[i], synd[j])

        for idx, l in err_pos:
            # locator X_k = alpha^{l*prim}; evaluate at X_k^{-1}
            xinv_log = (255 - (l * self.prim) % 255) % 255
            xinv = exp[xinv_log]
            # omega(Xinv), low-order-first coefficients
            num = 0
            xp = 1
            for c in omega:
                if c:
                    num ^= self._mul(c, xp)
                xp = self._mul(xp, xinv)
            # formal derivative lambda'(Xinv): odd-power terms only
            den = 0
            x2 = self._mul(xinv, xinv)
            xp = 1
            for i in range(1, L + 1, 2):
                if lam[i]:
                    den ^= self._mul(lam[i], xp)
                xp = self._mul(xp, x2)
            if den == 0:
                return r[: self.k].astype(np.uint8), -1
            mag = self._mul(num, exp[(255 - log[den]) % 255])
            # e = (Omega/Lambda') * X_k * alpha^{-l*prim*fcr}
            #   = (Omega/Lambda') * alpha^{l*prim*(1 - fcr)}
            scale = exp[(l * self.prim * (1 - self.fcr)) % 255]
            mag = self._mul(mag, scale)
            r[idx] ^= mag

        if self._syndromes(r).any():  # verify
            return r[: self.k].astype(np.uint8), -1
        return r[: self.k].astype(np.uint8), len(err_pos)
