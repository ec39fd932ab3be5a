"""Extended Golay (24,12) codec, M17 link-setup frame FEC (host copy of
``sdrtpu/fec/golay.py``).

Capability parity with the golay24 used by ``decoder_modules/m17_decoder``.
Systematic encoding with the standard generator polynomial 0xAE3 (plus an
overall parity bit); decoding corrects up to 3 bit errors via syndrome
lookup over all <=3-error patterns (precomputed once).
Host NumPy — frames are 24 bits at voice-frame rates.
"""

from __future__ import annotations

# Golay(23,12) generator used by M17 (m17-cxx-demod POLY=0xC75):
# x^11 + x^10 + x^6 + x^5 + x^4 + x^2 + 1.  (0xAE3, its bit reversal,
# generates the MIRROR-IMAGE code: self-consistent in loopback but no
# real M17 LICH word would decode.)  encode24(0x555) == 0x555D0D, the
# reference's own test vector.
_POLY = 0xC75


def _golay_checkbits(data: int) -> int:
    """11 check bits for 12 data bits (polynomial division)."""
    reg = data << 11
    for i in range(22, 10, -1):
        if reg & (1 << i):
            reg ^= _POLY << (i - 11)
    return reg & 0x7FF


def encode24(data: int) -> int:
    """12-bit data -> 24-bit extended Golay codeword (data|check|parity)."""
    data &= 0xFFF
    check = _golay_checkbits(data)
    cw23 = (data << 11) | check
    parity = bin(cw23).count("1") & 1
    return (cw23 << 1) | parity


class Golay24:
    def __init__(self):
        # syndrome -> error pattern (23-bit part), <=3 errors
        self._table: dict[int, int] = {0: 0}
        patterns = [1 << i for i in range(23)]
        for i in range(23):
            for j in range(i + 1, 23):
                patterns.append((1 << i) | (1 << j))
        for i in range(23):
            for j in range(i + 1, 23):
                for k in range(j + 1, 23):
                    patterns.append((1 << i) | (1 << j) | (1 << k))
        for p in patterns:
            syn = self._syndrome(p)
            if syn not in self._table:
                self._table[syn] = p

    @staticmethod
    def _syndrome(cw23: int) -> int:
        reg = cw23
        for i in range(22, 10, -1):
            if reg & (1 << i):
                reg ^= _POLY << (i - 11)
        return reg & 0x7FF

    def decode24(self, cw: int) -> tuple[int | None, int]:
        """24-bit word -> (12-bit data or None, bit errors corrected).

        The overall parity bit is what makes the EXTENDED code d=8: the
        received word's overall parity equals the total error count mod
        2.  A weight-3 table correction with EVEN received parity means
        4 errors (every 4-error pattern's coset leader has weight 3,
        since leader ^ pattern must be a weight-7 codeword) — detected,
        not miscorrected.
        """
        cw23 = (cw >> 1) & 0x7FFFFF
        syn = self._syndrome(cw23)
        err = self._table.get(syn)
        if err is None:
            return None, -1
        n_err = bin(err).count("1")
        parity = bin(cw & 0xFFFFFF).count("1") & 1
        if parity == 0 and n_err == 3:
            return None, -1  # 4-error pattern: detect, don't miscorrect
        corrected = cw23 ^ err
        return (corrected >> 11) & 0xFFF, n_err
