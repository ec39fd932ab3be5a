"""DAB OFDM receiver core (PyTorch counterpart of ``sdrtpu/decoders/dab.py``;
``decoder_modules/dab_decoder`` capability).

Transmission mode I (ETSI EN 300 401): 2.048 Msps, 2048-point FFT, 1536
active carriers, 504-sample guard interval, 76 OFDM symbols per 96 ms
frame preceded by a 2656-sample null symbol.  Differential QPSK between
consecutive symbols; the first data symbol references the phase reference
symbol (PRS).

The port's structure, as the reference package's:

- null-symbol detection (moving-energy minimum), the fractional
  frequency offset (guard-interval autocorrelation), the modulator, the
  FIB/FIG layer and the CRC are the reference's host numpy;
- `DabDemodulator.demod_frame` runs on the demodulator's device: one
  batched 2048-point FFT over the 76 symbols, the carrier gather in the
  frequency-interleaved order, the differential product between
  consecutive symbols, angle and slice to dibits;
- `DabDemodulator.decode_fic` de-maps, depunctures the frame's four FIC
  codewords on the device and decodes them as the four rows of one
  rate-1/4 K=7 `viterbi_decode` launch (mother code polys 0o133, 0o171,
  0o145, 0o133, EN 300 401 SS11.2 puncturing); energy dispersal and the
  FIB CRC-16/CCITT on the host.

The PRS is the real ETSI mode-I phase reference (h-table + Table-44
(k', i, n) parameters, §14.3.2), so coarse sync / channel estimation is
off-air interoperable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fec.viterbi import ConvEncoder, ViterbiDecoder

FS = 2_048_000.0
FFT = 2048
CARRIERS = 1536
GUARD = 504
SYM = FFT + GUARD          # 2552
NUM_SYMS = 76              # excluding the null symbol
NULL = 2656
FRAME = NULL + NUM_SYMS * SYM  # 196608 samples = 96 ms

DAB_POLYS = (0o133, 0o171, 0o145, 0o133)  # rate 1/4 mother code

# FIC: symbols 1..3 carry the Fast Information Channel.
FIC_SYMS = 3
FIB_BITS = 256        # one FIB = 30 bytes + CRC16
FIBS_PER_FRAME = 12   # mode I: 4 codewords x 3 FIBs
FIC_CODEWORD = 2304   # punctured bits per 3-FIB group (EN 300 401 SS11.2)

# Puncturing (EN 300 401 SS11.1.2): the serialized rate-1/4 mother output
# is split into 32-bit vectors; v_PI keeps 8 + PI of each 32.  The
# standard's Table-29 vectors follow a layered construction: base = c0 of
# each of the 8 input bits, then each PI increment adds one more output
# (c1, then c2, then c3 layer) in the fixed group order 0,4,2,6,1,5,3,7.
_PI_ORDER = (0, 4, 2, 6, 1, 5, 3, 7)


def puncture_vector(pi: int) -> np.ndarray:
    """32-entry keep mask v_PI, 1 <= PI <= 24 (EN 300 401 Table 29)."""
    assert 1 <= pi <= 24
    v = np.zeros(32, np.uint8)
    v[0::4] = 1
    for j in range(pi):
        layer = 1 + j // 8
        v[_PI_ORDER[j % 8] * 4 + layer] = 1
    return v


# tail puncturing vector V_T: keep c0,c1 of each of the 6 tail bits
VT = np.tile(np.array([1, 1, 0, 0], np.uint8), 6)


def fic_puncture_mask() -> np.ndarray:
    """Keep mask over one 3-FIB group's 3096 mother-code bits:
    21 x 128-bit blocks at PI=16, 3 blocks at PI=15, 24 tail bits at V_T
    (EN 300 401 SS11.2: 2688 + 384 + 24 -> 2016 + 276 + 12 = 2304)."""
    m = np.concatenate([
        np.tile(puncture_vector(16), 84),
        np.tile(puncture_vector(15), 12),
        VT,
    ])
    assert m.size == 3096 and int(m.sum()) == FIC_CODEWORD
    return m


_FIC_MASK = fic_puncture_mask()


def freq_interleave_table() -> np.ndarray:
    """Carrier permutation (EN 300 401 §14.6): pi recursion on 0..2047,
    keeping values mapping to active carriers."""
    pi = np.zeros(FFT, np.int64)
    for i in range(1, FFT):
        pi[i] = (13 * pi[i - 1] + 511) % FFT
    sel = [p for p in pi if 256 <= p <= 1792 and p != 1024]
    return np.asarray(sel[:CARRIERS], np.int64) - 1024  # carrier index -768..768


_KS = freq_interleave_table()


def _carrier_bins(k: np.ndarray) -> np.ndarray:
    """Carrier index (-768..768, no 0) -> FFT bin."""
    return np.where(k < 0, k + FFT, k)


# ETSI EN 300 401 §14.3.2 phase reference symbol, transmission mode I:
# phi_k = (pi/2) * (h[i, k - k'] + n) over 48 blocks of 32 carriers.
# h rows have period 16 (the standard lists j = 0..31 with the second
# half repeating the first).  Parameters cross-validated against the
# reference's evaluated table (``dab_decoder/src/dab_phase_sym.h``):
# all 1536 carriers match except the single k=+768 entry, where the
# reference deviates from its own 11 other row-1 blocks (a generator
# quirk there; one carrier of 1536 is inaudible either way).
_PRS_H16 = np.array(
    [
        [0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1],
        [0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0],
        [0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3],
        [0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2],
    ],
    np.int64,
)
_PRS_H = np.concatenate([_PRS_H16, _PRS_H16], axis=1)  # (4, 32)

# (k', i, n) per 32-carrier block (EN 300 401 Table 44, mode I)
PRS_TABLE = (
    (-768, 0, 1), (-736, 1, 2), (-704, 2, 0), (-672, 3, 1),
    (-640, 0, 3), (-608, 1, 2), (-576, 2, 2), (-544, 3, 3),
    (-512, 0, 2), (-480, 1, 1), (-448, 2, 2), (-416, 3, 3),
    (-384, 0, 1), (-352, 1, 2), (-320, 2, 3), (-288, 3, 3),
    (-256, 0, 2), (-224, 1, 2), (-192, 2, 2), (-160, 3, 1),
    (-128, 0, 1), (-96, 1, 3), (-64, 2, 1), (-32, 3, 2),
    (1, 0, 3), (33, 3, 1), (65, 2, 1), (97, 1, 1),
    (129, 0, 2), (161, 3, 2), (193, 2, 1), (225, 1, 0),
    (257, 0, 2), (289, 3, 2), (321, 2, 3), (353, 1, 3),
    (385, 0, 0), (417, 3, 2), (449, 2, 1), (481, 1, 3),
    (513, 0, 3), (545, 3, 3), (577, 2, 3), (609, 1, 0),
    (641, 0, 3), (673, 3, 0), (705, 2, 1), (737, 1, 1),
)


def prs_phase_for_carrier(k: int) -> float:
    """ETSI mode-I PRS phase for carrier index k (-768..768, k != 0)."""
    kp_idx = (k + 768) // 32 if k < 0 else 24 + (k - 1) // 32
    kp, i, n = PRS_TABLE[kp_idx]
    return float(np.pi / 2 * (_PRS_H[i, k - kp] + n))


def prs_phases(carriers: np.ndarray | None = None) -> np.ndarray:
    """PRS phases ordered like ``carriers`` (default: the ``_KS``
    interleaved order used for the modulator/demodulator bins)."""
    ks = _KS if carriers is None else np.asarray(carriers)
    return np.array([prs_phase_for_carrier(int(k)) for k in ks], np.float64)


def energy_dispersal(n_bits: int) -> np.ndarray:
    """PRBS x^9 + x^5 + 1, init all ones (EN 300 401 §10)."""
    reg = 0x1FF
    out = np.empty(n_bits, np.uint8)
    for i in range(n_bits):
        b = ((reg >> 8) ^ (reg >> 4)) & 1
        out[i] = b
        reg = ((reg << 1) | b) & 0x1FF
    return out


def crc16_ccitt(data_bits: np.ndarray) -> int:
    """CRC-16/CCITT (poly 0x1021, init 0xFFFF) over a bit array."""
    crc = 0xFFFF
    for b in np.asarray(data_bits, np.uint8):
        fb = ((crc >> 15) & 1) ^ int(b)
        crc = ((crc << 1) & 0xFFFF)
        if fb:
            crc ^= 0x1021
    return crc


class DabModulator:
    """Build mode-I DAB frames from FIC bit payloads (tests/tx)."""

    def __init__(self):
        self.prs = prs_phases()
        self.enc = ConvEncoder(7, DAB_POLYS)
        self.bins = _carrier_bins(_KS)

    def _ofdm_symbol(self, phases: np.ndarray) -> np.ndarray:
        spec = np.zeros(FFT, np.complex128)
        spec[self.bins] = np.exp(1j * phases)
        t = np.fft.ifft(spec) * np.sqrt(FFT)
        return np.concatenate([t[-GUARD:], t])

    def modulate_frame(self, sym_dqpsk: np.ndarray) -> np.ndarray:
        """sym_dqpsk: (NUM_SYMS-1, CARRIERS) dibit phases (0..3)*pi/2."""
        out = [np.zeros(NULL, np.complex128)]
        phases = self.prs.copy()
        out.append(self._ofdm_symbol(phases))
        for s in range(sym_dqpsk.shape[0]):
            phases = phases + np.pi / 4 + sym_dqpsk[s] * (np.pi / 2)
            out.append(self._ofdm_symbol(phases))
        return np.concatenate(out).astype(np.complex64)

    def fic_encode_group(self, fib_triple: np.ndarray) -> np.ndarray:
        """One 3-FIB group (768 bits) -> 2304-bit FIC codeword.

        EN 300 401 SS10-11: energy dispersal (PRBS reset per group) ->
        rate-1/4 K=7 mother code with 6 tail bits -> puncturing
        (PI=16 / PI=15 / V_T).
        """
        bits = np.asarray(fib_triple, np.uint8)
        assert bits.size == 3 * FIB_BITS
        scr = bits ^ energy_dispersal(bits.size)
        coded = self.enc.encode(np.concatenate([scr, np.zeros(6, np.uint8)]))
        assert coded.size == 3096
        return coded[_FIC_MASK.astype(bool)]

    def fic_to_symbols(self, fibs: np.ndarray) -> np.ndarray:
        """12 FIBs -> (FIC_SYMS, CARRIERS) DQPSK dibits, off-air format.

        4 codewords of 2304 bits fill symbols 1..3 sequentially; each
        symbol's 3072 bits map to QPSK per EN 300 401 SS14.5
        (q_n = [(1-2 p_n) + j (1-2 p_{n+1536})]/sqrt(2)) in the
        frequency-interleaved carrier order.
        """
        fibs = np.asarray(fibs, np.uint8).reshape(FIBS_PER_FRAME, FIB_BITS)
        coded = np.concatenate(
            [self.fic_encode_group(fibs[3 * g: 3 * g + 3].reshape(-1))
             for g in range(4)]
        )
        assert coded.size == FIC_SYMS * 2 * CARRIERS
        p = coded.reshape(FIC_SYMS, 2 * CARRIERS)
        a, b = p[:, :CARRIERS], p[:, CARRIERS:]
        # (a, b) -> dibit d with q-phase pi/4 + d*pi/2:
        # (0,0)->0, (1,0)->1, (1,1)->2, (0,1)->3
        return (a ^ b) + 2 * b


class DabDemodulator:
    """Frame samples -> DQPSK dibit decisions (+ FIC decode) on
    ``device``."""

    def __init__(self, device="cuda"):
        self.prs = prs_phases()
        self.viterbi = ViterbiDecoder(7, DAB_POLYS, device=device)
        self.device = self.viterbi.device
        self.bins = torch.as_tensor(_carrier_bins(_KS), device=self.device)
        self._keep = torch.as_tensor(_FIC_MASK.astype(bool),
                                     device=self.device)

    def find_null(self, x: np.ndarray) -> int:
        """Start of frame = minimum of the NULL-length moving energy."""
        p = np.abs(np.asarray(x)) ** 2
        cs = np.concatenate([[0.0], np.cumsum(p)])
        window = cs[NULL:] - cs[:-NULL]
        return int(np.argmin(window[: max(1, len(window) - FRAME // 2)]))

    def freq_offset(self, x: np.ndarray, sym_start: int) -> float:
        """Fractional carrier offset from guard correlation (Hz)."""
        seg = np.asarray(x)[sym_start : sym_start + SYM]
        c = np.vdot(seg[:GUARD], seg[FFT : FFT + GUARD])
        return float(np.angle(c) / (2 * np.pi) * FS / FFT)

    def demod_frame(self, x) -> torch.Tensor:
        """x: FRAME samples starting at the null symbol (host numpy or a
        tensor).  Returns (NUM_SYMS-1, CARRIERS) int32 dibits on the
        demodulator's device."""
        x = torch.as_tensor(x, device=self.device).to(torch.complex64)
        start = NULL
        syms = x[start : start + NUM_SYMS * SYM].reshape(NUM_SYMS, SYM)
        spec = torch.fft.fft(syms[:, GUARD:], dim=-1) / np.sqrt(FFT)
        cars = spec[:, self.bins]  # (NUM_SYMS, CARRIERS)
        diff = cars[1:] * torch.conj(cars[:-1])
        # remove the pi/4 DQPSK offset and slice to dibits
        ang = torch.angle(diff) - np.pi / 4
        return torch.remainder(torch.round(ang / (np.pi / 2)), 4).to(
            torch.int32)

    def fic_decode_group(self, soft_codeword: np.ndarray) -> np.ndarray:
        """2304 soft bits (+1 = 0) -> 768 FIB-group bits.

        Depunctures to the 3096-bit mother stream (0.0 erasures at
        punctured positions), Viterbi-decodes the rate-1/4 K=7 code and
        removes the energy dispersal."""
        soft = torch.as_tensor(soft_codeword, dtype=torch.float32,
                               device=self.device)
        assert soft.numel() == FIC_CODEWORD
        return self._decode_groups(soft.reshape(1, FIC_CODEWORD))[0]

    def _decode_groups(self, soft: torch.Tensor) -> np.ndarray:
        """(G, 2304) soft codewords on the device -> (G, 768) bits on the
        host: depunctured to the 3096-bit mother stream (0.0 erasures),
        one `viterbi_decode` launch for all G rows, energy dispersal
        removed."""
        full = soft.new_zeros((soft.shape[0], 3096))
        full[:, self._keep] = soft
        decoded = self.viterbi.decode_rows(full)[:, : 3 * FIB_BITS]
        return (decoded.cpu().numpy()
                ^ energy_dispersal(3 * FIB_BITS)).astype(np.uint8)

    def decode_fic(self, dibits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(>=FIC_SYMS, CARRIERS) dibits -> (12 FIBs (12, 256), crc_ok (12,)).

        Inverse of `DabModulator.fic_to_symbols`: per-symbol QPSK bit
        de-mapping (EN 300 401 SS14.5), 4 codewords, depuncture + Viterbi
        + energy dispersal, FIB CRC check (SS5.2.1: transmitted CRC is the
        one's complement of CRC-16/CCITT over the first 30 bytes).  The
        four codewords are the four rows of one Viterbi launch.
        """
        d = torch.as_tensor(dibits[:FIC_SYMS], device=self.device)
        a = (d == 1) | (d == 2)
        b = d >= 2
        p = torch.cat([a, b], dim=1).reshape(-1)  # (FIC_SYMS*3072,)
        soft = 1.0 - 2.0 * p.to(torch.float32)
        fibs = self._decode_groups(soft.reshape(4, FIC_CODEWORD)).reshape(
            FIBS_PER_FRAME, FIB_BITS)
        ok = np.array([fib_crc_ok(f) for f in fibs], bool)
        return fibs, ok


# --- FIB / FIG layer (EN 300 401 SS5.2, SS8.1) ---------------------------


def fib_crc_ok(fib_bits: np.ndarray) -> bool:
    """FIB check: CRC-16/CCITT over the first 30 bytes equals the one's
    complement of the stored CRC (EN 300 401 SS5.2.1)."""
    bits = np.asarray(fib_bits, np.uint8)
    crc = crc16_ccitt(bits[:240])
    stored = 0
    for b in bits[240:256]:
        stored = (stored << 1) | int(b)
    return crc == (stored ^ 0xFFFF)


def build_fib(figs: list[bytes]) -> np.ndarray:
    """FIG byte strings (header byte included) -> 256-bit FIB.

    Pads with an 0xFF end marker + zeros to 30 bytes, appends the
    complemented CRC-16."""
    data = b"".join(figs)
    assert len(data) <= 30, "FIG data exceeds FIB capacity"
    if len(data) < 30:
        data += b"\xff" + b"\x00" * (29 - len(data))
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    crc = crc16_ccitt(bits) ^ 0xFFFF
    crc_bits = np.array([(crc >> (15 - i)) & 1 for i in range(16)], np.uint8)
    return np.concatenate([bits, crc_bits])


def make_fig_0_0(eid: int, cif_count: int = 0, change: int = 0,
                 al_flag: int = 0) -> bytes:
    """FIG 0/0 ensemble information."""
    body = bytes([
        0x00,                       # CN=0 OE=0 PD=0 ext=0
        (eid >> 8) & 0xFF, eid & 0xFF,
        ((change & 3) << 6) | ((al_flag & 1) << 5) | ((cif_count >> 8) & 0x1F),
        cif_count & 0xFF,
    ])
    return bytes([(0 << 5) | len(body)]) + body


def make_fig_1_0(eid: int, label: str, charset: int = 0,
                 flag: int = 0xFF00) -> bytes:
    """FIG 1/0 ensemble label (16 chars)."""
    lab = label.ljust(16)[:16].encode("latin-1")
    body = bytes([((charset & 0xF) << 4) | 0x0,
                  (eid >> 8) & 0xFF, eid & 0xFF]) + lab + bytes(
        [(flag >> 8) & 0xFF, flag & 0xFF])
    return bytes([(1 << 5) | len(body)]) + body


def make_fig_1_1(sid: int, label: str, charset: int = 0,
                 flag: int = 0xFF00) -> bytes:
    """FIG 1/1 programme service label."""
    body = bytes([((charset & 0xF) << 4) | 0x1,
                  (sid >> 8) & 0xFF, sid & 0xFF]) + label.ljust(16)[:16].encode(
        "latin-1") + bytes([(flag >> 8) & 0xFF, flag & 0xFF])
    return bytes([(1 << 5) | len(body)]) + body


def parse_figs(fib_bits: np.ndarray) -> list[dict]:
    """Parse one CRC-valid FIB's FIGs (types 0 ext 0, 1 ext 0/1 decoded;
    others reported raw)."""
    data = np.packbits(np.asarray(fib_bits[:240], np.uint8)).tobytes()
    out = []
    i = 0
    while i < 30:
        hdr = data[i]
        if hdr == 0xFF:
            break  # end marker
        ftype, flen = hdr >> 5, hdr & 0x1F
        body = data[i + 1: i + 1 + flen]
        i += 1 + flen
        if ftype == 0 and len(body) >= 1 and (body[0] & 0x1F) == 0 and len(body) >= 5:
            out.append({
                "type": (0, 0),
                "eid": (body[1] << 8) | body[2],
                "change": body[3] >> 6,
                "cif_count": ((body[3] & 0x1F) << 8) | body[4],
            })
        elif ftype == 1 and len(body) >= 21 and (body[0] & 0x7) in (0, 1):
            ext = body[0] & 0x7
            ident = (body[1] << 8) | body[2]
            label = body[3:19].decode("latin-1")
            out.append({
                "type": (1, ext),
                ("eid" if ext == 0 else "sid"): ident,
                "label": label,
                "charset": body[0] >> 4,
            })
        else:
            out.append({"type": ("raw", ftype), "data": bytes(body)})
    return out
