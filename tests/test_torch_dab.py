"""sdrtpu_torch's DAB mode I receiver core against sdrtpu's.

Tolerances: the host layers (interleaver, PRS, puncturing, energy
dispersal, CRC, FIB/FIG build and parse, the modulator) are copies and
give equal values; `demod_frame` gives equal dibits (the FFT's rounding
stays far from the slicer's pi/2 boundaries at AWGN 0.02); the FIC
decode (depuncture, one rate-1/4 K=7 Viterbi launch for the frame's
four codewords, energy dispersal, CRC) gives equal bits: its soft
symbols are +-1 and 0, exact in any summation order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.decoders import dab as jd  # noqa: E402
from sdrtpu_torch.decoders import dab as td  # noqa: E402
from sdrtpu_torch.fec import viterbi as tv  # noqa: E402

RNG = np.random.default_rng(41)


def _fibs(cif_count=42):
    fibs = [td.build_fib([td.make_fig_0_0(0xD1E5, cif_count=cif_count),
                          td.make_fig_1_0(0xD1E5, "SDRTPU ENSEMBLE")]),
            td.build_fib([td.make_fig_1_1(0xC0DE, "TPU RADIO 1")])]
    while len(fibs) < td.FIBS_PER_FRAME:
        fibs.append(td.build_fib([]))
    return np.stack(fibs)


def test_host_tables_equal():
    np.testing.assert_array_equal(td.freq_interleave_table(),
                                  jd.freq_interleave_table())
    np.testing.assert_array_equal(td.prs_phases(), jd.prs_phases())
    np.testing.assert_array_equal(td.fic_puncture_mask(),
                                  jd.fic_puncture_mask())
    np.testing.assert_array_equal(td.energy_dispersal(768),
                                  jd.energy_dispersal(768))
    for pi in range(1, 25):
        np.testing.assert_array_equal(td.puncture_vector(pi),
                                      jd.puncture_vector(pi))
    fibs = _fibs()
    np.testing.assert_array_equal(fibs, np.stack(
        [jd.build_fib([jd.make_fig_0_0(0xD1E5, cif_count=42),
                       jd.make_fig_1_0(0xD1E5, "SDRTPU ENSEMBLE")]),
         jd.build_fib([jd.make_fig_1_1(0xC0DE, "TPU RADIO 1")])]
        + [jd.build_fib([])] * 10))
    mod_t, mod_j = td.DabModulator(), jd.DabModulator()
    np.testing.assert_array_equal(mod_t.fic_to_symbols(fibs),
                                  mod_j.fic_to_symbols(fibs))


def test_fic_round_trip_with_noise():
    """FIGs -> FIBs -> FIC coding -> one OFDM frame after a junk prefix,
    AWGN 0.02 -> find_null -> demod -> FIC decode (one Viterbi launch
    for the four codewords) -> CRC -> FIG parse; both packages."""
    fibs = _fibs()
    mod = td.DabModulator()
    dibits = np.concatenate([
        mod.fic_to_symbols(fibs),
        RNG.integers(0, 4, (td.NUM_SYMS - 1 - td.FIC_SYMS, td.CARRIERS))])
    frame = mod.modulate_frame(dibits)
    np.testing.assert_array_equal(frame, jd.DabModulator().modulate_frame(
        dibits))
    x = np.concatenate([frame[-5000:], frame, frame[:3000]])
    x = (x + 0.02 * (RNG.standard_normal(x.size)
                     + 1j * RNG.standard_normal(x.size))).astype(np.complex64)
    tdem, jdem = td.DabDemodulator(device="cpu"), jd.DabDemodulator()
    start = tdem.find_null(x)
    assert start == jdem.find_null(x) and abs(start - 5000) < 50
    assert tdem.freq_offset(x, start + td.NULL) == jdem.freq_offset(
        x, start + td.NULL)
    seg = x[start:start + td.FRAME]
    got = tdem.demod_frame(seg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdem.demod_frame(seg)))
    np.testing.assert_array_equal(got.numpy(), dibits)
    before = tv.viterbi_decode.launches
    fibs_t, ok_t = tdem.decode_fic(got)
    fibs_j, ok_j = jdem.decode_fic(np.asarray(jdem.demod_frame(seg)))
    assert ok_t.all() and ok_j.all()
    np.testing.assert_array_equal(fibs_t, fibs_j)
    np.testing.assert_array_equal(fibs_t, fibs)
    figs = td.parse_figs(fibs_t[0])
    assert figs == jd.parse_figs(fibs_j[0])
    assert {"type": (0, 0), "eid": 0xD1E5, "change": 0,
            "cif_count": 42} in figs
    svc = [f for f in td.parse_figs(fibs_t[1]) if f["type"] == (1, 1)]
    assert svc[0]["sid"] == 0xC0DE and svc[0]["label"].strip() == "TPU RADIO 1"
    # on the CPU the wrapper runs its plain loop and counts nothing
    assert tv.viterbi_decode.launches == before


def test_punctured_code_absorbs_two_percent_bit_errors():
    fibs = _fibs()
    mod = td.DabModulator()
    coded = np.concatenate([mod.fic_encode_group(
        fibs[3 * g:3 * g + 3].reshape(-1)) for g in range(4)])
    soft = 1.0 - 2.0 * coded.astype(np.float32)
    soft[RNG.choice(soft.size, soft.size // 50, replace=False)] *= -1.0
    tdem, jdem = td.DabDemodulator(device="cpu"), jd.DabDemodulator()
    groups = [soft[g * td.FIC_CODEWORD:(g + 1) * td.FIC_CODEWORD]
              for g in range(4)]
    got = np.stack([tdem.fic_decode_group(s) for s in groups])
    want = np.stack([jdem.fic_decode_group(s) for s in groups])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(12, 256), fibs)
    # the frame form (four rows, one launch) decodes the same bits
    rows = tdem._decode_groups(torch.as_tensor(soft.reshape(4, -1)))
    np.testing.assert_array_equal(rows, got)
