"""The Meteor-M2 LRPT decoder VFO on the receiver's normal path, on the
CPU: `Receiver.push` of a seeded LRPT capture through an `IQFrontend`
that holds the decoder VFO (``mode="meteor_lrpt"``) beside an audio VFO;
the frame sink gets the capture's CVCDUs in order (the loop's first
frame the second time round: the loops lock within it the first time)
and the deframer's counters add up.  And the deframer counts a codeword
RS cannot correct.

`costas_mm_scan` (the Costas and M&M scans of `MeteorDemod` in one
launch on the card) on the CPU: its plain path is `costas_scan_ref` then
`mm_scan_ref` over the carried tail and the turned samples, equal to the
bit; it refuses arguments its kernel has no instance for; and
`MeteorDemod` takes it unless the OQPSK delay stands between the loops,
its symbols and state equal to the three steps one after another.

The capture is the benchmark's (`sdrbench.captures.lrpt_pass`: random
CVCDUs through a plain CCSDS encoder, QPSK at 72 ksym/s, white noise and
impulsive bursts that leave RS bytes to correct) at 300 ksps, the VFO at
+75 kHz and so at its 150 ksps after a decimation by 2.  The port's
Costas and M&M scans run their plain loops on the CPU (~0.3 ms a step):
~35 s on one core.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrbench.captures import lrpt_pass  # noqa: E402
from sdrbench.reference import ccsds as plain  # noqa: E402
from sdrtpu_torch.apps.receiver import (  # noqa: E402
    IQFrontend, Receiver, VfoConfig)
from sdrtpu_torch.decoders import ccsds  # noqa: E402
from sdrtpu_torch.kernels import clock, loops  # noqa: E402
from sdrtpu_torch.kernels.psk import MeteorDemod  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FS = 300_000.0
BLOCK = 15_000  # 50 ms
LOOP_S = 0.4    # 28 800 symbols: three frames and fill
SEED = 2**31 + 19
EXTRA = 3  # blocks pushed past the loop: the first frame's second pass


def capture_cfg() -> dict:
    cfg = json.loads((ROOT / "sdrbench/configs/meteor_lrpt_2m4.json")
                     .read_text())
    cfg["samplerate"] = FS
    cfg["vfos"][0]["offset_hz"] = 75_000.0
    return cfg


@pytest.fixture(scope="module")
def pushed():
    cfg = capture_cfg()
    n = round(LOOP_S * FS)
    cvcdus, _ = lrpt_pass.payload(cfg, n, SEED)
    x = lrpt_pass.make(cfg, n, SEED, "cpu").numpy()
    fe = IQFrontend(FS, {
        "lrpt": VfoConfig(75_000.0, "meteor_lrpt", 150_000.0),
        "nfm": VfoConfig(-75_000.0, "nfm", 12_500.0)},
        fft_size=2048, device="cpu")
    frames, audio = [], []
    rx = Receiver(fe, block_len=BLOCK, frame_sinks={"lrpt": frames.append},
                  audio_sinks={"nfm": audio.append})
    # the loop and three blocks more, in reads of odd sizes
    stream = np.concatenate([x, x[:EXTRA * BLOCK]])
    for part in np.array_split(stream, 7):
        rx.push(part)
    return cvcdus, frames, audio, rx


def test_the_frame_sink_gets_the_cvcdus_in_order(pushed):
    cvcdus, frames, _, _ = pushed
    assert len(frames) == len(cvcdus) == 3
    for got, want in zip(frames, np.roll(cvcdus, -1, axis=0)):
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_the_counters_add_up(pushed):
    cvcdus, frames, audio, rx = pushed
    d = rx.deframers["lrpt"]
    c = d.counters
    assert c["frames"] == len(frames) == len(d.positions)
    assert c["rs_failures"] == 0
    assert c["rs_codewords"] == 4 * len(frames)
    assert c["rs_corrected_bytes"] == sum(d.rs_errors)
    # frames back to back, one ASM every 8224 symbols, then the loop's
    # fill and its first frame again
    loop = round(LOOP_S * 72_000)
    assert np.diff(d.positions).tolist() == [
        plain.FRAME_BITS, loop - 2 * plain.FRAME_BITS]
    # the audio VFO beside it: one (2, n) block a push of a block
    assert len(audio) == round(LOOP_S * FS) // BLOCK + EXTRA
    assert audio[0].shape == (2, 2400)


def test_decoder_vfo_output_is_symbols_and_count():
    fe = IQFrontend(FS, {"lrpt": VfoConfig(75_000.0, "meteor_lrpt")},
                    spectrum=False, device="cpu")
    fe.bind(BLOCK)
    vfo = fe.vfos["lrpt"]
    assert vfo.decoder and vfo.radio.if_rate == 150_000.0
    x = torch.zeros(BLOCK, dtype=torch.complex64)
    _, (outs, spec) = fe(fe.init_state(), x)
    syms, count = outs["lrpt"]
    assert spec is None
    assert syms.shape == (vfo.out_len(BLOCK),)
    assert syms.dtype == torch.complex64
    assert 0 < int(count) <= syms.shape[0]


def _frame_bits(cvcdu: np.ndarray, bad: int = 0) -> np.ndarray:
    """A frame's channel bits with ``bad`` bytes of codeword 0 turned."""
    rs = ccsds._ccsds_rs()
    code = ccsds.rs_interleave_encode(cvcdu, rs)
    code[4 * np.arange(bad)] ^= 0x5A
    frame = np.zeros(ccsds.FRAME_BYTES, np.uint8)
    frame[:len(code)] = code
    return np.concatenate([ccsds.ASM_BITS, np.unpackbits(frame ^ ccsds._RAND)])


@pytest.mark.parametrize("bad,failures", [(16, 0), (17, 1)])
def test_rs_failures_are_counted(bad, failures):
    rng = np.random.default_rng(5)
    cv = rng.integers(0, 256, (2, ccsds.CVCDU_BYTES), dtype=np.uint8)
    d = ccsds.CcsdsDeframer(device="cpu")
    got = d.process_bits(np.concatenate([_frame_bits(cv[0], bad),
                                         _frame_bits(cv[1]),
                                         np.zeros(8, np.uint8)]))
    assert d.counters["rs_failures"] == failures
    assert d.counters["rs_codewords"] == 8
    assert len(got) == 2 - failures
    assert np.array_equal(got[-1], cv[1])
    assert d.positions[-1] == ccsds.CcsdsDeframer._FRAME_BITS
    assert d.counters["rs_corrected_bytes"] == (bad if not failures else 0)


@pytest.mark.parametrize("lead", [0, ccsds.CcsdsDeframer._LEAD_BITS])
def test_a_negated_stream_cut_at_frame_seams_loses_no_frame(monkeypatch,
                                                             lead):
    """A 180-degree lock (the soft stream negated: every decoded bit
    complemented) at a coded-bit SNR of ~3 dB, handed over in calls cut
    at each frame seam.  Each call decodes from the Viterbi's state 0,
    where the stream's state is the complement of the last frame's last
    bits: without the carry's lead the next frame's ASM can come out
    with more than 3 bits wrong, and its frame is lost."""
    monkeypatch.setattr(ccsds.CcsdsDeframer, "_LEAD_BITS", lead)
    rng = np.random.default_rng(23)
    cv = rng.integers(0, 256, (6, ccsds.CVCDU_BYTES), dtype=np.uint8)
    fill = rng.integers(0, 2, 300, dtype=np.uint8)
    bits = np.concatenate([fill, *map(_frame_bits, cv), fill[:40]])
    coded = ccsds.CcsdsEncoder().conv.encode(bits).astype(np.float32)
    soft = 2.0 * coded - 1.0 + 0.7 * rng.standard_normal(
        coded.shape).astype(np.float32)
    seams = [2 * (len(fill) + k * ccsds.CcsdsDeframer._FRAME_BITS)
             for k in range(1, len(cv))]
    d = ccsds.CcsdsDeframer(device="cpu")
    got = []
    for a, b in zip([0] + seams, seams + [len(soft)]):
        got += d.process(soft[a:b])
    if lead:
        assert len(got) == len(cv)
        assert all(np.array_equal(g, c) for g, c in zip(got, cv))
    else:
        assert 0 < len(got) < len(cv)


def _meteor_like(rng, rows, n):
    """QPSK held at the Meteor demodulator's 25/12 samples a symbol,
    0.7 rad and 100 Hz off at 150 ksps, noisy: (rows, n) complex64."""
    k = np.arange(n)
    sym = np.exp(1j * (np.pi / 2 * rng.integers(0, 4, (rows, n // 2 + 1))
                       + np.pi / 4))
    x = sym[:, k * 12 // 25] * np.exp(1j * (0.7 + 2 * np.pi * 100.0 * k
                                            / 150_000.0))
    x = x + 0.05 * (rng.standard_normal((rows, n))
                    + 1j * rng.standard_normal((rows, n)))
    return torch.as_tensor(x.astype(np.complex64))


def _scan_args(rows, n, mode=loops.COSTAS_ORDER4):
    """`costas_mm_scan`'s arguments, by name, for the Meteor
    demodulator's loops over ``rows`` rows of ``n`` samples, from
    carries a block in."""
    rng = np.random.default_rng(29)
    d = MeteorDemod(device="cpu")
    mm, st = d.recov, d.recov.init_state()
    tail = 0.5 * _meteor_like(rng, rows, mm.T - 1)
    carries = [st[k].to(dtype).expand(rows).clone()
               for k, dtype in clock._MM_LEAVES]
    carries[0] += 1  # the offset
    carries[1] += 0.4  # the phase
    return dict(x=_meteor_like(rng, rows, n), tail=tail,
                phase0=torch.full((rows,), 0.2), freq0=torch.zeros(rows),
                alpha=d.costas._coefficients()[0],
                beta=d.costas._coefficients()[1],
                fmin=d.costas._coefficients()[2],
                fmax=d.costas._coefficients()[3], mode=mode,
                bank=mm._bank, n_out=mm.max_out(n), carries=carries,
                mm_fmin=mm._loop()[0], mm_fmax=mm._loop()[1],
                omega_gain=mm._loop()[2], mu_gain=mm._loop()[3])


@pytest.mark.parametrize("rows,n,mode", [
    (1, 300, loops.COSTAS_ORDER4), (2, 300, loops.COSTAS_ORDER4),
    (1, 5, loops.COSTAS_ORDER4), (1, 300, loops.COSTAS_BROKEN)])
def test_costas_mm_scan_on_the_cpu_is_the_two_plain_loops(rows, n, mode):
    a = _scan_args(rows, n, mode)
    got = clock.costas_mm_scan(**a)
    y, ph, fr = loops.costas_scan_ref(a["x"], a["phase0"], a["freq0"],
                                      a["alpha"], a["beta"], a["fmin"],
                                      a["fmax"], mode)
    ext = torch.cat([a["tail"], y], dim=-1)
    off, *f, p1, p2, c1, c2 = a["carries"]
    syms, valid, offset, fstate, cstate = clock.mm_scan_ref(
        ext, a["bank"], n, a["n_out"], off, torch.stack(f, 1),
        torch.stack([p1, p2, c1, c2], 1), a["mm_fmin"], a["mm_fmax"],
        a["omega_gain"], a["mu_gain"])
    want = (y, ph, fr, syms, valid, ext[:, n:],
            (offset - n, *fstate.unbind(1), *cstate.unbind(1)))
    assert int(valid.sum()) > (0 if n < 10 else 100 * rows)
    for g, w in zip(got[:-1] + got[-1], want[:-1] + want[-1]):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _refused(a, fault):
    rows = a["x"].shape[0]
    if fault == "x complex128":
        a["x"] = a["x"].to(torch.complex128)
    elif fault == "a carry float64":
        a["carries"][3] = a["carries"][3].double()
    elif fault == "tail of another row count":
        a["tail"] = a["tail"][:rows - 1]
    elif fault == "phase0 of another row count":
        a["phase0"] = torch.zeros(rows + 1)
    elif fault == "a carry of another row count":
        a["carries"][5] = torch.zeros(rows + 1, dtype=torch.complex64)
    elif fault == "a 16-tap bank":
        a["bank"] = torch.zeros((128, 16))
        a["tail"] = torch.zeros((rows, 15), dtype=torch.complex64)
    elif fault == "a Costas of order 2":
        a["mode"] = loops.COSTAS_ORDER2
    return a


@pytest.mark.parametrize("fault", [
    "x complex128", "a carry float64", "tail of another row count",
    "phase0 of another row count", "a carry of another row count",
    "a 16-tap bank", "a Costas of order 2"])
def test_costas_mm_scan_refuses_what_it_has_no_instance_for(fault):
    a = _refused(_scan_args(2, 50), fault)
    with pytest.raises(ValueError):
        clock.costas_mm_scan(**a)


@pytest.mark.parametrize("oqpsk,fused_calls", [(False, 1), (True, 0)])
def test_meteor_demod_fuses_its_loops_unless_the_q_delay_parts_them(
        monkeypatch, oqpsk, fused_calls):
    d = MeteorDemod(oqpsk=oqpsk, device="cpu")
    calls = []
    fused = clock.costas_mm_scan
    monkeypatch.setattr(clock, "costas_mm_scan",
                        lambda *a: calls.append(a) or fused(*a))
    x = _meteor_like(np.random.default_rng(31), 1, 400)[0]
    st = d.init_state()
    st, _ = d(st, x)  # carries a block in
    new, (syms, valid) = d(st, x)
    assert len(calls) == 2 * fused_calls
    # the three steps one after another
    _, y = d.rrc(st["rrc"], x)
    _, y = d.agc(st["agc"], y)
    costas, y = d.costas(st["costas"], y)
    if oqpsk:
        y = torch.complex(y.real, torch.cat([st["last_i"].reshape(1),
                                             y.imag[:-1]]))
    mm, (s2, v2) = d.recov(st["mm"], y)
    assert int(valid.sum()) > 150
    assert torch.equal(syms, s2) and torch.equal(valid, v2)
    assert all(torch.equal(a, b) for a, b in zip(new["costas"], costas))
    assert new["mm"].keys() == mm.keys()
    for k in mm:
        assert new["mm"][k].shape == mm[k].shape
        assert torch.equal(new["mm"][k], mm[k]), k
