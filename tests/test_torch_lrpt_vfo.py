"""The Meteor-M2 LRPT decoder VFO on the receiver's normal path, on the
CPU: `Receiver.push` of a seeded LRPT capture through an `IQFrontend`
that holds the decoder VFO (``mode="meteor_lrpt"``) beside an audio VFO;
the frame sink gets the capture's CVCDUs in order (the loop's first
frame the second time round: the loops lock within it the first time)
and the deframer's counters add up.  And the deframer counts a codeword
RS cannot correct.

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
