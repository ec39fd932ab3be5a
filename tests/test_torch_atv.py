"""sdrtpu_torch's ATV decoder against sdrtpu's.

Tolerances: the normalized video and the gathered lines within 1e-4
(the two order statistics are the same samples; the line gather
interpolates at the same float32 phase), `line_phase` within 1e-3
samples (the profile's mean and cumsum add in another order), the
line-sync tail streamed across blocks from one converted state within
1e-4; the host layers (sync classes, field starts, the frame
assembler, the synthesizer) equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders import atv as ja  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.decoders import atv as ta  # noqa: E402

L = ta.LINE_SIZE


def _image(seed, rows, cols):
    rng = np.random.default_rng(seed)
    img = np.clip(rng.uniform(0.1, 1.0, (rows, cols)), 0, 1)
    img[rows // 3:rows // 2, cols // 5:cols // 2] = 1.0
    return img


def test_synthesis_equal():
    img = _image(14, 24, 96)
    np.testing.assert_array_equal(ta.synthesize_atv(img),
                                  ja.synthesize_atv(img))


@pytest.mark.parametrize("roll", [0, 311])
def test_demod_and_line_sync_stream(roll):
    """Two blocks of 32 lines (the second rolled by a phase offset):
    video, line phase, lines and the carried tail as the reference."""
    iq = np.roll(ta.synthesize_atv(_image(3, 64, 128)), roll)
    jd, td = ja.AtvVideoDemod(), ta.AtvVideoDemod()
    jl, tl = ja.AtvLineSync(), ta.AtvLineSync(device="cpu")
    sj = jl.init_state()
    st = state_from_jax(sj, "cpu")
    for blk in (iq[:32 * L], iq[32 * L:]):
        _, vj = jd((), jnp.asarray(blk))
        _, vt = td((), torch.as_tensor(blk))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)
        pj = float(ja.line_phase(vj))
        pt = float(ta.line_phase(torch.as_tensor(np.array(vj))))
        assert abs(pt - pj) < 1e-3, (pt, pj)
        sj, lj = jl(sj, vj)
        st, lt = tl(st, torch.as_tensor(np.array(vj)))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    assert lt.numpy()[2:, :ta.SYNC_LEN].mean() < -0.3


def test_subsample_phase_equal():
    """A 0.37-sample fractional delay: both estimate the same phase."""
    env = np.abs(ta.synthesize_atv(np.full((48, 128), 0.5, np.float32)))
    env = env.astype(np.float64)
    shift = 0.37
    delayed = (env[:-1] * (1 - shift) + env[1:] * shift)[:40 * L]
    v = np.asarray(ja.AtvVideoDemod()((), jnp.asarray(
        delayed.astype(np.float32)))[1])
    pj = float(ja.line_phase(jnp.asarray(v)))
    pt = float(ta.line_phase(torch.as_tensor(np.array(v))))
    assert abs(pt - pj) < 1e-3


def test_percentile_large_block():
    """More than 2**24 samples (torch.quantile's limit): the same two
    order statistics as numpy's linear percentile."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 1.0, (1 << 24) + 4097).astype(np.float32)
    lo, hi = ta._percentiles(torch.as_tensor(x), (0.5, 99.0))
    np.testing.assert_allclose([float(lo), float(hi)],
                               np.percentile(x, [0.5, 99.0]), rtol=1e-6)


def _line(kind, value=0.5):
    row = np.zeros(L, np.float32)
    if kind == "video":
        row[:ta.SYNC_LEN] = ta.SYNC_LEVEL
        row[ta.ACTIVE_START:] = value
    elif kind == "short":
        row[:35] = ta.SYNC_LEVEL
    elif kind == "long":
        row[: L - 25] = ta.SYNC_LEVEL
    return row


def _cadence():
    """tests/test_atv.py::test_interlaced_field_assembly's 625-line
    cadence: an even field, an odd field, and the next even field."""
    even_seq = [0, 1, 1, 2, 2, 2, 1, 1]
    odd_seq = [1, 1, 1, 2, 2, 1, 1, 1]
    kind = {0: "video", 1: "short", 2: "long"}
    lines = [_line("video", 0.1)] * 4
    lines += [_line(kind[c]) for c in even_seq]
    lines += [_line("video", 0.25)] * 305
    lines += [_line(kind[c]) for c in odd_seq]
    lines += [_line("video", 0.75)] * 304
    lines += [_line(kind[c]) for c in even_seq]
    return np.stack(lines)


def test_frame_assembler_and_sync_classes_equal():
    lines = _cadence()
    np.testing.assert_array_equal(ta.classify_sync(lines),
                                  ja.classify_sync(lines))
    np.testing.assert_array_equal(ta.detect_field_starts(lines),
                                  ja.detect_field_starts(lines))
    jas, tas = ja.AtvFrameAssembler(), ta.AtvFrameAssembler()
    jf = jas.process(lines[:100]) + jas.process(lines[100:])
    # the port's assembler takes the lines as a tensor too
    tf = tas.process(torch.as_tensor(lines[:100])) + tas.process(lines[100:])
    assert len(tf) == len(jf) >= 1
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)
    assert (tas.vlock, tas.ypos, tas.line, tas.history) == (
        jas.vlock, jas.ypos, jas.line, jas.history)
    assert abs(tf[-1][0:500:2].mean() - 0.25) < 0.02
