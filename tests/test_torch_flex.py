"""sdrtpu_torch's FLEX frame layer against sdrtpu's: a host copy on the
port's POCSAG BCH code, so every result equals the reference's: the FIW,
the interleaver, the encoder's bits, and the messages decoded from a
noisy chunked stream with bit errors, fed numpy arrays or tensors."""

from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.decoders import flex as jf  # noqa: E402
from sdrtpu_torch.decoders import flex as tf  # noqa: E402
from sdrtpu_torch.decoders import pocsag as tp  # noqa: E402

MSGS = [(0x12345, "HELLO FLEX"), (0x0BEEF, "SDR ON TPU!"), (0x1, "X")]


def test_fiw_and_interleaver_equal():
    assert tf.correct_codeword is tp.correct_codeword
    rng = np.random.default_rng(3)
    for cycle, frame in [(0, 0), (7, 42), (14, 127)]:
        assert tf.make_fiw(cycle, frame) == jf.make_fiw(cycle, frame)
        assert tf.parse_fiw(tf.make_fiw(cycle, frame)) == {
            "cycle": cycle, "frame": frame}
    assert tf.parse_fiw(tf.make_fiw(3, 9) ^ 0x10) is None
    words = rng.integers(0, 1 << 32, 8, dtype=np.uint64)
    np.testing.assert_array_equal(tf.interleave_block(words),
                                  jf.interleave_block(words))
    np.testing.assert_array_equal(
        tf.deinterleave_block(tf.interleave_block(words)), words)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_frames_decode_like_the_reference(as_tensor):
    rng = np.random.default_rng(8)
    bits = tf.build_flex_frame(2, 77, MSGS)
    np.testing.assert_array_equal(bits, jf.build_flex_frame(2, 77, MSGS))
    bits = bits.copy()
    for blk in range(11):  # one error in every interleaved block
        bits[96 + blk * 256 + int(rng.integers(0, 256))] ^= 1
    noise = rng.integers(0, 2, 300).astype(np.uint8)
    stream = np.concatenate([noise, bits, noise[:100],
                             tf.build_flex_frame(3, 78, MSGS[:1])])
    jd, td = jf.FlexDecoder(), tf.FlexDecoder()
    got, want = [], []
    for chunk in np.array_split(stream, 7):
        want += jd.process(chunk)
        got += td.process(torch.as_tensor(chunk) if as_tensor else chunk)
    assert [astuple(m) for m in got] == [astuple(m) for m in want]
    assert [(m.address, m.text) for m in got] == MSGS + MSGS[:1]
    assert td.frames_seen == jd.frames_seen == 2
