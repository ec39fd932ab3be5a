"""sdrtpu_torch's HRPT deframer against sdrtpu's: a host copy, so the
word packing, the synthesized frames and the deframed frames (offset,
sync errors, uneven chunks, numpy or tensor input) equal the
reference's exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.decoders import hrpt as jh  # noqa: E402
from sdrtpu_torch.decoders import hrpt as th  # noqa: E402


def test_packing_and_frames_equal():
    rng = np.random.default_rng(31)
    words = rng.integers(0, 1024, 100).astype(np.uint16)
    np.testing.assert_array_equal(th.unpack_words(words),
                                  jh.unpack_words(words))
    np.testing.assert_array_equal(th.pack_words(th.unpack_words(words)),
                                  words)
    img = rng.integers(0, 1024, (5, 2048)).astype(np.uint16)
    np.testing.assert_array_equal(th.build_frame(img), jh.build_frame(img))
    np.testing.assert_array_equal(th.avhrr_lines(th.build_frame(img)), img)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_deframer_equal(as_tensor):
    rng = np.random.default_rng(32)
    imgs = [rng.integers(0, 1024, (5, 2048)).astype(np.uint16)
            for _ in range(2)]
    stream = np.concatenate(
        [rng.integers(0, 2, 777).astype(np.uint8)]
        + [th.unpack_words(th.build_frame(i)) for i in imgs]
        + [rng.integers(0, 2, 100).astype(np.uint8)])
    stream[780] ^= 1  # an error inside the first sync word
    jd, td = jh.HrptDeframer(), th.HrptDeframer()
    got, want = [], []
    for i in range(0, len(stream), 50_007):
        chunk = stream[i:i + 50_007]
        want += jd.process(chunk)
        got += td.process(torch.as_tensor(chunk) if as_tensor else chunk)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.count_nonzero(th.avhrr_lines(got[1]) != imgs[1]) == 0
