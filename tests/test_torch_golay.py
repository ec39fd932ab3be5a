"""sdrtpu_torch's Golay (24,12) codec (a host numpy copy) against
sdrtpu's.  No tolerance: code words, corrections and error counts are
integers and must be equal."""

import numpy as np
import pytest

pytest.importorskip("torch")

from sdrtpu.fec import golay as jg  # noqa: E402
from sdrtpu_torch.fec import golay as tg  # noqa: E402

RNG = np.random.default_rng(24)


def test_every_code_word_equal():
    words = [tg.encode24(d) for d in range(4096)]
    assert words == [jg.encode24(d) for d in range(4096)]
    assert tg.encode24(0x555) == 0x555D0D


def test_syndrome_table_equal():
    assert tg.Golay24()._table == jg.Golay24()._table


@pytest.mark.parametrize("n_err", [0, 1, 2, 3, 4])
def test_decode_matches_reference(n_err):
    t, j = tg.Golay24(), jg.Golay24()
    for _ in range(60):
        data = int(RNG.integers(0, 4096))
        cw = tg.encode24(data)
        for p in RNG.choice(24, n_err, replace=False):
            cw ^= 1 << int(p)
        got = t.decode24(cw)
        assert got == j.decode24(cw)
        if n_err <= 3:
            assert got[0] == data
