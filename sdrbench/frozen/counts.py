"""Operations and bytes of the kernels' functions, from their shapes.

These count the work the function needs, each input byte read once and
each output byte written once, whatever an implementation reads again.
"""

from __future__ import annotations

COMPLEX64 = 8


def chunk_build(n_new: int, tpad: int, chunks: int, nfft: int) -> dict:
    """The overlap-save chunk build (K1, ``chunk_poly``): from the window
    ``ext = [tail (tpad - 1) ++ new samples (n_new)]`` it writes ``chunks``
    chunks of ``nfft`` samples each, in polyphase layout.  It reads
    ``ext`` once and writes the chunks once, and computes nothing: a
    copy, bound by bytes."""
    nbytes = COMPLEX64 * (n_new + tpad - 1) + COMPLEX64 * chunks * nfft
    return {"bytes": nbytes, "flops": 0}
