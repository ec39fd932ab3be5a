"""Operations and bytes of the serial scans' functions, from their shapes:
the Costas loop (``costas_scan``), Mueller & Muller timing (``mm_scan``)
and the Viterbi decoder (``viterbi_decode``).

As in `counts`, these count the work the function needs, each input byte
read once and each output byte written once, whatever an implementation
reads again; a cosine, a sine, a division or a rounding counts as one
operation, a compare or a select as none.
"""

from __future__ import annotations

COMPLEX64 = 8
FLOAT32 = 4

# one Costas step: the sample turned by the phase (cos, sin, 4 products,
# 2 sums), the order-4 error (2 products, 1 difference; the slicer's
# signs are selects), the frequency (1 product, 1 sum), the phase (1
# product, 2 sums) and its wrap into one turn (a difference, which the
# compares select)
COSTAS_STEP_OPS = 17


def costas_scan(n: int, rows: int = 1) -> dict:
    """``rows`` loops of ``n`` samples: each sample read and its turned
    sample written, the (phase, frequency) carries read and written."""
    nbytes = rows * (2 * COMPLEX64 * n + 4 * FLOAT32)
    return {"bytes": nbytes, "flops": rows * n * COSTAS_STEP_OPS}


def mm_scan(n: int, n_out: int, symbols: float, phases: int, taps: int,
            rows: int = 1) -> dict:
    """``rows`` complex M&M scans of ``n`` new samples (``taps - 1``
    carried before them) into ``n_out`` symbol slots, ``symbols`` of them
    computed: the samples and the ``phases x taps`` bank read, the slots
    and their validity bytes written.  A symbol: its interpolation
    (``2 taps`` products, ``2 (taps - 1)`` sums), the error (2 complex
    differences, 2 two-term dot products, a difference: 11), the rate and
    the phase (5), the phase's floor and remainder (2)."""
    nbytes = (rows * (COMPLEX64 * (n + taps - 1) + (COMPLEX64 + 1) * n_out)
              + FLOAT32 * phases * taps)
    flops = rows * symbols * (4 * taps - 2 + 18)
    return {"bytes": nbytes, "flops": flops}


def viterbi_decode(n: int, states: int = 64, rate: int = 2,
                   rows: int = 1) -> dict:
    """``rows`` blocks of ``n`` trellis steps, ``rate`` soft symbols a
    step: the symbols and the branch table read, the bits and the final
    metrics written.  A step: the ``2^rate`` distinct branch metrics
    (``+-y0 +- y1 ...``, ``rate - 1`` sums each; a sign is a select),
    then for each state its two paths' adds and one normalising
    difference; the compare of the two paths and those of the maximum
    count as none."""
    nbytes = (rows * (FLOAT32 * rate * n + n + FLOAT32 * states)
              + FLOAT32 * states * 2 * rate)
    per_step = 2 ** rate * (rate - 1) + 3 * states
    return {"bytes": nbytes, "flops": rows * n * per_step}
