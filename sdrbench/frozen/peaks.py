"""Published peaks of one NVIDIA H100 SXM and the least time of a piece
of work against them.

Copied from ``sdrtpu_torch/roofline.py`` (``H100_PEAKS``, ``bound``) at
commit 794db71f23cf1f26fdc4edce6acfb7756f4932c5.  NVIDIA's data sheet,
dense rates, at the card's full 700 W: 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

H100_PEAKS = {
    "name": "NVIDIA H100 SXM",
    "flops_f32": 67e12,
    "hbm_gbps": 3350.0,
}


def bound(nbytes: float, flops: float, peaks: dict = H100_PEAKS) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flops`` float32 operations: the larger of bytes
    over the memory rate and operations over the peak rate, and which
    it is."""
    by_bytes = nbytes / (peaks["hbm_gbps"] * 1e9)
    by_ops = flops / peaks["flops_f32"]
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
