"""Full float32 for the port's contractions, whatever the caller set.

The reference pins the precision of every matrix-unit contraction per
call, because one reduced-precision pass broke its SINAD floors.  The
port's counterpart: each contraction that stands in for such a pinned
contraction (the banded-Toeplitz FIRs, the polyphase resampler, the
alias fold, K2's plain version, the feed-forward interpolator) runs
inside `fp32_contractions`, which turns TF32 off for cuBLAS and cuDNN
and puts the caller's settings back on exit, also when the body raises.
A program that calls ``torch.set_float32_matmul_precision("high")`` or
sets ``allow_tf32`` therefore gets the same bits from the port as one
that leaves PyTorch's defaults.

PyTorch has two interfaces to these settings: the older
``set_float32_matmul_precision`` / ``cudnn.allow_tf32`` and, in recent
versions, ``fp32_precision``; reading one after the caller wrote the
other can raise.  The helper keeps to the interface the caller used: the
older one unless reading it raises.  The settings belong to the process:
while any thread is inside the helper they stay pinned, and the caller's
come back when the last one leaves.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# The settings are process-wide, so nested and concurrent users (two
# threads each running a chain) share one pin: the outermost entry saves
# the caller's settings and pins, the last exit restores them.
_lock = threading.Lock()
_depth = 0
_restore = None


def _legacy_in_use() -> bool:
    try:
        torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set fp32_precision
        return False
    return True


def _pin():
    """Turn TF32 off; return the function that puts the settings back."""
    cudnn = torch.backends.cudnn
    if _legacy_in_use():
        saved = (torch.get_float32_matmul_precision(), cudnn.allow_tf32)
        torch.set_float32_matmul_precision("highest")
        cudnn.allow_tf32 = False

        def restore():
            torch.set_float32_matmul_precision(saved[0])
            cudnn.allow_tf32 = saved[1]
    else:
        matmul = torch.backends.cuda.matmul
        saved = (matmul.fp32_precision, cudnn.conv.fp32_precision)
        matmul.fp32_precision = "ieee"
        cudnn.conv.fp32_precision = "ieee"

        def restore():
            matmul.fp32_precision = saved[0]
            cudnn.conv.fp32_precision = saved[1]
    return restore


@contextlib.contextmanager
def fp32_contractions():
    """Run the body with TF32 off for matmuls and convolutions; restore
    the caller's settings when the last body still inside (in any
    thread) exits."""
    global _depth, _restore
    with _lock:
        if _depth == 0:
            _restore = _pin()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _restore()
                _restore = None
