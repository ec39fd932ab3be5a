"""The measurement tooling on the card.

Needs an NVIDIA GPU; skips without a card.  Imports no JAX, so on a
machine without it run it as

    python -m pytest tests/test_torch_tooling_cuda.py -q --noconftest

`measure_hbm_peak` must read at most 105 % of the data sheet's 3.35 TB/s
(it raises above: a timer fault) and a sane rate above 10 % of it;
`measure_op` reports the card's backend.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch import roofline  # noqa: E402
from sdrtpu_torch.benchmark import measure_op  # noqa: E402
from sdrtpu_torch.kernels import taps  # noqa: E402
from sdrtpu_torch.kernels.fir import Fir  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a device measurement")


@pytest.mark.cuda
def test_measure_hbm_peak_reads_the_card():
    _card()
    gbps = roofline.measure_hbm_peak()
    peak = roofline.H100_PEAKS["hbm_gbps"]
    assert 0.1 * peak < gbps <= roofline.HBM_FAULT_SHARE * peak


@pytest.mark.cuda
def test_measure_op_on_the_card():
    _card()
    fir = Fir(taps.low_pass(0.2, 0.1, 1.0), device="cuda")
    r = measure_op(fir, (65536,), k_blocks=2, n_dispatch=2, reps=1)
    assert r["backend"] == "cuda" and r["msps"] > 0
    assert np.isfinite(r["compile_seconds"])
