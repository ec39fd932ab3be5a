"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the
CPU runs in about a second (two VFOs, an 8192-bin waterfall, a 0.3 s
capture, four blocks a call), and the card fixture."""

import pytest
import torch

from sdrbench import harness


def tiny(cell: dict) -> dict:
    cell["config"].update(vfos=2, fft_size=8192)
    t = cell["traffic"]
    t.update(capture_s=0.3, blocks_per_call=min(4, t["blocks_per_call"]),
             warmup_calls=1, check_blocks=3)
    return cell


@pytest.fixture
def tiny_cell():
    def make(name: str, root=harness.ROOT) -> dict:
        return tiny(harness.load_cell(name, root))
    return make


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
