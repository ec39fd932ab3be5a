"""The frozen byte count of the chunk build against the chunks the
port's plain version builds at the flagship's plan."""

import torch

from sdrbench.frozen import counts, peaks
from sdrbench.systems.wbfm_pipeline import System
from sdrbench import harness


def test_chunk_build_bytes_match_the_shapes():
    from sdrtpu_torch.kernels.chunks import chunk_poly_ref

    cfg = harness.load_cell("wbfm8.batch")["config"]
    system = System(dict(cfg, fft_size=8192), "cpu")
    plan = system.chunk_build_plan()
    assert plan == {"valid": 4000, "tpad": 1121, "nfft": 5120}
    chain = system.pipe.channelizer.fused
    for blocks in (1, 8):
        n = blocks * cfg["block_len"]
        ext = torch.zeros(n + plan["tpad"] - 1, dtype=torch.complex64)
        P = n // plan["valid"]
        ct = chunk_poly_ref(ext, plan["valid"], chain.ratio, chain.nif, P)
        work = counts.chunk_build(n, plan["tpad"], P, plan["nfft"])
        assert work["bytes"] == 8 * (ext.numel() + ct.numel())
    # one 8-block launch: 72 968 960 bytes, 21.78 us at 3.35 TB/s
    b = peaks.bound(counts.chunk_build(4_000_000, 1121, 1000, 5120)["bytes"],
                    0)
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.0217818) < 1e-6
