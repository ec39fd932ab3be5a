"""sdrtpu_torch — the sdrtpu receive path in PyTorch, for NVIDIA Hopper GPUs.

A second package beside ``sdrtpu`` (the JAX reference).  It keeps the
reference's module layout so each part has an obvious counterpart, and
its own copies of the host-side design math (taps, windows), so it
imports nothing of ``sdrtpu`` and nothing of JAX.

- Stream ops keep the ``op(state, x) -> (state, y)`` protocol; state is
  dicts and tuples of torch tensors that live on the op's device.
- Every constructor takes ``device`` (default ``"cuda"``) and raises when
  CUDA is unavailable unless the caller asked for ``"cpu"``.
- Seven stages are CUDA kernels written by hand (``csrc/*.cu``): the
  overlap-save chunk builder (`kernels.chunks.chunk_poly`), the fused
  mix + decimate (`kernels.fused_channelizer.mix_decimate`), the AGC,
  PLL and Costas scans (`kernels.loops.agc_scan`, `pll_scan`,
  `costas_scan`), the Mueller & Muller clock recovery
  (`kernels.clock.mm_scan`) and the Viterbi decoder
  (`fec.viterbi.viterbi_decode`); on a CPU tensor each wrapper runs its
  plain PyTorch version instead.

Subpackages mirror sdrtpu: ``graph`` (stream-op protocol, checkpoints),
``kernels`` (DSP ops), ``shard`` (channelizer), ``apps`` (the multi-VFO
WBFM pipeline, the radio chain, the receiver and its command line),
``fec`` (Viterbi, Reed-Solomon), ``decoders`` (CCSDS frames, RDS),
``io`` (WAV and soft-symbol files); ``convert`` carries state between
the two packages.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The device an op runs on; raises for CUDA when no card is present.

    Never falls back to the CPU: a caller that wants the CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sdrtpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev
