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
  (`kernels.clock.mm_scan`, banks of up to 32 taps) and the Viterbi
  decoder (`fec.viterbi.viterbi_decode`, rates 1/2 to 1/4); on a CPU
  tensor each wrapper runs its plain PyTorch version instead.
- Contractions that stand in for the reference's pinned-precision
  matmuls run in full float32 whatever TF32 settings the caller made
  (`_precision.fp32_contractions`).

Subpackages mirror sdrtpu: ``graph`` (stream-op protocol, checkpoints,
the host-boundary ``CompiledOp``), ``kernels`` (DSP ops, the modulators
of ``kernels.mod``), ``shard`` (channelizer: dense and sparse alias
fold, the PFB filter bank; and the multi-GPU layer on
``torch.distributed``: the (channel, time) process mesh, the halo
exchange and prefix relock, the sharded flagship, process start-up and
scaling measurement), ``apps``
(the multi-VFO WBFM pipeline, the radio chain, the receiver and its
command line, the live radio, the band scanner, scanner and recorder,
and the host edge around the receiver: the SDR++ baseband server
``sdrtpu-torch-server`` with its remote menus, the rigctl server and
client, the web spectrum view, the module registry and RPC, tuning
policies, scheduler, bookmarks, band plans, themes, presence and
diagrams), ``fec`` (Viterbi, Reed-Solomon, Golay), ``decoders`` (CCSDS
frames, RDS, DAB, Falcon 9, KG-STV, M17 with its codec2 binding, RyFi,
POCSAG, FLEX, HRPT, ATV, VOR), ``io`` (WAV and soft-symbol files,
network IQ ingest and egress, the SDR++ server protocol with its SmGui
draw lists and compression, the rtl_tcp, SpyServer, Hermes and Spectran
clients, the audio sink), ``native`` (the C++ ingest pump, ring and IQ
conversion, built with g++ on first use); ``metrics`` is the receiver's
registry, ``benchmark`` (``measure_op``) and ``roofline`` (the stage
models with the H100's peaks) measure, and ``convert`` carries state
between the two packages.
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
