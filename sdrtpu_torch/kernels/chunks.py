"""Overlap-save chunk builder (K1): the CUDA kernel and its plain version.

Counterpart of ``sdrtpu/kernels/pallas_chunks.py`` `chunk_poly`.  The
FFT channelizer's forward path needs the chunk polyphase layout

    ct[p, s, q] = ext[p*valid + q*R + s],   s in [0, R), q in [0, nif)

with samples past the end of ``ext`` read as zero.  On a CUDA tensor
`chunk_poly` launches ``csrc/chunk_poly.cu`` (a tiled transpose through
shared memory, see the source's note); on a CPU tensor it runs
`chunk_poly_ref`.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def chunk_poly_ref(ext: torch.Tensor, valid: int, R: int, nif: int,
                   P: int) -> torch.Tensor:
    """Plain PyTorch version: pad, unfold, view, transpose, copy."""
    need = (P - 1) * valid + R * nif
    if ext.shape[0] < need:
        ext = torch.cat([ext, ext.new_zeros(need - ext.shape[0])])
    frames = ext.unfold(0, R * nif, valid)[:P]  # (P, R*nif) view
    return frames.view(P, nif, R).transpose(1, 2).contiguous()


def chunk_poly(ext: torch.Tensor, valid: int, R: int, nif: int,
               P: int) -> torch.Tensor:
    """complex64 ``ext`` (L,) -> complex64 ``ct`` (P, R, nif).

    CPU tensor: `chunk_poly_ref`.  CUDA tensor: the hand-written kernel
    on the current stream (``chunk_poly.launches`` counts its launches);
    anything else raises.
    """
    valid, R, nif, P = int(valid), int(R), int(nif), int(P)
    if ext.device.type == "cpu":
        return chunk_poly_ref(ext, valid, R, nif, P)
    if ext.device.type != "cuda":
        raise ValueError(f"chunk_poly: unsupported device {ext.device}")
    if ext.dtype != torch.complex64 or ext.ndim != 1:
        raise ValueError(
            f"chunk_poly: want 1-D complex64, got {ext.dtype} {tuple(ext.shape)}")
    if not ext.is_contiguous():
        raise ValueError("chunk_poly: ext must be contiguous")
    if min(valid, R, nif, P) < 1:
        raise ValueError(f"chunk_poly: bad plan {(valid, R, nif, P)}")
    q_tiles = -(-nif // 32)
    if P * q_tiles >= 2 ** 31 or -(-R // 32) >= 2 ** 16:
        raise ValueError(f"chunk_poly: grid too large for {(R, nif, P)}")
    out = torch.empty((P, R, nif), dtype=torch.complex64, device=ext.device)
    # (ext, out, L, valid, R, nif, P, stream) -> cudaError_t
    entry = _build.bind("chunk_poly", "chunk_poly_launch",
                        (ctypes.c_void_p,) * 2 + (ctypes.c_longlong,) * 2
                        + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    _build.launch(chunk_poly, entry, ext.device, ext.data_ptr(),
                  out.data_ptr(), ext.shape[0], valid, R, nif, P)
    return out


chunk_poly.launches = 0
