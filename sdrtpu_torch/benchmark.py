"""Throughput of one stream op (counterpart of ``sdrtpu/benchmark.py``).

The reference feeds random buffers through one block and reports samples
per second (``dsp::bench::SpeedTester``).  Here a dispatch is a loop of
``k_blocks`` steps of the op on its device, state carried, ended by a
device synchronisation (CUDA returns before the work is done).

    from sdrtpu_torch.benchmark import measure_op
    print(measure_op(Fir(taps), block_shape=(500000,)))
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_op(op, block_shape: tuple[int, ...], dtype=np.complex64,
               k_blocks: int = 4, n_dispatch: int = 4, reps: int = 3,
               seed: int = 0) -> dict:
    """Sustained samples/s of a stream op on its own device (``op.device``).

    ``compile_seconds`` is the first call: the kernels' load and cuFFT's
    plans on a card.  ``seconds_per_dispatch`` is the best over ``reps``
    of the mean of ``n_dispatch`` dispatches, each ``k_blocks`` blocks of
    seeded random data.  ``backend`` is the device type ("cuda", "cpu").
    """
    device = torch.device(op.device)
    rng = np.random.default_rng(seed)
    shape = (k_blocks,) + tuple(block_shape)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        xs = torch.complex(torch.as_tensor(re), torch.as_tensor(im))
    else:
        xs = torch.as_tensor(re)
    xs = xs.to(device)

    with torch.inference_mode():
        t0 = time.perf_counter()
        state, _ = op(op.init_state(), xs[0])
        _sync(device)
        compile_s = time.perf_counter() - t0

        def dispatch(state):
            for k in range(k_blocks):
                state, _ = op(state, xs[k])
            return state

        state = dispatch(state)  # warm
        _sync(device)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n_dispatch):
                state = dispatch(state)
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / n_dispatch)

    n_samples = k_blocks * int(np.prod(block_shape))
    return {
        "samples_per_dispatch": n_samples,
        "seconds_per_dispatch": best,
        "msps": n_samples / best / 1e6,
        "compile_seconds": compile_s,
        "backend": device.type,
    }
