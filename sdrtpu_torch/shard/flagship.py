"""The flagship WBFM multi-VFO pipeline, sharded over a (channel, time) mesh.

PyTorch counterpart of ``sdrtpu/shard/flagship.py``.  The wideband FFT
channelizer front, where nearly all input samples live, is sharded over
BOTH mesh axes via `time_sharded_channelizer` (the halo passed along
``time``, each rank's channel rows of the fold and rotator tables along
``channel``).  Everything after the IF boundary (WFM demod, audio
resampler, de-emphasis) carries sequential per-channel state, so it
runs channel-sharded only: the IF rows are all-gathered over the time
group (the counterpart of the reference's reshard to ``P("channel",
None)``; at a 250 kHz IF it is 40x less data than the wideband input)
and each rank demodulates its own channel rows.

Matches `apps.wbfm_pipeline.WbfmMultiVfoPipeline` to float tolerance
(the local-span FFT plan rounds differently from the global plan):
tests/test_torch_shard.py and `multihost.dryrun_multichip`.
"""

from __future__ import annotations

import numpy as np

from ..apps.wbfm_pipeline import WbfmMultiVfoPipeline
from .channelizer import FftDecimatorChain
from .mesh import Mesh, all_gather
from .overlap import time_sharded_channelizer


class ShardedWbfmPipeline:
    """`WbfmMultiVfoPipeline` executing over a ("channel", "time") mesh.

    ``block_len`` is the GLOBAL wideband block (a multiple of the mesh's
    time-axis size times the pipeline's decimation).  Each rank's call
    takes the global block (numpy or a tensor on any device), copies its
    own span to its device, and returns the audio (2, C_local, n_af) of
    its channel rows; ``state`` is the rank's part of `init_state()`
    (`mesh.shard_channel_state`).
    """

    def __init__(self, offsets_hz, in_samplerate: float, block_len: int,
                 mesh: Mesh, **pipeline_kw):
        self.mesh = mesh
        self.n_time = mesh.size("time")
        assert block_len % self.n_time == 0, (block_len, self.n_time)
        # the unsharded pipeline provides the demod/audio path (and, with
        # ``skip_rotator``, passes the channelizer's guard for it)
        self.pipe = WbfmMultiVfoPipeline(
            offsets_hz, in_samplerate, block_len, channelizer_method="fft",
            device=mesh.device, **pipeline_kw)
        rr = self.pipe.channelizer.resampler
        if (rr.predecim is None or not rr.predecim.stages
                or rr.resamp is not None):
            # a fractional in->IF ratio puts a polyphase stage after the
            # predecimation that this sharded front does not replicate
            raise ValueError(
                "time sharding needs an INTEGER in->IF decimation for its "
                "FFT front; choose an input rate that is an integer "
                "multiple of the IF rate (e.g. 10 Msps -> 250 kHz)")
        stages = [(np.asarray(s.taps), s.decimation)
                  for s in rr.predecim.stages]
        local = block_len // self.n_time
        R = int(np.prod([M for _, M in stages]))
        assert local % R == 0, (
            f"local time span {local} must be a multiple of the decimation "
            f"ratio {R}; pick block_len as a multiple of n_time * "
            f"block_multiple")
        self.front = FftDecimatorChain(
            np.asarray(offsets_hz, np.float64), in_samplerate, stages, local,
            skip_rotator=self.pipe.skip_rotator, device=mesh.device)

    def init_state(self):
        """The whole state (every channel); `shard_channel_state` takes
        each rank's part."""
        st = self.pipe.init_state()
        st["chan"] = self.front.init_state()
        return st

    def out_len(self, n: int) -> int:
        return self.pipe.out_len(n)

    def __call__(self, state, x):
        st = dict(state)
        st["chan"], y = time_sharded_channelizer(self.mesh, self.front, x,
                                                 state["chan"])
        # IF boundary: each channel row's time spans, gathered
        y = all_gather(self.mesh, y, "time", dim=-1)
        # the unsharded pipeline's IF back end: its CUDA graph on the card
        a = self.pipe._if_back_end(st, state, y)
        return st, a
