"""The multi-VFO WBFM receiver of ``sdrtpu_torch.apps.wbfm_pipeline``,
built as ``bench.py`` builds it: the fft channelizer (``"auto"``), the
residual rotator handed to the discriminator, the envelope pilot and the
65536-bin waterfall.

Entries:

- ``"scan_call"``: ``WbfmMultiVfoPipeline.scan_call`` on ``k`` stacked
  blocks, the batched steady state;
- ``"call"``: ``WbfmMultiVfoPipeline.__call__`` on one block.

Both return per-block outputs with a leading block axis:
``audio`` (k, 2, C, n_af) and ``spec`` (k, frames, fft_size).
"""

from __future__ import annotations

import numpy as np


class System:
    def __init__(self, cfg: dict, device):
        from sdrtpu_torch.apps.wbfm_pipeline import WbfmMultiVfoPipeline

        fs = float(cfg["samplerate"])
        span = float(cfg["vfo_span"])
        offsets = np.linspace(-span * fs, span * fs, int(cfg["vfos"]))
        w = cfg["wfm"]
        self.block_len = int(cfg["block_len"])
        self.samplerate = fs
        self.pipe = WbfmMultiVfoPipeline(
            offsets, fs, self.block_len, if_rate=float(cfg["if_rate"]),
            audio_rate=float(cfg["audio_rate"]),
            deviation=float(cfg["deviation"]), stereo=bool(w["stereo"]),
            tau=float(cfg["deemphasis_s"]),
            channelizer_method=cfg["channelizer"], spectrum=True,
            fft_size=int(cfg["fft_size"]), fft_rate=float(cfg["fft_rate"]),
            pilot_mode=w["pilot"], skip_rotator=bool(cfg["skip_rotator"]),
            device=device)
        self.outputs = {
            "audio": (2, len(offsets), self.pipe.out_len(self.block_len)),
            "spec": (self.block_len // self.pipe.spectrum.interval,
                     int(cfg["fft_size"])),
        }

    def init_state(self):
        return self.pipe.init_state()

    def call(self, entry: str, state, xs):
        """``xs`` (k, block_len) on the device -> (state, outputs)."""
        if entry == "scan_call":
            state, (audio, spec) = self.pipe.scan_call(state, xs)
            return state, {"audio": audio, "spec": spec}
        if entry == "call":
            assert xs.shape[0] == 1, xs.shape
            state, (audio, spec) = self.pipe(state, xs[0])
            return state, {"audio": audio[None], "spec": spec[None]}
        raise ValueError(f"unknown entry {entry!r}")

    def counters(self) -> dict:
        """The program's own counters: launches of the chunk build (K1)."""
        from sdrtpu_torch.kernels.chunks import chunk_poly

        return {"chunk_poly_launches": getattr(chunk_poly, "launches", None)}

    def chunk_build_plan(self) -> dict | None:
        """The fft channelizer's overlap-save plan, or None off that path."""
        chain = getattr(self.pipe.channelizer, "fused", None)
        try:
            return {"valid": int(chain.valid), "tpad": int(chain.tpad),
                    "nfft": int(chain.nfft)}
        except AttributeError:
            return None
