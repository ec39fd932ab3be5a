"""The mixed-mode receiver of ``sdrtpu_torch.apps.receiver``, built as
``apps/cli.py`` and ``chip_smoke.py``'s ``build_receiver`` build it: an
`IQFrontend` with the configuration's VFOs (each at its mode's bandwidth)
and its waterfall, and a `Receiver` that binds the block, which fuses
the VFOs that share an IF rate into one channelizer each.

Entry ``"call"``: the bound frontend on one block already on the device,
under ``torch.inference_mode()``, as ``Receiver._step`` runs it after
its copy to the device.  Outputs, with a leading block axis:
``audio.<vfo>`` (1, 2, n_audio) and ``spec`` (1, frames, fft_size).
"""

from __future__ import annotations

import torch


class System:
    def __init__(self, cfg: dict, device):
        from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig

        self.samplerate = float(cfg["samplerate"])
        self.block_len = int(cfg["block_len"])
        modes = cfg["modes"]
        self.frontend = IQFrontend(
            self.samplerate,
            {v["name"]: VfoConfig(float(v["offset_hz"]), v["mode"],
                                  modes[v["mode"]]["bandwidth_hz"])
             for v in cfg["vfos"]},
            audio_rate=float(cfg["audio_rate"]),
            fft_size=int(cfg["fft_size"]), fft_rate=float(cfg["fft_rate"]),
            device=device)
        # the Receiver binds the block, which fuses the VFOs that share an
        # IF rate into one channelizer each
        Receiver(self.frontend, block_len=self.block_len)
        fe = self.frontend
        self.outputs = {f"audio.{n}": (2, v.out_len(self.block_len))
                        for n, v in fe.vfos.items()}
        self.outputs["spec"] = (self.block_len // fe.spectrum.interval,
                                int(cfg["fft_size"]))

    def init_state(self):
        return self.frontend.init_state()

    def call(self, entry: str, state, xs):
        """``xs`` (1, block_len) on the device -> (state, outputs)."""
        if entry != "call":
            raise ValueError(f"unknown entry {entry!r}")
        assert xs.shape[0] == 1, xs.shape
        with torch.inference_mode():
            state, (audios, spec) = self.frontend(state, xs[0])
        out = {f"audio.{n}": a[None] for n, a in audios.items()}
        out["spec"] = spec[None]
        return state, out

    def counters(self) -> dict:
        """The program's own launch counters of its hand kernels: the AGC
        scan and the chunk build (K1)."""
        from sdrtpu_torch.kernels.chunks import chunk_poly
        from sdrtpu_torch.kernels.loops import agc_scan

        return {"agc_scan.launches": getattr(agc_scan, "launches", None),
                "chunk_poly.launches": getattr(chunk_poly, "launches", None)}
