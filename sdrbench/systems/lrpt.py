"""The Meteor-M2 LRPT decoder VFO of ``sdrtpu_torch.apps.receiver``, built
as ``apps/cli.py`` users build a receiver: an `IQFrontend` with one VFO
whose mode is the decoder (``"meteor_lrpt"``: DDC to 150 ksps, then
``MeteorDemod``) and the waterfall, bound by a `Receiver`, and the
deframer the `Receiver` gives that VFO (``QpskAmbiguityResolver``).

Entry ``"call"``: for each block already on the device, under
``torch.inference_mode()``, the bound frontend, then the deframer on the
VFO's valid symbols (the Viterbi on the card, the ASM search and
Reed-Solomon on the host), as `Receiver.push` runs them.  Outputs, with
a leading block axis, float32:

- ``syms`` (2, max_out): the symbols' real and imaginary parts, zero
  past ``nsyms`` (1,);
- ``frames`` (12, 892): the CVCDUs the block completed, as bytes;
  ``frame_pos`` (12,): each one's ASM position in symbols from the
  block's first symbol; ``nframes`` (1,).

The state is the frontend's state and the count of symbols before the
next block; the deframer keeps its own, and `init_state`, a new stream,
gives the VFO a new deframer.
"""

from __future__ import annotations

import torch

MAX_FRAMES = 12
CVCDU_BYTES = 892


class System:
    def __init__(self, cfg: dict, device):
        from sdrtpu_torch.apps.receiver import IQFrontend, Receiver, VfoConfig

        self.samplerate = float(cfg["samplerate"])
        self.block_len = int(cfg["block_len"])
        self.device = torch.device(device)
        (vfo,) = cfg["vfos"]
        self.name = vfo["name"]
        self.frontend = IQFrontend(
            self.samplerate,
            {self.name: VfoConfig(float(vfo["offset_hz"]), vfo["mode"],
                                  float(vfo["bandwidth_hz"]))},
            fft_size=int(cfg["fft_size"]), fft_rate=float(cfg["fft_rate"]),
            device=device)
        self.receiver = Receiver(self.frontend, block_len=self.block_len)
        self.deframer = self.receiver.deframers[self.name]
        v = self.frontend.vfos[self.name]
        self.max_out = v.out_len(self.block_len)
        self.if_len = v.ddc.out_len(self.block_len)
        self.outputs = {"syms": (2, self.max_out), "nsyms": (1,),
                        "frames": (MAX_FRAMES, CVCDU_BYTES),
                        "frame_pos": (MAX_FRAMES,), "nframes": (1,)}

    def init_state(self):
        self.deframer = type(self.deframer)(device=self.device)
        self.receiver.deframers[self.name] = self.deframer
        return self.frontend.init_state(), 0

    def call(self, entry: str, state, xs):
        """``xs`` (k, block_len) on the device -> (state, outputs)."""
        if entry != "call":
            raise ValueError(f"unknown entry {entry!r}")
        fe_state, seen = state
        rows = []
        for x in xs:
            with torch.inference_mode():
                fe_state, (outs, _) = self.frontend(fe_state, x)
            syms, count = outs[self.name]
            n = int(count)
            before = len(self.deframer.frames)
            new = self.deframer.process(syms[:n])
            pos = self.deframer.positions[before:]
            out = {"syms": torch.stack([syms.real, syms.imag]),
                   "nsyms": count.reshape(1).to(torch.float32),
                   "frames": torch.zeros((MAX_FRAMES, CVCDU_BYTES)),
                   "frame_pos": torch.zeros(MAX_FRAMES),
                   "nframes": torch.tensor([float(min(len(new),
                                                      MAX_FRAMES))])}
            for i, (f, p) in enumerate(list(zip(new, pos))[:MAX_FRAMES]):
                out["frames"][i] = torch.from_numpy(f.astype("float32"))
                out["frame_pos"][i] = float(p - seen)
            rows.append(out)
            seen += n
        return (fe_state, seen), {
            k: torch.stack([r[k].to(self.device) for r in rows])
            for k in rows[0]}

    def counters(self) -> dict:
        """The hand kernels' launch counters and the deframer's."""
        from sdrtpu_torch.fec.viterbi import viterbi_decode
        from sdrtpu_torch.kernels.clock import mm_scan
        from sdrtpu_torch.kernels.fir import decim_fir
        from sdrtpu_torch.kernels.loops import costas_scan

        out = {f"{f.__name__}.launches": getattr(f, "launches", None)
               for f in (costas_scan, mm_scan, viterbi_decode, decim_fir)}
        out.update({f"deframe.{k}": v
                    for k, v in self.deframer.counters.items()})
        return out

    def scan_shapes(self) -> dict:
        """What each scan launch works on: the Costas and M&M scans' input
        samples a block, M&M's samples a symbol, symbol slots and
        interpolator bank."""
        mm = self.frontend.vfos[self.name].radio.recov
        return {"if_len": self.if_len, "sps": mm.omega,
                "max_out": self.max_out, "mm_phases": mm.P, "mm_taps": mm.T}
