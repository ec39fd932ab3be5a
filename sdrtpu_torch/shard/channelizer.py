"""Multi-VFO channelizer (PyTorch counterpart of ``sdrtpu/shard/channelizer.py``).

The N VFOs are one more tensor axis.  Ported here:

- `MultiVfoMixer` (per-channel wrapped-phase rotator, with the
  closed-form K-block `rotate_blocks`);
- `FftDecimatorChain`, the dense alias-fold path: overlap-save chunks in
  polyphase layout from the CUDA kernel `chunk_poly`, a length-nif FFT
  batch, the fold against the host-built table ``G``, then ifft and trim;
  with ``sparse_thresh_db`` the sparse fold (nfft-point FFT of the
  chunks, a gather of each channel's live alias rows, an fp32 einsum);
- `ModulatedDecimatorChain`, the time-domain path: the mixer folded into
  per-channel modulated taps of each decimation stage
  (`correlate_valid_bank`), one residual rotator at the output rate;
- `Channelizer` with ``method`` "auto", "fft", "xla-fused", "xla" (the
  plain `MultiVfoMixer` + `RationalResampler`), "pallas" (stage 1 in
  the fused mix + decimate CUDA kernel K2, `FusedChannelizerStage`, then
  the remaining predecimation stages and the fractional tail) and "pfb"
  (the shared polyphase filter bank of `shard/pfb.py`, which produces
  the IF rate itself).

Offset-dependent tables (the fold table ``hf`` and the rotator tables)
live in the state on the device, so a retune is a host rebuild and a
table swap; phase carries are float32 as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .._precision import fp32_contractions
from ..graph.block import StreamOp
from ..kernels import taps as tapsmod
from ..kernels.chunks import chunk_poly
from ..kernels.fir import Fir, correlate_valid_bank
from ..kernels.fused_channelizer import FusedChannelizerStage
from ..kernels.resample import RationalResampler
from ..metrics import span

_TWO_PI = 2.0 * np.pi
_FINE = 1024

class MultiVfoMixer(StreamOp):
    """C-channel frequency translation: y[c] = x * exp(i*omega_c*n).

    Pass ``-f_c`` offsets to bring channels at +f_c to baseband.  The
    per-channel wrapped-phase tables (float64 on the host, stored float32)
    live in the state.
    """

    def __init__(self, offsets_hz, samplerate: float, block_len: int,
                 device="cuda"):
        self.device = resolve_device(device)
        offsets = np.asarray(offsets_hz, np.float64)
        self.n_channels = len(offsets)
        self.samplerate = float(samplerate)
        self.block_len = int(block_len)
        omega = _TWO_PI * offsets / samplerate
        n = self.block_len
        fine = min(_FINE, n)
        n_coarse = -(-n // fine)
        k_fine = np.arange(fine, dtype=np.float64)
        k_coarse = np.arange(n_coarse, dtype=np.float64) * fine
        self.offsets = offsets
        self._fine_t = np.mod(omega[:, None] * k_fine, _TWO_PI).astype(np.float32)
        self._coarse_t = np.mod(omega[:, None] * k_coarse, _TWO_PI).astype(np.float32)
        self._delta = np.mod(omega * n, _TWO_PI).astype(np.float32)

    def _tables(self) -> dict:
        def dev(a):
            return torch.as_tensor(a, device=self.device)

        return {"coarse": dev(self._coarse_t), "fine": dev(self._fine_t),
                "delta": dev(self._delta)}

    def init_state(self):
        return {"phase": torch.zeros(self.n_channels, dtype=torch.float32,
                                     device=self.device),
                **self._tables()}

    def retune_state(self, state, offsets_hz) -> dict:
        """New offset tables; the carried phase is kept (RxVFO::setOffset
        semantics).  The mixer's own tables follow the new offsets."""
        fresh = MultiVfoMixer(offsets_hz, self.samplerate, self.block_len,
                              device=self.device)
        assert fresh.n_channels == self.n_channels
        self.offsets = fresh.offsets
        self._fine_t = fresh._fine_t
        self._coarse_t = fresh._coarse_t
        self._delta = fresh._delta
        return {"phase": state["phase"], **self._tables()}

    def _angles(self, state):
        coarse, fine = state["coarse"], state["fine"]
        C = coarse.shape[0]
        return (coarse[:, :, None] + fine[:, None, :]).reshape(C, -1)[
            :, : self.block_len]

    def __call__(self, state, x):
        n = x.shape[-1]
        assert n == self.block_len, (
            f"MultiVfoMixer built for block_len={self.block_len}, got {n}")
        phase = state["phase"]
        angles = self._angles(state) + phase[:, None]
        rot = torch.complex(torch.cos(angles), torch.sin(angles))
        y = x * rot if x.ndim > 1 else x[None, :] * rot
        new_phase = torch.remainder(phase + state["delta"], _TWO_PI)
        return {**state, "phase": new_phase}, y

    def rotate_blocks(self, state, y, K: int):
        """Rotate K consecutive blocks ``y: (C, K*block_len)`` in one pass.

        Block j starts at phase + j*delta (mod 2pi), accumulated
        hierarchically (j = q*Q + r) in float32 exactly as the reference.
        """
        n = y.shape[-1]
        assert n == K * self.block_len, (n, K, self.block_len)
        phase, delta = state["phase"], state["delta"]
        angles = self._angles(state)
        C = angles.shape[0]
        Q = max(1, int(np.sqrt(K)))
        deltaQ = torch.remainder(delta * np.float32(Q), _TWO_PI)
        q = torch.arange(-(-K // Q), dtype=torch.float32, device=y.device)
        r = torch.arange(Q, dtype=torch.float32, device=y.device)
        ph = torch.remainder(
            phase[:, None, None]
            + deltaQ[:, None, None] * q[None, :, None]
            + delta[:, None, None] * r[None, None, :],
            _TWO_PI,
        ).reshape(C, -1)[:, :K]
        ang = angles[:, None, :] + ph[:, :, None]  # (C, K, n_blk)
        rot = torch.complex(torch.cos(ang), torch.sin(ang))
        out = (y.reshape(C, K, self.block_len) * rot).reshape(C, n)
        new_phase = torch.remainder(ph[:, K - 1] + delta, _TWO_PI)
        return {**state, "phase": new_phase}, out


class ModulatedDecimatorChain(StreamOp):
    """Fused mix + multistage decimation with modulated taps.

    With mixer phase ``w'_c = -2*pi*f_c/fs``, stage k's taps become
    ``h_k[t] e^{j w'_c R_k t}`` (R_k = decimation before it) applied to
    the stage input, and the leftover rotation is one `MultiVfoMixer` at
    the final rate, started at the group-delay phase
    ``-sum_k w'_c R_k (T_k - 1)``.  Stage 1 reads the shared wideband
    input, so its tail is C-independent; later tails are per channel.
    The modulated taps live in the state, so a retune is a table swap.
    """

    def __init__(self, offsets_hz, samplerate, stages, block_len,
                 device="cuda"):
        """``stages``: list of (taps, decimation) pairs, input rate order."""
        self.device = resolve_device(device)
        offsets = np.asarray(offsets_hz, np.float64)
        self.n_channels = len(offsets)
        omega_p = -_TWO_PI * offsets / float(samplerate)
        self.stage_plan: list[tuple[np.ndarray, int, int]] = []
        self._live: list[list[int]] = []
        phase0 = np.zeros(self.n_channels, np.float64)
        rate_mult = 1
        n = int(block_len)
        for taps, M in stages:
            taps = np.asarray(taps, np.float64)
            T, M = int(taps.shape[0]), int(M)
            t_idx = np.arange(T, dtype=np.float64)
            mod = taps[None, :] * np.exp(
                1j * np.mod(omega_p[:, None] * rate_mult * t_idx, _TWO_PI))
            self.stage_plan.append((mod.astype(np.complex64), M, T))
            # |h e^{jwt}| = |h|: the zero columns do not move on a retune
            self._live.append([t for t in range(T) if taps[t] != 0.0])
            phase0 -= omega_p * rate_mult * (T - 1)
            rate_mult *= M
            assert n % M == 0, (n, M)
            n //= M
        self.ratio = rate_mult
        self.block_len = int(block_len)
        self.rot = MultiVfoMixer(-offsets, samplerate / rate_mult, n,
                                 device=self.device)
        self._phase0 = np.mod(phase0, _TWO_PI).astype(np.float32)

    def init_state(self):
        def dev(a):
            return torch.as_tensor(a, device=self.device)

        rot = self.rot.init_state()
        rot["phase"] = dev(self._phase0.copy())
        tails = [torch.zeros(self.stage_plan[0][2] - 1, dtype=torch.complex64,
                             device=self.device)]
        for _, _, T in self.stage_plan[1:]:
            tails.append(torch.zeros((self.n_channels, T - 1),
                                     dtype=torch.complex64,
                                     device=self.device))
        return {"tails": tuple(tails),
                "taps": tuple(dev(mod) for mod, _, _ in self.stage_plan),
                "rot": rot}

    def retune_state(self, state, offsets_hz, samplerate: float,
                     stages) -> dict:
        """Swap the modulated taps and rotator tables; keep the tails.
        Each channel's accumulated rotator phase is carried in float32
        (minus the old group-delay constant, plus the new)."""
        fresh = ModulatedDecimatorChain(offsets_hz, samplerate, stages,
                                        self.block_len, device=self.device)
        assert fresh.ratio == self.ratio and len(fresh.stage_plan) == len(
            self.stage_plan), "retune changed the stage plan; rebuild instead"
        new = fresh.init_state()
        new["tails"] = state["tails"]
        phase = state["rot"]["phase"].to(torch.float32)
        new["rot"]["phase"] = torch.remainder(
            phase - torch.as_tensor(self._phase0, device=phase.device)
            + torch.as_tensor(fresh._phase0, device=phase.device),
            _TWO_PI)
        self.stage_plan = fresh.stage_plan
        self._live = fresh._live
        self._phase0 = fresh._phase0
        self.rot = fresh.rot
        return new

    def out_len(self, n: int) -> int:
        return n // self.ratio

    def __call__(self, state, x):
        y = x.to(torch.complex64)
        new_tails = []
        for (_, M, _), tail, taps_mod, live in zip(
                self.stage_plan, state["tails"], state["taps"], self._live):
            n = y.shape[-1]
            ext = torch.cat([tail, y], dim=-1)
            new_tails.append(ext[..., n:])
            y = correlate_valid_bank(ext, taps_mod, stride=M, live=live)
        st_rot, y = self.rot(state["rot"], y)
        return {"tails": tuple(new_tails), "taps": state["taps"],
                "rot": st_rot}, y


def ModulatedDecimatorStage(offsets_hz, samplerate, taps, decimation,
                            block_len, device="cuda"):
    """Single-stage `ModulatedDecimatorChain`."""
    return ModulatedDecimatorChain(offsets_hz, samplerate,
                                   [(taps, decimation)], block_len,
                                   device=device)


def _cascade_equivalent_taps(stages) -> np.ndarray:
    """Collapse a decimating-FIR cascade into one full-rate filter (noble
    identity), float64 host math."""
    h = np.asarray(stages[0][0], np.float64)
    rate_mult = int(stages[0][1])
    for taps, M in stages[1:]:
        taps = np.asarray(taps, np.float64)
        up = np.zeros((len(taps) - 1) * rate_mult + 1, np.float64)
        up[::rate_mult] = taps
        h = np.convolve(h, up)
        rate_mult *= int(M)
    return h


def _plan_fft_chunks(block_len: int, R: int, t_eq: int,
                     n_channels: int = 1) -> tuple[int, int]:
    """Pick (valid, nfft) for chunked overlap-save decimation.

    The reference's plan, kept identical so both packages build the same
    chunks and fold table: valid divides block_len, valid % R == 0,
    nfft = R * 2^a * 5^b >= valid + t_eq - 1, minimizing its cost model
    (FFT flops + fold MACs + filter-table bytes).  The model's weights
    were fitted on a TPU and are not measured on the card.
    """
    nice = sorted(
        R * (2 ** a) * (5 ** b)
        for a in range(1, 28)
        for b in range(0, 7)
        if R * (2 ** a) * (5 ** b) <= 2 ** 24
    )
    C = max(1, int(n_channels))
    best = None
    v = R
    while v <= block_len:
        if block_len % v == 0:
            need = v + t_eq - 1
            for nfft in nice:
                if nfft >= need:
                    P = block_len // v
                    fft = 5.0 * P * nfft * np.log2(nfft)
                    fold = 8.0 * C * P * nfft * (128.0 / min(P, 128))
                    table = 200.0 * C * nfft
                    cost = fft + fold + table
                    if best is None or cost < best[0]:
                        best = (cost, v, nfft)
                    break
        v += R
    if best is None:
        raise ValueError(
            f"no FFT chunk plan for block_len={block_len}, R={R}, T={t_eq}")
    return best[1], best[2]


class FftDecimatorChain(StreamOp):
    """Fused mix + decimate in the frequency domain (overlap-save).

    Per-channel modulated taps act on the shared wideband input as one
    equivalent full-rate filter (`_cascade_equivalent_taps`); with
    ``ext = [tail ++ x]`` and P chunks per window:

        ct = chunk_poly(ext)              (P, R, nif)  CUDA kernel K1
        F  = fft_nif(ct)                  polyphase-split forward FFT
        S  = einsum("psk,csk->cpk", F, G) alias fold (outer FFT stage in G)
        y  = ifft(S)[:, :, m0 : m0 + valid/R]

    then the residual rotator at the decimated rate, unless
    ``skip_rotator`` hands it to the FM discriminator (`residual_omega`).

    ``sparse_thresh_db`` (opt-in, as the reference): each channel's
    filter spectrum is a narrow lowpass shifted to its offset, so of the
    R alias rows only those whose peak is within ``sparse_thresh_db`` of
    the global peak are kept, chosen per channel on the host.  The state
    then carries the ``(C, Rk, nif)`` table ``hf`` of those rows and
    their indices ``fold_idx`` ``(C, Rk)`` (a channel with fewer live
    rows pads with row 0 and zero taps), and a window runs the nfft-point
    FFT of the chunks, a gather of each channel's rows and a float32
    einsum.  When some channel keeps more than R // 2 rows the dense fold
    is used instead.
    """

    def __init__(self, offsets_hz, samplerate, stages, block_len,
                 skip_rotator=False, sparse_thresh_db: float | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        offsets = np.asarray(offsets_hz, np.float64)
        self.n_channels = len(offsets)
        omega_p = -_TWO_PI * offsets / float(samplerate)
        h_eq = _cascade_equivalent_taps(stages)
        t_eq = len(h_eq)
        R = 1
        for _, M in stages:
            R *= int(M)
        self.ratio = R
        n = int(block_len)
        assert n % R == 0, (n, R)
        self.block_len = n
        valid, nfft = _plan_fft_chunks(n, R, t_eq, self.n_channels)
        self.valid, self.nfft = valid, nfft
        self.tpad = nfft - valid + 1
        self.n_chunks = n // valid
        self.nif = nfft // R
        h_pad = np.zeros(self.tpad, np.float64)
        h_pad[self.tpad - t_eq:] = h_eq
        t_idx = np.arange(self.tpad, dtype=np.float64)
        hm = h_pad[None, :] * np.exp(
            1j * np.mod(omega_p[:, None] * t_idx, _TWO_PI))  # (C, Tpad)
        hf = np.fft.fft(hm[:, ::-1], nfft, axis=-1)  # (C, nfft)
        self._sparse_thresh = sparse_thresh_db
        self._sparse = False
        if sparse_thresh_db is not None:
            folded = np.ascontiguousarray(
                hf.reshape(self.n_channels, R, self.nif)).astype(np.complex64)
            rowmax = np.abs(folded).max(axis=2)  # (C, R)
            thresh = rowmax.max() * 10.0 ** (sparse_thresh_db / 20.0)
            keep = rowmax > thresh
            rk = int(keep.sum(axis=1).max())
            self._sparse = 0 < rk <= R // 2
        if self._sparse:
            self.rk = rk
            idx = np.zeros((self.n_channels, rk), np.int32)
            hs = np.zeros((self.n_channels, rk, self.nif), np.complex64)
            for c in range(self.n_channels):
                rows = np.flatnonzero(keep[c])
                idx[c, : len(rows)] = rows
                hs[c, : len(rows)] = folded[c, rows]
            self._fold_idx = idx
            self._hf_sparse = hs
        else:
            # Polyphase-split forward transform: n = q*R + s, so only
            # length-nif FFTs run; the outer Cooley-Tukey stage and 1/R
            # fold into G[c,s,k] = (1/R) e^{-2pi i s k/nfft}
            # DFT_R(hf[c,:,k])[s].
            s_idx = np.arange(R, dtype=np.float64)
            k_idx = np.arange(self.nif, dtype=np.float64)
            tw = np.exp(-2j * np.pi * np.outer(s_idx, k_idx) / nfft)
            G = np.fft.fft(hf.reshape(self.n_channels, R, self.nif), axis=1)
            self._g_folded = np.ascontiguousarray(
                G * tw[None, :, :] / R).astype(np.complex64)
        self.rot = MultiVfoMixer(-offsets, samplerate / R, n // R,
                                 device=self.device)
        # taps modulated over the PADDED index: the rotator phase cancels
        # the constant e^{j w' (tpad - t_eq)} with phase0 = -w'(tpad-1)
        self._phase0 = np.mod(-omega_p * (self.tpad - 1), _TWO_PI).astype(
            np.float32)
        self.skip_rotator = bool(skip_rotator)
        self.residual_omega = np.mod(
            -_TWO_PI * offsets * R / float(samplerate), _TWO_PI
        ).astype(np.float32)

    def init_state(self):
        rot = self.rot.init_state()
        rot["phase"] = torch.as_tensor(self._phase0.copy(), device=self.device)
        st = {
            "tail": torch.zeros(self.tpad - 1, dtype=torch.complex64,
                                device=self.device),
            "rot": rot,
        }
        if self._sparse:
            st["hf"] = torch.as_tensor(self._hf_sparse, device=self.device)
            st["fold_idx"] = torch.as_tensor(self._fold_idx,
                                             device=self.device)
        else:
            st["hf"] = torch.as_tensor(self._g_folded, device=self.device)
        return st

    def retune_state(self, state, offsets_hz, samplerate: float,
                     stages) -> dict:
        """Swap the offset-dependent tables (fold table, rotator tables);
        keep the wideband tail.  Each channel's accumulated rotator phase
        is carried over in float32 (minus the old group-delay constant,
        plus the new), so unmoved channels see no phase step.  With the
        sparse fold, offsets whose live-row layout differs (sparse on or
        off, another row count) raise ValueError: rebuild the chain."""
        fresh = FftDecimatorChain(offsets_hz, samplerate, stages,
                                  self.block_len,
                                  skip_rotator=self.skip_rotator,
                                  sparse_thresh_db=self._sparse_thresh,
                                  device=self.device)
        assert fresh.nfft == self.nfft and fresh.ratio == self.ratio, (
            "retune changed the FFT plan; rebuild the chain instead")
        if fresh._sparse != self._sparse or (
                self._sparse and fresh.rk != self.rk):
            # the live rows follow the offsets; another row count changes
            # the state's shapes
            raise ValueError(
                "retune changed the sparse-fold layout; rebuild the chain")
        new = fresh.init_state()
        new["tail"] = state["tail"]
        phase = state["rot"]["phase"].to(torch.float32)
        new["rot"]["phase"] = torch.remainder(
            phase - torch.as_tensor(self._phase0, device=phase.device)
            + torch.as_tensor(fresh._phase0, device=phase.device),
            _TWO_PI,
        )
        for attr in ("_g_folded", "_hf_sparse", "_fold_idx"):
            if hasattr(fresh, attr):
                setattr(self, attr, getattr(fresh, attr))
        self._phase0 = fresh._phase0
        self.rot = fresh.rot
        self.residual_omega = fresh.residual_omega
        return new

    def out_len(self, n: int) -> int:
        return n // self.ratio

    def chunk_matrix(self, ext: torch.Tensor, P: int) -> torch.Tensor:
        """Overlap-save chunks (P, nfft), chunk p = ext[p*valid : p*valid
        + nfft] (zeros past the end of ``ext``): K1's polyphase layout
        read back in sample order, so it runs `chunk_poly` (the kernel on
        the card, its plain version on the CPU)."""
        ct = chunk_poly(ext.to(torch.complex64).contiguous(), self.valid,
                        self.ratio, self.nif, P)  # (P, R, nif)
        return ct.transpose(1, 2).reshape(P, self.nfft)

    def poly_spectrum(self, chunks: torch.Tensor) -> torch.Tensor:
        """Polyphase-split forward transform: (P, nfft) -> (P, R, nif), a
        length-nif FFT batch over the chunk polyphase components (the
        outer Cooley-Tukey stage lives in the fold table G)."""
        P = chunks.shape[0]
        cp = chunks.reshape(P, self.nif, self.ratio)
        return torch.fft.fft(cp.transpose(-1, -2))

    def __call__(self, state, x):
        n = x.shape[-1]
        assert n % self.block_len == 0, (n, self.block_len)
        K = n // self.block_len
        assert x.ndim == 1, "FFT channelizer front takes the shared wideband"
        ext = torch.cat([state["tail"], x.to(torch.complex64)])
        new_tail = ext[n:].clone()
        # any multiple of block_len runs as one window: P scales with K
        P = K * self.n_chunks
        if self._sparse:
            # chunk p = ext[p*valid : p*valid + nfft]; its nfft-point
            # spectrum as (R, nif) alias rows, each channel's gathered
            X = torch.fft.fft(ext.unfold(0, self.nfft, self.valid))
            Xg = X.reshape(P, self.ratio, self.nif)[
                :, state["fold_idx"].long(), :]  # (P, C, Rk, nif)
            with fp32_contractions():
                S = torch.einsum("pcrk,crk->cpk", Xg,
                                 state["hf"]) / self.ratio
        else:
            ct = chunk_poly(ext, self.valid, self.ratio, self.nif, P)
            Fp = torch.fft.fft(ct)  # (P, R, nif)
            with fp32_contractions():
                S = torch.einsum("psk,csk->cpk", Fp, state["hf"])
        y = torch.fft.ifft(S)  # (C, P, nif)
        m0 = (self.tpad - 1) // self.ratio
        y = y[:, :, m0 : m0 + self.valid // self.ratio]
        y = y.reshape(y.shape[0], n // self.ratio)
        if self.skip_rotator:
            st_rot = state["rot"]
        elif K == 1:
            st_rot, y = self.rot(state["rot"], y)
        else:
            st_rot, y = self.rot.rotate_blocks(state["rot"], y, K)
        new_state = {"tail": new_tail, "rot": st_rot, "hf": state["hf"]}
        if self._sparse:
            new_state["fold_idx"] = state["fold_idx"]
        return new_state, y


def _pallas_eligible(resampler: RationalResampler) -> bool:
    """Stage 1 fits K2: decimation 2, 4 or 8 and at most M + 32 taps."""
    if resampler.predecim is None or not resampler.predecim.stages:
        return False
    s0 = resampler.predecim.stages[0]
    return s0.decimation in (2, 4, 8) and s0.ntaps <= s0.decimation + 32


class Channelizer(StreamOp):
    """N simultaneous VFOs at one output rate: a front end, the
    resampler's fractional tail if any, and an optional channel lowpass.

    ``method`` (as the reference):

    - "fft": `FftDecimatorChain` (any multiple of ``block_len`` per call);
    - "xla-fused": `ModulatedDecimatorChain` over every predecimation stage;
    - "pallas": stage 1 in `FusedChannelizerStage` (kernel K2), then the
      remaining predecimation stages (per-channel tails in ``"rest"``);
    - "xla": `MultiVfoMixer` then the whole `RationalResampler`;
    - "pfb": `PfbChannelizer`, a shared M-bin filter bank, its bin-rate
      rotator and its own resampler to the IF rate (no rest stages, no
      fractional tail);
    - "auto": "fft" when a chunk plan exists, else "xla-fused"; "xla"
      without integer predecimation.

    "fft" and "pfb" take any whole number of blocks per call, the others
    exactly one.
    """

    def __init__(self, offsets_hz, in_samplerate: float,
                 out_samplerate: float, block_len: int,
                 low_pass_bw: float | None = None, method: str = "auto",
                 sparse_thresh_db: float | None = None,
                 skip_rotator: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.offsets = np.asarray(offsets_hz, np.float64)
        self.skip_rotator = bool(skip_rotator)
        self.resampler = RationalResampler(in_samplerate, out_samplerate,
                                           device=self.device)
        assert block_len % self.resampler.block_multiple() == 0, (
            f"block_len {block_len} not a multiple of "
            f"{self.resampler.block_multiple()}")
        self.n_channels = len(self.offsets)
        self.block_len = int(block_len)
        if method == "pallas-interpret":
            raise ValueError(
                "'pallas-interpret' runs the TPU kernel in interpret mode; "
                "pass method='pallas' with device='cpu' for the plain "
                "PyTorch version")
        if method not in ("auto", "fft", "xla-fused", "xla", "pallas", "pfb"):
            raise ValueError(f"unknown channelizer method {method!r}")
        pre = self.resampler.predecim
        has_predecim = pre is not None and len(pre.stages) > 0
        if method == "auto":
            if has_predecim:
                try:
                    _plan_fft_chunks(self.block_len, pre.ratio, len(
                        _cascade_equivalent_taps(self._stages())))
                    method = "fft"
                except ValueError:
                    method = "xla-fused"
            else:
                method = "xla"
        if method == "pallas" and not _pallas_eligible(self.resampler):
            raise ValueError("resampler plan not eligible for the fused kernel")
        if method in ("xla-fused", "fft") and not has_predecim:
            method = "xla"
        self.method = method
        if self.skip_rotator and method != "fft":
            raise ValueError(
                "skip_rotator is only supported on the fft channelizer "
                f"(resolved method: {method})")
        # Stricter than the reference: the residual carrier that
        # skip_rotator leaves in the IF would push the channel out of a
        # baseband-centered lowpass or fractional resampler downstream,
        # and residual_omega only holds at the fused chain's output rate.
        if self.skip_rotator and (low_pass_bw is not None
                                  or self.resampler.resamp is not None):
            raise ValueError(
                "skip_rotator needs an integer in->IF ratio and no "
                "low_pass_bw (the IF is left un-derotated)")
        self.rest_stages = []
        self.fused = self.mixer = None
        # "pfb" produces the IF rate itself: no generic fractional tail
        self._fused_complete = method == "pfb"
        if method == "pfb":
            from .pfb import PfbChannelizer

            self.fused = PfbChannelizer(self.offsets, in_samplerate,
                                        out_samplerate, block_len,
                                        device=self.device)
        elif method == "fft":
            self.fused = FftDecimatorChain(
                self.offsets, in_samplerate, self._stages(), block_len,
                skip_rotator=self.skip_rotator,
                sparse_thresh_db=sparse_thresh_db, device=self.device)
        elif method == "xla-fused":
            self.fused = ModulatedDecimatorChain(
                self.offsets, in_samplerate, self._stages(), block_len,
                device=self.device)
        elif method == "pallas":
            s0 = pre.stages[0]
            self.fused = FusedChannelizerStage(
                self.offsets, in_samplerate, np.asarray(s0.taps),
                s0.decimation, block_len, device=self.device)
            self.rest_stages = pre.stages[1:]
        else:
            self.mixer = MultiVfoMixer(-self.offsets, in_samplerate,
                                       block_len, device=self.device)
        if low_pass_bw is not None:
            self.lpf = Fir(
                tapsmod.low_pass(low_pass_bw / 2.0, low_pass_bw * 0.05,
                                 out_samplerate),
                dtype=torch.complex64, device=self.device)
        else:
            self.lpf = None

    def _stages(self):
        return [(np.asarray(s.taps), s.decimation)
                for s in self.resampler.predecim.stages]

    def init_state(self):
        st = {"lpf": self.lpf.init_state() if self.lpf else ()}
        if self.fused is None:
            st["mixer"] = self.mixer.init_state()
            st["resamp"] = self.resampler.init_state()
            return st
        st["fused"] = self.fused.init_state()
        st["rest"] = tuple(
            torch.zeros((self.n_channels, s.ntaps - 1),
                        dtype=torch.complex64, device=self.device)
            for s in self.rest_stages)
        st["poly"] = (self.resampler.resamp.init_state()
                      if self.resampler.resamp and not self._fused_complete
                      else ())
        return st

    def out_len(self, n: int) -> int:
        return self.resampler.out_len(n)

    def retune_state(self, state, offsets_hz) -> dict:
        """Move all VFO offsets by a table swap (pfb: the bins and the
        rotator's tables; fft, xla-fused: the chain's ``retune_state``;
        xla: the mixer's), keeping every carried tail.  The pallas stage
        keeps its tables out of the state and is rebuilt instead, as in
        the reference."""
        offsets = np.asarray(offsets_hz, np.float64)
        assert offsets.shape == self.offsets.shape
        st = dict(state)
        if self.method == "pfb":
            st["fused"] = self.fused.retune_state(state["fused"], offsets)
        elif self.method in ("fft", "xla-fused"):
            st["fused"] = self.fused.retune_state(
                state["fused"], offsets, self.resampler.in_samplerate,
                self._stages())
        elif self.method == "xla":
            st["mixer"] = self.mixer.retune_state(state["mixer"], -offsets)
        else:
            raise NotImplementedError(
                f"state-swap retune not supported for the opt-in "
                f"{self.method} channelizer; rebuild instead")
        self.offsets = offsets
        return st

    def __call__(self, state, x):
        with span("sdrtpu.channelizer"):
            st = dict(state)
            if self.fused is None:
                st["mixer"], y = self.mixer(state["mixer"], x)  # (C, n)
                st["resamp"], y = self.resampler(state["resamp"], y)
            else:
                st["fused"], y = self.fused(state["fused"], x)  # (C, n/M1)
                new_rest = []
                for s, rst in zip(self.rest_stages, state["rest"]):
                    rst, y = s(rst, y)
                    new_rest.append(rst)
                st["rest"] = tuple(new_rest)
                if (self.resampler.resamp is not None
                        and not self._fused_complete):
                    st["poly"], y = self.resampler.resamp(state["poly"], y)
            if self.lpf:
                st["lpf"], y = self.lpf(state["lpf"], y)
            return st, y
