"""sdrtpu_torch's KG-STV decoder against sdrtpu's.

Tolerances: the frame layer (sync search, descrambling, K=7 Viterbi
with polys 0o155/0o117) gives equal bytes; the demodulator
(`Quadrature` -> RRC `Fir` -> float `MuellerMuller`), two streamed
blocks from one converted state: valid counts equal, hard decisions
equal, ``isclose(atol=2e-2)`` on more than 99.5 % of the soft symbols
(tests/test_torch_psk.py's thresholds for a closed loop); the whole
chain at the reference test's 4800 Hz: the same frames, payload-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdrtpu.decoders import kg_sstv as jk  # noqa: E402
from sdrtpu_torch.convert import state_from_jax  # noqa: E402
from sdrtpu_torch.decoders import kg_sstv as tk  # noqa: E402
from sdrtpu_torch.kernels import mod as tmod  # noqa: E402

RNG = np.random.default_rng(7)
FS = 4800.0


def _payloads(k):
    return [bytes(RNG.integers(0, 256, 6, dtype=np.uint8)) for _ in range(k)]


def _iq(payloads):
    """The reference test's signal, from the port's modulators: a random
    preamble, the frames, a tail; RRC-shaped at 4 samples a symbol, FM."""
    pre = (RNG.integers(0, 2, 120) * 2.0 - 1.0).astype(np.float32)
    syms = np.concatenate([pre] + [tk.encode_frame(p) for p in payloads]
                          + [pre[:60]])
    interp = tmod.RrcInterpolator(int(FS / tk.BAUDRATE), 31, tk.RRC_ALPHA,
                                  dtype=torch.float32, device="cpu")
    _, shaped = interp(interp.init_state(), torch.as_tensor(syms))
    mod = tmod.QuadratureMod(tk.DEVIATION, FS, device="cpu")
    return mod(mod.init_state(), shaped)[1].numpy()


def test_frame_encoder_and_constants_equal():
    for p in _payloads(3):
        np.testing.assert_array_equal(tk.encode_frame(p), jk.encode_frame(p))
    np.testing.assert_array_equal(tk.SYNC_WORD, jk.SYNC_WORD)
    np.testing.assert_array_equal(tk.SCRAMBLING, jk.SCRAMBLING)


def test_deframer_with_errors_equal():
    """Sync errors (4, the most allowed) and coded-symbol errors in
    uneven chunks: both deframers return the same frames."""
    payloads = _payloads(3)
    stream = [RNG.normal(0, 0.3, 40).astype(np.float32)]
    for p in payloads:
        f = tk.encode_frame(p) + RNG.normal(0, 0.1, 171).astype(np.float32)
        f[RNG.choice(63, 4, replace=False)] *= -1.0
        f[63 + RNG.choice(108, 5, replace=False)] *= -1.0
        stream += [f, RNG.normal(0, 0.3, 25).astype(np.float32)]
    full = np.concatenate(stream)
    td, jd = tk.KgSstvDeframer(device="cpu"), jk.KgSstvDeframer()
    got, want = [], []
    for chunk in np.array_split(full, 5):
        got += td.process(chunk)
        want += jd.process(chunk)
    assert got == want == payloads
    assert td.frames_seen == jd.frames_seen == 3


def test_demod_streams_like_the_reference():
    x = _iq(_payloads(2))
    jd, td = jk.KgSstvDemod(FS), tk.KgSstvDemod(FS, device="cpu")
    sj = jd.init_state()
    st = state_from_jax(sj, "cpu")
    half = len(x) // 2
    for blk in (x[:half], x[half:]):
        sj, (ys, yv) = jd(sj, jnp.asarray(blk))
        st, (ts, tv) = td(st, torch.as_tensor(blk))
        ys, yv = np.asarray(ys), np.asarray(yv)
        np.testing.assert_array_equal(tv.numpy(), yv)
        got, want = ts.numpy()[yv], ys[yv]
        np.testing.assert_array_equal(got > 0, want > 0)
        assert np.isclose(got, want, atol=2e-2).mean() > 0.995
    assert int(st["mm"]["offset"]) == int(sj["mm"]["offset"])


def test_iq_to_frames():
    payloads = _payloads(2)
    x = _iq(payloads)
    out = {}
    for name, dec in (("ref", jk.KgSstvDecoder(FS)),
                      ("port", tk.KgSstvDecoder(FS, device="cpu"))):
        got = []
        for chunk in np.array_split(x, 4):
            got += dec.process(chunk.copy())
        out[name] = got
    assert out["port"] == out["ref"] == payloads
