"""sdrtpu_torch's receiver (`IQFrontend`, `Vfo`, `Receiver`, the CLI)
against sdrtpu's, and its own invariants (both on the CPU).

Tolerance against the reference: 2e-4 of the peak (at least of 1.0) on
every VFO's audio, as `tests/test_torch_radio.py`; waterfall amplitudes
within 2e-5 of the frame's peak; the CLI's int16 WAVs within 3e-4
(2e-4 plus one quantisation step).  Batched against single dispatch,
asynchronous against synchronous delivery and checkpoint resume are held
bit-exact: the port runs the same eager calls in each.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import cli as jcli  # noqa: E402
from sdrtpu.apps import receiver as jrx  # noqa: E402
from sdrtpu.graph.compile import to_numpy  # noqa: E402
from sdrtpu.io import wav as jwav  # noqa: E402
from sdrtpu_torch.apps import cli as tcli  # noqa: E402
from sdrtpu_torch.apps import receiver as trx  # noqa: E402
from sdrtpu_torch.convert import state_from_jax, state_to_numpy  # noqa: E402
from sdrtpu_torch.graph.checkpoint import tree_flatten as flatten  # noqa: E402
from sdrtpu_torch.io import wav as twav  # noqa: E402

FS = 1_000_000.0
REL = 2e-4


def _station(mode, fs, n, offset, seed):
    """One tone-modulated station of ``mode`` at ``offset`` Hz."""
    t = np.arange(n) / fs
    f_a = 500.0 + 100.0 * seed
    if mode == "wfm":
        left = np.sin(2 * np.pi * f_a * t)
        right = np.sin(2 * np.pi * (f_a + 500.0) * t)
        mpx = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.45 * (left - right) * np.sin(2 * np.pi * 38000 * t))
        base = np.exp(1j * np.cumsum(2 * np.pi * 75000.0 * mpx / fs))
    elif mode == "nfm":
        base = np.exp(1j * np.cumsum(
            2 * np.pi * 2500.0 * np.sin(2 * np.pi * f_a * t) / fs))
    elif mode == "am":
        base = 1.0 + 0.5 * np.sin(2 * np.pi * f_a * t)
    elif mode in ("usb", "dsb", "raw"):
        base = np.exp(2j * np.pi * f_a * t)
    elif mode == "lsb":
        base = np.exp(-2j * np.pi * f_a * t)
    else:  # cw
        base = np.exp(2j * np.pi * 20.0 * t)
    return 0.1 * base * np.exp(2j * np.pi * offset * t)


def _capture(vfos, fs, n, seed=0):
    rng = np.random.default_rng(40 + seed)
    x = 1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for i, cfg in enumerate(vfos.values()):
        x = x + _station(cfg.mode, fs, n, cfg.offset_hz, i)
    return x.astype(np.complex64)


def _cfgs(mod, spec):
    return {name: mod.VfoConfig(off, mode) for name, (off, mode)
            in spec.items()}


def _collect(names):
    bufs = {n: [] for n in names}
    return bufs, {n: bufs[n].append for n in names}


def _cat(bufs):
    return {n: np.concatenate(v, axis=-1) for n, v in bufs.items()}


def _hold(got, want, skip=0):
    """``skip`` audio samples at the head of the stream are left out:
    while the channel filters fill from their zero state the pilot is
    rounding noise, and ``p/|p|`` of that is arbitrary in both packages
    (the first 2 ms of a WFM VFO behind the fft channelizer)."""
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(
            got[name][..., skip:], want[name][..., skip:],
            atol=REL * max(np.abs(want[name]).max(), 1.0), err_msg=name)


def _port(spec, block_len, fs=FS, sinks=True, **kw):
    rx_kw = {k: kw.pop(k) for k in ("scan_batch", "async_fetch",
                                    "spectrum_sink", "baseband_sinks")
             if k in kw}
    fe = trx.IQFrontend(fs, _cfgs(trx, spec), fft_size=1024,
                        fft_rate=FFT_RATE, device="cpu", **kw)
    bufs, audio_sinks = _collect(spec)
    rx = trx.Receiver(fe, block_len=block_len,
                      audio_sinks=audio_sinks if sinks else None, **rx_kw)
    return rx, bufs


PER_VFO = {"w": (150e3, "wfm"), "a": (-60e3, "am"), "u": (40e3, "usb")}
FUSED = {"w1": (200e3, "wfm"), "w2": (-250e3, "wfm"), "n": (50e3, "nfm"),
         "a": (-60e3, "am")}
BLOCK = 96_000   # a multiple of every chain's quantum at FFT_RATE
FFT_RATE = 125.0  # waterfall interval 8000 samples at 1 Msps


def test_per_vfo_frontend_matches_reference_with_flush():
    """Predecimation, DC block, waterfall, three per-VFO chains; the tail
    of the stream (0.3 of a block) is padded and the output trimmed."""
    n = 2 * BLOCK + 30_000  # at the decimated rate
    kw = dict(dc_block=True, decimation=2, fuse=False)
    x = _capture(_cfgs(trx, PER_VFO), FS / 2, n) + np.complex64(0.05)
    # made at the decimated rate, then held for two samples each: the
    # stations stay at their offsets in the decimated band
    x = np.repeat(x, 2)[: 2 * n].astype(np.complex64)
    spec_j, spec_t = [], []
    bufs_j, sinks_j = _collect(PER_VFO)
    fe_j = jrx.IQFrontend(FS, _cfgs(jrx, PER_VFO), fft_size=1024,
                          fft_rate=FFT_RATE, **kw)
    rx_j = jrx.Receiver(fe_j, block_len=2 * BLOCK, audio_sinks=sinks_j,
                        spectrum_sink=spec_j.append)
    rx_t, bufs_t = _port(PER_VFO, 2 * BLOCK, spectrum_sink=spec_t.append,
                         **kw)
    assert rx_t.frontend.block_multiple() == fe_j.block_multiple()
    assert not rx_t.frontend._groups
    for rx in (rx_j, rx_t):
        rx.push(x[: 3 * BLOCK])
        rx.push(x[3 * BLOCK:])
        rx.flush()
    got, want = _cat(bufs_t), _cat(bufs_j)
    _hold(got, want)
    # 2.3 blocks of input -> 2.3 blocks of audio, the padding trimmed
    assert got["w"].shape == (2, round(2 * n * 48000 / FS))
    sj, st = np.concatenate(spec_j), np.concatenate(spec_t)
    assert st.shape == sj.shape
    # held in amplitude, at 2e-5 of the frame's peak (-94 dB): the DC blocker
    # ahead of the waterfall sums its recurrence in another order, which
    # moves the slow offset estimate by ~1e-5 of the DC line and so the weak bins by
    # more than the 0.02 dB that holds without it
    amp_j, amp_t = 10.0 ** (sj / 20.0), 10.0 ** (st / 20.0)
    assert np.abs(amp_t - amp_j).max() <= 2e-5 * amp_j.max()
    assert np.array_equal(st.argmax(axis=-1), sj.argmax(axis=-1))


def test_fused_frontend_matches_reference_with_retunes_and_state():
    """Two wfm VFOs fuse into one fft channelizer; nfm and am stay
    per-VFO.  A grouped and a per-VFO channel are retuned in mid stream
    on both sides; then the reference's whole state goes through
    ``convert`` into the port, and both run on."""
    n = 4 * BLOCK
    cfgs = _cfgs(trx, FUSED)
    x = _capture(cfgs, FS, n)
    # after the retunes the stations are where the VFOs went
    moved = dict(FUSED, w2=(-300e3, "wfm"), a=(-100e3, "am"))
    x[2 * BLOCK:] = _capture(_cfgs(trx, moved), FS, n, seed=1)[2 * BLOCK:]
    bufs_j, sinks_j = _collect(FUSED)
    fe_j = jrx.IQFrontend(FS, _cfgs(jrx, FUSED), fft_size=1024,
                          fft_rate=FFT_RATE)
    rx_j = jrx.Receiver(fe_j, block_len=BLOCK, audio_sinks=sinks_j)
    rx_t, bufs_t = _port(FUSED, BLOCK)
    groups = rx_t.frontend._groups
    assert list(groups) == [250000.0]
    assert groups[250000.0][0] == ["w1", "w2"]
    assert groups[250000.0][1].method == fe_j._groups[250000.0][1].method
    for rx in (rx_j, rx_t):
        rx.push(x[: 2 * BLOCK])
        rx.retune("w2", -300e3)
        rx.retune("a", -100e3)
        rx.push(x[2 * BLOCK: 3 * BLOCK])
    _hold(_cat(bufs_t), _cat(bufs_j), skip=200)
    assert rx_t.frontend.vfos["w2"].cfg.offset_hz == -300e3
    with pytest.raises(KeyError):
        rx_t.retune("nope", 0.0)

    # the reference's state, planar (re, im) pairs and all, into the port
    handed = state_from_jax(rx_j._rstate, "cpu")
    mine = rx_t._state
    (flat_h, shape_h), (flat_m, shape_m) = flatten(handed), flatten(mine)
    assert shape_h == shape_m and len(flat_h) == len(flat_m) > 40
    for a, b in zip(flat_h, flat_m):
        assert a.dtype == b.dtype and a.shape == b.shape
    back = to_numpy(rx_j._rstate)
    again = state_to_numpy(handed)
    for a, b in zip(flatten(again)[0], flatten(back)[0]):
        np.testing.assert_array_equal(a, np.asarray(b))
    rx_t._state = handed
    for bufs in (bufs_j, bufs_t):
        for v in bufs.values():
            v.clear()
    for rx in (rx_j, rx_t):
        rx.push(x[3 * BLOCK:])
    _hold(_cat(bufs_t), _cat(bufs_j))


def test_batched_dispatch_equals_single():
    x = _capture(_cfgs(trx, FUSED), FS, 6 * BLOCK)
    spec1, spec4 = [], []
    rx1, b1 = _port(FUSED, BLOCK, spectrum_sink=spec1.append)
    rx4, b4 = _port(FUSED, BLOCK, scan_batch=4, spectrum_sink=spec4.append)
    raw = []
    rx4.baseband_sinks.append(raw.append)
    rx1.push(x)
    rx4.push(x[:150_001])
    rx4.push(x[150_001:])
    assert len(rx4._pending) == 1  # 1 single + 4 batched, one waiting
    rx4.drain()
    got, want = _cat(b4), _cat(b1)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(np.concatenate(spec4),
                                  np.concatenate(spec1))
    np.testing.assert_array_equal(np.concatenate(raw), x)


def test_set_mode_switches_and_caches():
    spec = {"w1": (200e3, "wfm"), "w2": (-250e3, "wfm"), "v": (50e3, "am")}
    x = _capture(_cfgs(trx, spec), FS, 3 * BLOCK)
    rx, bufs = _port(spec, BLOCK)
    rx.push(x[:BLOCK])
    am = rx.frontend.vfos["v"]
    assert rx.set_mode("v", "nfm") > 0.0
    nfm = rx.frontend.vfos["v"]
    assert nfm.radio.mode == "nfm" and nfm.cfg.offset_hz == 50e3
    assert isinstance(nfm.xlator, trx.TunableXlator)
    rx.push(x[BLOCK: 2 * BLOCK])
    rx.retune("v", 60e3)
    rx.set_mode("v", "am")
    assert rx.frontend.vfos["v"] is am          # the cached chain
    assert am.cfg.offset_hz == 60e3             # at the VFO's new offset
    rx.push(x[2 * BLOCK:])
    # the switched VFO restarts from a fresh state at the switch: a
    # receiver built in that mode gives the same audio for that block
    fresh, fb = _port({"v": (50e3, "nfm")}, BLOCK)
    fresh.push(x[BLOCK: 2 * BLOCK])
    np.testing.assert_array_equal(bufs["v"][1], fb["v"][0])
    assert [a.shape for a in bufs["v"]] == [(2, BLOCK * 48 // 1000)] * 3
    with pytest.raises(NotImplementedError, match="fused-group"):
        rx.set_mode("w1", "nfm")
    with pytest.raises(KeyError):
        rx.set_mode("nope", "am")


def test_mode_cache_is_a_bounded_lru():
    """A control surface sweeping bandwidths cannot grow the cache."""
    rx, _ = _port({"v": (0.0, "am")}, 20_000, fs=100_000.0, spectrum=False)
    for i in range(rx.MODE_CACHE_SIZE + 4):
        rx.set_mode("v", "am", bandwidth=5000.0 + 100.0 * i)
    assert len(rx._mode_programs) == rx.MODE_CACHE_SIZE
    keys = list(rx._mode_programs)
    assert keys[-1] == ("v", "am", 5000.0 + 100.0 * (rx.MODE_CACHE_SIZE + 3))
    assert ("v", "am", None) not in rx._mode_programs  # the oldest went


def test_checkpoint_resume_is_bit_exact(tmp_path):
    x = _capture(_cfgs(trx, FUSED), FS, 4 * BLOCK + 777)
    whole, bw = _port(FUSED, BLOCK)
    whole.push(x)
    first, b1 = _port(FUSED, BLOCK)
    first.push(x[: 2 * BLOCK + 5000])       # 5000 samples wait in the framer
    path = str(tmp_path / "rx.ckpt")
    first.save_checkpoint(path)
    second, b2 = _port(FUSED, BLOCK)
    second.load_checkpoint(path)
    assert second.framer.pending == 5000
    second.push(x[2 * BLOCK + 5000:])
    want = _cat(bw)
    for name in want:
        got = np.concatenate(b1[name] + b2[name], axis=-1)
        np.testing.assert_array_equal(got, want[name])
    other, _ = _port(PER_VFO, BLOCK)
    with pytest.raises(ValueError, match="treedef mismatch"):
        other.load_checkpoint(path)
    # batched: the queued blocks are saved in front of the remainder
    batched, _ = _port(FUSED, BLOCK, scan_batch=4)
    batched.push(x[: 3 * BLOCK + 10])
    assert len(batched._pending) == 2
    batched.save_checkpoint(path)
    again, _ = _port(FUSED, BLOCK, scan_batch=4)
    again.load_checkpoint(path)
    assert len(again._pending) == 2 and again.framer.pending == 10


def _fetch_threads():
    """Live pool and emitter threads in this process (other test files
    of the same worker may have left some: compare counts)."""
    return [t for t in threading.enumerate()
            if t.name.startswith("ThreadPoolExecutor") or
            getattr(t, "_target", None) is not None
            and getattr(t._target, "__name__", "") == "_emit_loop"]


def test_async_delivery_equals_sync_and_leaves_no_thread():
    x = _capture(_cfgs(trx, FUSED), FS, 5 * BLOCK + 1234)
    sync_rx, bs = _port(FUSED, BLOCK)
    sync_rx.push(x)
    sync_rx.flush()
    before = len(_fetch_threads())
    async_rx, ba = _port(FUSED, BLOCK, async_fetch=3)
    async_rx.push(x[: 2 * BLOCK])
    assert len(_fetch_threads()) > before      # pool and emitter are up
    async_rx.sync()
    assert [a.shape[-1] for a in ba["n"]] == [BLOCK * 48 // 1000] * 2
    async_rx.push(x[2 * BLOCK:])
    async_rx.flush()                           # ends the threads
    assert len(_fetch_threads()) == before
    got, want = _cat(ba), _cat(bs)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    # a later push starts them again; close() (or `with`) ends them
    with async_rx:
        async_rx.push(x[:BLOCK])
        assert len(_fetch_threads()) > before
    assert len(_fetch_threads()) == before
    async_rx.close()  # idempotent


def test_sink_error_surfaces_in_both_modes():
    def bad_sink(_audio):
        raise RuntimeError("sink failed")

    x = _capture(_cfgs(trx, {"v": (0.0, "am")}), 100_000.0, 60_000)
    before = len(_fetch_threads())
    for workers in (0, 2):
        fe = trx.IQFrontend(100_000.0, {"v": trx.VfoConfig(0.0, "am")},
                            spectrum=False, device="cpu")
        rx = trx.Receiver(fe, block_len=20_000, audio_sinks={"v": bad_sink},
                          async_fetch=workers)
        with pytest.raises(RuntimeError, match="sink failed"):
            rx.push(x)     # sync: raises here; async: kept by the emitter
            rx.flush()     # ... and raised by sync() inside flush()
        rx.close()
    assert len(_fetch_threads()) == before


def test_async_auto_sizes_from_a_whole_payload_fetch():
    before = len(_fetch_threads())
    rx, _ = _port({"v": (0.0, "am")}, 20_000, fs=100_000.0, spectrum=False,
                  async_fetch="auto")
    state0 = rx._state
    rx.warmup()
    assert rx._state is state0                 # warm-up leaves no trace
    assert isinstance(rx.async_fetch, int) and 2 <= rx.async_fetch <= 16
    # nothing to fetch (no VFO, no spectrum): the conservative count
    fe = trx.IQFrontend(100_000.0, {}, spectrum=False, device="cpu")
    bare = trx.Receiver(fe, block_len=1000, async_fetch="auto")
    bare.warmup()
    assert bare.async_fetch == trx.Receiver.AUTO_WORKERS_NOTHING_TO_FETCH
    bare.push(np.zeros(2500, np.complex64))
    bare.flush()
    assert len(_fetch_threads()) == before


def test_frontend_refuses_a_second_block_length():
    rx, _ = _port({"v": (0.0, "am")}, 20_000, fs=100_000.0, spectrum=False)
    rx.frontend.bind(20_000)  # idempotent
    with pytest.raises(ValueError, match="already bound"):
        rx.frontend.bind(40_000)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trx.IQFrontend(100_000.0, {})


CLI_FS = 250_000


@pytest.mark.parametrize("mode", ["wfm", "nfm", "am", "usb", "lsb", "dsb",
                                  "cw", "raw"])
def test_cli_wav_in_wav_out_matches_reference(mode, tmp_path):
    n = 120_000
    cfg = {"main": trx.VfoConfig(20e3, mode)}
    iq = _capture(cfg, float(CLI_FS), n)
    src = str(tmp_path / "baseband_100000000Hz.wav")
    twav.write_iq_wav(src, CLI_FS, iq)
    info, back = jwav.read_iq_wav(src)
    assert info.samplerate == CLI_FS and len(back) == n
    outs = {}
    for name, cli in (("j", jcli), ("t", tcli)):
        out = str(tmp_path / f"{name}.wav")
        argv = ["--input", src, "--output", out, "--mode", mode, "--offset",
                "20000", "--fft-size", "1024", "--block-len", "50000"]
        if name == "t":
            argv += ["--device", "cpu"]
        assert cli.main(argv) == 0
        outs[name] = twav.read_wav(out)
    (info_j, a_j), (info_t, a_t) = outs["j"], outs["t"]
    assert info_t == info_j and info_t.samplerate == 48000
    assert a_t.shape == a_j.shape == (round(n * 48000 / CLI_FS), 2)
    assert np.abs(a_t).max() > 1e-3
    np.testing.assert_allclose(a_t, a_j, atol=3e-4)


def test_cli_extra_vfos_and_spectrum_out(tmp_path):
    cfgs = {"main": trx.VfoConfig(0.0, "am"),
            "side": trx.VfoConfig(50e3, "nfm")}
    iq = _capture(cfgs, float(CLI_FS), 50_000)
    src = str(tmp_path / "in.wav")
    twav.write_iq_wav(src, CLI_FS, iq, "float32")
    out = str(tmp_path / "out.wav")
    npy = str(tmp_path / "wf.npy")
    assert tcli.main(["--input", src, "--output", out, "--mode", "am",
                      "--vfo", "side:50000:nfm:10000", "--fft-size", "512",
                      "--block-len", "25000", "--spectrum-out", npy,
                      "--device", "cpu"]) == 0
    for name in ("main", "side"):
        info, a = twav.read_wav(str(tmp_path / f"out_{name}.wav"))
        assert info.samplerate == 48000 and a.shape == (9600, 2)
    assert np.load(npy).shape == (4, 512)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--input", src, "--output", out])


def test_retune_from_another_thread_while_pushing():
    """Control threads retune under the state lock while push() frames
    and dispatches: every block still comes out, finite, and the last
    retune is the one in force."""
    import sys

    spec = {"a": (10e3, "am"), "u": (-20e3, "usb")}
    rx, bufs = _port(spec, 20_000, fs=100_000.0, spectrum=False)
    x = _capture(_cfgs(trx, spec), 100_000.0, 12 * 20_000)
    stop = threading.Event()
    count = [0]

    def control():
        while not stop.is_set():
            count[0] += 1
            rx.retune("a", 10e3 + count[0] % 7)
            rx.retune("u", -20e3 - count[0] % 5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    workers = [threading.Thread(target=control) for _ in range(12)]
    try:
        for w in workers:
            w.start()
        for b in range(12):
            rx.push(x[b * 20_000:(b + 1) * 20_000])
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers) and count[0] > 0
    for name in spec:
        assert len(bufs[name]) == 12
        assert all(np.isfinite(a).all() for a in bufs[name])
    st = rx._state["vfos"]["a"]["xl"]
    assert set(st) == {"fine", "coarse", "delta", "phase"}
    assert rx.frontend.vfos["a"].xlator.offset_hz == -rx.frontend.vfos[
        "a"].cfg.offset_hz
