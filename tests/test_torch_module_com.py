"""sdrtpu_torch's module RPC (`apps/module_com.py`) against sdrtpu's:
`ModuleComManager` semantics, `RadioInterface` over each package's
`Receiver` (the port's on the CPU) with equal replies and config edits,
and `receiver_rebuild`, the ``rebuild`` that really switches the port's
chain: after SET_MODE the VFO's audio is the new mode's, held against a
reference `Receiver` built in that mode from the switch on, within
`tests/test_torch_receiver.py`'s tolerance (2e-4 of the peak, at least
of 1.0).  A plain ``set_mode(name, cfg.mode)`` rebuild keeps the old
chain in both packages (ROADMAP.md fault F7)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdrtpu.apps import module_com as jmc  # noqa: E402
from sdrtpu.apps import receiver as jrx  # noqa: E402
from sdrtpu_torch.apps import module_com as tmc  # noqa: E402
from sdrtpu_torch.apps import receiver as trx  # noqa: E402

FS = 400_000.0
OFFSET = 50_000.0
REL = 2e-4


def _station(n, f_am=700.0, f_fm=1100.0):
    """An AM station and an NFM station on top of each other at OFFSET:
    each demodulator hears its own tone."""
    t = np.arange(n) / FS
    am = 1.0 + 0.5 * np.sin(2 * np.pi * f_am * t)
    fm = np.exp(1j * np.cumsum(2 * np.pi * 2500.0
                               * np.sin(2 * np.pi * f_fm * t) / FS))
    rng = np.random.default_rng(4)
    x = 0.1 * am * fm * np.exp(2j * np.pi * OFFSET * t)
    x = x + 1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _dominant_hz(a, fs=48000.0):
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    spec[:4] = 0.0
    return float(np.argmax(spec) * fs / a.size)


def _receiver(mod, mode, sinks, **kw):
    fe = mod.IQFrontend(FS, {"v0": mod.VfoConfig(OFFSET, mode)},
                        spectrum=False, **kw)
    # 100 ms blocks
    return mod.Receiver(fe, block_len=20 * fe.block_multiple(),
                        audio_sinks=sinks)


def test_manager_semantics_equal():
    for mod in (tmc, jmc):
        mc = mod.ModuleComManager()
        calls = []
        assert mc.register_interface("radio", "Radio",
                                     lambda c, a: calls.append((c, a)) or 42)
        assert not mc.register_interface("other", "Radio", lambda c, a: 0)
        assert mc.interface_exists("Radio")
        assert mc.get_module_name("Radio") == "radio"
        assert mc.call_interface("Radio", 1, "x") == 42
        assert calls == [(1, "x")]
        assert mc.unregister_interface("Radio")
        assert not mc.interface_exists("Radio")
        assert mc.get_module_name("Radio") is None
        with pytest.raises(KeyError):
            mc.call_interface("Radio", 0)
    assert tmc.RADIO_IFACE_MODES == jmc.RADIO_IFACE_MODES


def test_radio_interface_equal_over_both_receivers():
    """The reference test's command sequence through both packages'
    interfaces: the same replies, configs and rebuild calls."""
    results = []
    for mod, rmod, kw in ((tmc, trx, {"device": "cpu"}), (jmc, jrx, {})):
        rx = _receiver(rmod, "nfm", {}, **kw)
        rebuilds = []
        mc = mod.ModuleComManager()
        mc.register_interface("radio", "Radio",
                              mod.RadioInterface(rx, "v0",
                                                 lambda: rebuilds.append(1)))
        cfg = rx.frontend.vfos["v0"].cfg
        seq = [(mod.RADIO_IFACE_CMD_GET_MODE, None),
               (mod.RADIO_IFACE_CMD_SET_MODE, mod.RADIO_IFACE_MODES.index("am")),
               (mod.RADIO_IFACE_CMD_GET_MODE, None),
               (mod.RADIO_IFACE_CMD_GET_BANDWIDTH, None),
               (mod.RADIO_IFACE_CMD_SET_BANDWIDTH, 8000.0),
               (mod.RADIO_IFACE_CMD_SET_BANDWIDTH, 8000.0),  # no-op
               (mod.RADIO_IFACE_CMD_SET_SQUELCH_MODE, True),
               (mod.RADIO_IFACE_CMD_GET_SQUELCH_MODE, None),
               (mod.RADIO_IFACE_CMD_SET_SQUELCH_LEVEL, -37.0),
               (mod.RADIO_IFACE_CMD_GET_SQUELCH_LEVEL, None),
               (mod.RADIO_IFACE_CMD_SET_SQUELCH_MODE, False),
               (mod.RADIO_IFACE_CMD_SET_SQUELCH_LEVEL, -80.0),
               (mod.RADIO_IFACE_CMD_GET_SQUELCH_LEVEL, None),
               (mod.RADIO_IFACE_CMD_SET_SQUELCH_MODE, True)]
        replies = [mc.call_interface("Radio", c, a) for c, a in seq]
        results.append((replies, (cfg.mode, cfg.bandwidth, cfg.squelch_db),
                        len(rebuilds)))
        with pytest.raises(ValueError):
            mc.call_interface("Radio", 99)
    assert results[0] == results[1]
    replies, cfg, n = results[0]
    assert replies[0] == 0 and replies[2] == tmc.RADIO_IFACE_MODES.index("am")
    assert replies[9] == -37.0 and replies[12] == -80.0
    assert cfg == ("am", 8000.0, -80.0) and n == 6


def test_set_mode_through_receiver_rebuild_is_the_new_modes_audio():
    blk = _receiver(trx, "am", {}, device="cpu").block_len
    x = _station(5 * blk)
    got = []
    rx = _receiver(trx, "am", {"v0": got.append}, device="cpu")
    mc = tmc.ModuleComManager()
    mc.register_interface("radio", "Radio", tmc.RadioInterface(
        rx, "v0", tmc.receiver_rebuild(rx, "v0")))
    rx.push(x[:2 * blk])
    am_chain = rx.frontend.vfos["v0"]
    mc.call_interface("Radio", tmc.RADIO_IFACE_CMD_SET_MODE,
                      tmc.RADIO_IFACE_MODES.index("nfm"))
    nfm_chain = rx.frontend.vfos["v0"]
    assert nfm_chain is not am_chain and nfm_chain.radio.mode == "nfm"
    assert am_chain.cfg.mode == "am"  # the outgoing chain keeps its config
    rx.push(x[2 * blk:4 * blk])
    # back to am: the cached am chain, restarted
    mc.call_interface("Radio", tmc.RADIO_IFACE_CMD_SET_MODE,
                      tmc.RADIO_IFACE_MODES.index("am"))
    assert rx.frontend.vfos["v0"] is am_chain
    rx.push(x[4 * blk:])
    rx.flush()
    assert len(got) == 5
    nfm_ref, am_ref = [], []
    jn = _receiver(jrx, "nfm", {"v0": nfm_ref.append})
    jn.push(x[2 * blk:4 * blk])
    ja = _receiver(jrx, "am", {"v0": am_ref.append})
    ja.push(x[4 * blk:])
    ja.flush()
    for mine, ref in ((got[2:4], nfm_ref), (got[4:], am_ref)):
        a, b = np.concatenate(mine, axis=-1), np.concatenate(ref, axis=-1)
        np.testing.assert_allclose(a, b, atol=REL * max(np.abs(b).max(), 1.0))
    # and each mode's audio is its own station's tone
    for mine, tone in ((got[:2], 700.0), (got[2:4], 1100.0),
                       (got[4:], 700.0)):
        assert abs(_dominant_hz(np.concatenate(mine, axis=-1)[0]) - tone) < 6


@pytest.mark.parametrize("mod,rmod,kw", [(tmc, trx, {"device": "cpu"}),
                                         (jmc, jrx, {})],
                         ids=["port", "reference"])
def test_plain_set_mode_rebuild_keeps_the_old_chain(mod, rmod, kw):
    """Fault F7, shared: the interface edits the live config first, so a
    rebuild of ``set_mode(name, cfg.mode)`` files the outgoing chain
    under the new mode and takes it straight back."""
    rx = _receiver(rmod, "am", {}, **kw)
    old = rx.frontend.vfos["v0"]
    iface = mod.RadioInterface(
        rx, "v0", lambda: rx.set_mode("v0", rx.frontend.vfos["v0"].cfg.mode))
    iface(mod.RADIO_IFACE_CMD_SET_MODE, mod.RADIO_IFACE_MODES.index("nfm"))
    now = rx.frontend.vfos["v0"]
    assert now is old and now.cfg.mode == "nfm"
    assert now.radio.mode == "am"  # still the am demodulator


def test_receiver_rebuild_applies_squelch_and_bandwidth():
    rx = _receiver(trx, "nfm", {}, device="cpu")
    iface = tmc.RadioInterface(rx, "v0", tmc.receiver_rebuild(rx, "v0"))
    assert rx.frontend.vfos["v0"].radio.squelch is None
    iface(tmc.RADIO_IFACE_CMD_SET_SQUELCH_MODE, True)
    v = rx.frontend.vfos["v0"]
    assert v.radio.squelch is not None and v.radio.squelch.level_db == -50.0
    iface(tmc.RADIO_IFACE_CMD_SET_SQUELCH_LEVEL, -30.0)
    v = rx.frontend.vfos["v0"]
    assert v.radio.squelch.level_db == np.float32(-30.0)
    iface(tmc.RADIO_IFACE_CMD_SET_BANDWIDTH, 9000.0)
    v = rx.frontend.vfos["v0"]
    assert v.radio.bandwidth == 9000.0 and v.radio.squelch.level_db == -30.0
    iface(tmc.RADIO_IFACE_CMD_SET_SQUELCH_MODE, False)
    v = rx.frontend.vfos["v0"]
    assert v.radio.squelch is None and v.radio.bandwidth == 9000.0
    assert all(k[1] != "retired" for k in rx._mode_programs)
    assert (v.cfg.mode, v.cfg.bandwidth, v.cfg.squelch_db) == (
        "nfm", 9000.0, None)
