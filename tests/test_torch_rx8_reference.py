"""The mixed-mode receiver (``rx8_mixed_10msps``) against its plain float64
reference on the CPU, at the size of ``sdrbench/tests/rx8.py`` (2 Msps,
every mode present), and the comparison's power: the control (the
reference in TF32), a bfloat16 copy of the port's audio and three faults
of the timed path each fail the configuration's limits, which the port
meets.

The port runs through the benchmark's system (``sdrbench/systems/
receiver.py``) over three blocks from rest; the harness's check runs the
reference from rest over every block up to each checked one, so both
start at the same sample and the AGC's start-up is common to both."""

import numpy as np
import pytest
import torch

from sdrbench import harness
from sdrbench.reference import receiver as ref
from sdrbench.systems.receiver import System
from sdrbench.tests.rx8 import tiny_cell

SEED = 2**31 + 17
BLOCKS = 3
CHECKED = (1, 2)  # block 0 holds every filter's start from rest


@pytest.fixture(scope="module")
def setting():
    cell = tiny_cell()
    cfg = cell["config"]
    host = harness.module("captures", "mixed_stations").make(
        cfg, BLOCKS * cfg["block_len"], SEED, "cpu").reshape(BLOCKS, -1)
    want = ref.run(cfg, host)
    return cell, host, {n: t[1:] for n, t in want.items()}


def drive(cfg, host, call=None, init=None):
    """The port over the blocks from rest: outputs (blocks, ...) each."""
    system = System(cfg, "cpu")
    state = system.init_state() if init is None else init(system)
    call = call or System.call
    outs = []
    for b in host:
        state, out = call(system, "call", state, b[None])
        outs.append(out)
    return {n: torch.cat([o[n] for o in outs]) for n in outs[0]}


def check(cell, host, got):
    """The harness's check of the blocks `CHECKED` of ``got``."""
    sample = harness.Sample(len(CHECKED), SEED, 1)
    for i in CHECKED:
        sample.offer(i, {n: t[i:i + 1] for n, t in got.items()}, 0)
    return harness.check(cell, sample, BLOCKS, host, "cpu")


def within(cfg, gaps):
    return {n: v <= cfg["limits"][n] for n, v in gaps.items()}


def test_port_meets_the_limits(setting):
    cell, host, want = setting
    verdict = check(cell, host, drive(cell["config"], host))
    assert verdict["correct"], verdict["numbers"]
    assert verdict["blocks"] == list(CHECKED)
    numbers = {n: d["value"] for n, d in verdict["numbers"].items()}
    assert set(numbers) == {"audio_gap", "agc_audio_gap", "waterfall_gap_db"}
    # an order of magnitude under each limit
    for n, v in numbers.items():
        assert v < cell["config"]["limits"][n] / 10, numbers


def test_control_fails(setting):
    cell, host, want = setting
    cfg = cell["config"]
    ctl = {n: t[1:] for n, t in ref.run(cfg, host, "tf32").items()}
    gaps = ref.gaps(cfg, ctl, want)
    assert not any(within(cfg, gaps).values()), gaps


def test_bfloat16_output_fails(setting):
    cell, host, want = setting
    cfg = cell["config"]
    got = drive(cfg, host)
    low = {n: t[1:].to(torch.bfloat16).float() for n, t in got.items()}
    ok = within(cfg, ref.gaps(cfg, low, want))
    assert not ok["audio_gap"] and not ok["agc_audio_gap"], ok


def stale_state(system, entry, state, xs):
    """Each call starts from the state it was given and returns it."""
    _, out = System.call(system, entry, state, xs)
    return state, out


def agc_sample_altered(system, entry, state, xs):
    """One sample of the AM VFO's audio changed by 1e-3 of full scale."""
    state, out = System.call(system, entry, state, xs)
    out["audio.am"] = out["audio.am"].clone()  # an inference tensor
    out["audio.am"][0, 0, 100] += 1e-3
    return state, out


def usb_phase_moved(system):
    """The USB demodulator's translation started one sample's phase on."""
    state = system.init_state()
    radio = state["vfos"]["usb"]["radio"]
    xl = system.frontend.vfos["usb"].radio.demod.xlator
    omega = 2.0 * np.pi * xl.offset_hz / xl.samplerate
    radio["demod"]["xl"] = torch.full_like(radio["demod"]["xl"], omega)
    return state


@pytest.mark.parametrize("fault", ["stale_state", "agc_sample_altered",
                                   "usb_phase_moved"])
def test_fault_fails_the_check(setting, fault):
    cell, host, _ = setting
    cfg = cell["config"]
    if fault == "usb_phase_moved":
        got = drive(cfg, host, init=usb_phase_moved)
    else:
        got = drive(cfg, host, call=globals()[fault])
    verdict = check(cell, host, got)
    assert not verdict["correct"], verdict["numbers"]


def test_reference_plans_are_the_programs():
    """The reference's DDC and audio plans, from the configuration's
    rates, against the program's resamplers at full scale."""
    from sdrtpu_torch.kernels.resample import RationalResampler

    cfg = harness.load_cell("rx8.stream")["config"]
    fs, audio = cfg["samplerate"], cfg["audio_rate"]
    for mode, m in cfg["modes"].items():
        for a, b in ((fs, m["if_rate"]), (m["if_rate"], audio)):
            stages, poly = ref.rational_plan(a, b, 0.4 * b)
            rr = RationalResampler(a, b, device="cpu")
            pre = rr.predecim.stages if rr.predecim else []
            assert [(f, len(t)) for f, t in stages] == [
                (s.decimation, s.ntaps) for s in pre], (mode, a, b)
            for (_, t), s in zip(stages, pre):
                np.testing.assert_allclose(t, s.taps, rtol=0, atol=1e-7)
            if poly is None:
                assert rr.resamp is None
                continue
            L, M, taps = poly
            assert (L, M) == (rr.resamp.interp, rr.resamp.decim)
            np.testing.assert_allclose(
                ref.design.polyphase_bank(L, taps), rr.resamp.bank,
                rtol=0, atol=1e-6)
