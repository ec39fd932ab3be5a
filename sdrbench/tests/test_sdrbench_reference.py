"""The plain reference against the port on the CPU at a small size, and
the comparison's power: the control (the reference in TF32) and a
bfloat16 copy of the port's output both fail the configuration's
limits, which the port meets."""

import numpy as np
import pytest
import torch

from sdrbench import harness
from sdrbench.reference import wbfm
from sdrbench.systems.wbfm_pipeline import System


@pytest.fixture(scope="module")
def setting():
    cell = harness.load_cell("wbfm8.batch")
    cfg = cell["config"]
    cfg.update(vfos=3, fft_size=8192)
    cap = harness.module("captures", "stereo_fm").make(
        cfg, 4 * cfg["block_len"], 2**31 + 17, "cpu")
    blocks = cap.reshape(4, -1)
    ref = wbfm.run(cfg, blocks)
    # the first block leaves the filters' start-up behind
    ref = {n: t[1:] for n, t in ref.items()}
    return cfg, blocks, ref


def within(cfg, gaps):
    return {n: v <= cfg["limits"][n] for n, v in gaps.items()}


@pytest.mark.parametrize("entry", ["scan_call", "call"])
def test_port_meets_the_limits(setting, entry):
    cfg, blocks, ref = setting
    system = System(cfg, "cpu")
    state, outs = system.init_state(), []
    if entry == "scan_call":
        state, out = system.call(entry, state, blocks)
        outs = [out]
    else:
        for b in blocks:
            state, out = system.call(entry, state, b[None])
            outs.append(out)
    got = {n: torch.cat([o[n] for o in outs])[1:] for n in ref}
    gaps = wbfm.gaps(cfg, got, ref)
    assert all(within(cfg, gaps).values()), gaps
    assert gaps["audio_gap"] < 1e-5


def test_bfloat16_output_fails(setting):
    cfg, blocks, ref = setting
    system = System(cfg, "cpu")
    _, out = system.call("scan_call", system.init_state(), blocks)
    got = {n: t[1:].to(torch.bfloat16).float() for n, t in out.items()}
    ok = within(cfg, wbfm.gaps(cfg, got, ref))
    assert not ok["audio_gap"] and not ok["waterfall_gap_db"]


def test_control_fails(setting):
    """The control kept at a size a test run holds: the reference in
    TF32 in the program's place."""
    cfg, blocks, ref = setting
    ctl = {n: t[1:] for n, t in wbfm.run(cfg, blocks, "tf32").items()}
    gaps = wbfm.gaps(cfg, ctl, ref)
    assert not any(within(cfg, gaps).values()), gaps


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12,
                      1e-30], dtype=torch.float64)
    y = wbfm.tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 4 * 2**-11, -3.0,
                          float(wbfm.tf32(torch.tensor([1e-30]))[0])]
    r = torch.rand(1000, dtype=torch.float64) + 0.5
    rel = ((wbfm.tf32(r) - r) / r).abs().max().item()
    assert 2**-11 >= rel > 2**-12


def test_reference_plan_is_the_configurations():
    """The reference's designs come from the configuration's numbers: a
    10 Msps to 250 kHz cascade of 8 and 5, 317 pilot taps, a 24/125
    resampler."""
    from sdrbench.reference import design

    plan = design.decimation_plan(1e7, 40, 1e5)
    assert [(f, len(t)) for f, t in plan] == [(8, 36), (5, 95)]
    assert len(design.band_pass_complex(18750, 19250, 3000, 250000,
                                        odd=True)) == 317
    assert design.rational(250000, 48000) == (24, 125)
    taps = design.low_pass(15000, 4000, 6e6)
    assert design.polyphase_bank(24, taps).shape == (24, 238)
    assert np.isclose(design.fm_subcarrier_comp(250000.0), 1.0420247,
                      rtol=1e-6)
