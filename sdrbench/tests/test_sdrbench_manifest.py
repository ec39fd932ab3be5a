"""BENCHMARK.json against the contract's shapes, every file it names
found by name, and a cell and a metric added as files only."""

import json
import re
import shutil

import pytest

from sdrbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["sdrbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [c["name"] for c in MAN["configs"]] + [
        w["name"] for w in MAN["workloads"]] + [
        m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MAN["end_to_end"]}
    layers = {m["layer"] for m in MAN["per_layer"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["layer"] in layers


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves(cell):
    c = harness.load_cell(cell)
    assert c["workload"]["chips"] == 1
    cfg = c["config"]
    assert cfg["reduced"] == []
    for kind, name in (("systems", cfg["system"]),
                       ("reference", cfg["reference"]),
                       ("captures", cfg["capture"]["kind"])):
        assert harness.module(kind, name) is not None
    assert c["traffic"]["kind"] in harness.TRAFFIC_KINDS
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert all(v is not None for v in cfg["limits"].values())


def test_added_cell_and_metric_are_found(tmp_path, tiny_cell):
    """A traffic mix, a cell and a per-layer metric added as files and
    entries only, in a copy of the benchmark, are run with no edit."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "sdrbench", tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    batch = json.loads(
        (tmp_path / "sdrbench/traffic/batch.json").read_text())
    batch["blocks_per_call"] = 2
    (tmp_path / "sdrbench/traffic/batch2.json").write_text(json.dumps(batch))
    man["workloads"].append({"name": "wbfm8.batch2", "config": "wbfm8_10msps",
                             "traffic": "batch2", "chips": 1, "why": "test"})
    (tmp_path / "sdrbench/metrics/calls_per_s.py").write_text(
        "def read(run):\n    return len(run.call_s) / run.window_s\n")
    man["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "apps.wbfm_pipeline",
                             "moves": "realtime_x",
                             "workloads": ["wbfm8.batch2"]})
    for m in man["end_to_end"]:
        if m["name"] == "realtime_x":
            m["workloads"].append("wbfm8.batch2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = tiny_cell("wbfm8.batch2", tmp_path)
    assert cell["traffic"]["blocks_per_call"] == 2
    out = harness.run_cell(cell, 5, 0.3, True, "cpu", 0.0)
    assert out["correct"]
    assert "calls_per_s" in out["metrics"]
    assert out["attempted"] % 2 == 0


def test_dotted_metric_falls_back_to_its_base_reader():
    """``device_idle.live`` has no file of its own: ``device_idle.py``
    reads it."""
    read = harness.reader("device_idle.live")
    assert read.__code__.co_filename.endswith("metrics/device_idle.py")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.live")


def test_traced_run_times_the_host_outside_the_profiler(tiny_cell):
    """A traced run drives an untraced window first: the host clock's
    metrics come from it, the device trace's from the window after."""
    cell = tiny_cell("wbfm8.batch")
    run, sample, nb, host = harness.measure(cell, 7, 0.3, True, "cpu", 0.0)
    assert run.trace is None and run.call_s and run.blocks
    tr = run.traced
    assert tr.trace is not None and tr.call_s and tr.blocks
    mean_ms = 1e3 * sum(run.call_s) / len(run.call_s)
    assert harness.reader("window_enqueue_ms.batch")(run) == mean_ms
