"""The command refuses to measure without a card, and a checkout with
the benchmark's files alone gives no result."""

import shutil
import subprocess
import sys

import pytest
import torch

from sdrbench import harness

ARGS = ["--workload", "wbfm8.batch", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def command(cwd):
    return subprocess.run([sys.executable, "-m", "sdrbench.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = command(harness.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "sdrbench", tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = command(harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
