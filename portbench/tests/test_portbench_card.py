"""The benchmark's command end to end: without a card it fails and
prints no result; on a card every cell runs briefly and is correct."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json")
                                       .read_text())["workloads"]]


def command(name: str, seed: int, seconds: float, trace: int = 0):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200)


def test_without_a_card_the_run_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = command(CELLS[0], 1, 1)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_an_unknown_workload_fails():
    out = command("no-such.cell", 1, 1)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_briefly_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = command(name, 2 ** 32 + 17, 3, trace)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["metrics"] and len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert "setup_s" in res["metrics"]
