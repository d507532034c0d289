"""On the card: a short run of each cell through BENCHMARK.json's command,
correct, with every metric the cell names. Marked ``cuda``; without a card
each test skips inside itself."""

import json
import subprocess

import pytest
import torch

from perfbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cmd = bench["command"] + ["--workload", cell, "--seed", "2718281828", "--seconds", "5",
                              "--trace", "0", "--dev-set", "n_base=100000"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want


def test_no_card_no_result():
    """Without the card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(bench["command"] + ["--workload", CELLS[0], "--seed", "1",
                                              "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
