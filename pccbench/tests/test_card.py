"""On the card: each cell's command as the benchmark's check runs it, at
a short window, must print one correct result line.  Skips without a
CUDA device (``python -m pytest pccbench/tests -m cuda`` on the card)."""

import json
import subprocess
import sys

import pytest

from pccbench.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, traced):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs only there")
    proc = subprocess.run(
        [sys.executable, "-m", "pccbench.run", "--workload", cell, "--seed",
         str(2**31 + 101), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if traced:
        assert res["device"]["busy_s"] > 0
