"""On a card: each cell of BENCHMARK.json run briefly through the
command a check uses, its last line correct and on the card (skipped
without a card)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", "97", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
