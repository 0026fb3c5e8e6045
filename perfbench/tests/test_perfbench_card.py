"""On the card: one short run of each cell through the benchmark's
command, correct and with its metrics (skips without a card, and a
four-card cell without four)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import cells
from perfbench_helpers import with_four_card_cell

ROOT = Path(__file__).resolve().parents[2]


def one_card_cells():
    return [w["name"] for w in cells.manifest()["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", one_card_cells())
def test_cell_runs_correct_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                          "3000000001", "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    man = cells.manifest()
    want = {m["name"] for m in cells.metrics_for(name, man, bool(trace))}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "poisson7.64.f64",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_four_card_cell_runs_correct(trace):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    name = next(w["name"] for w in with_four_card_cell(cells.manifest())["workloads"]
                if w["chips"] == 4)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                          "3000000003", "--seconds", "5", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    want = {m["name"] for m in cells.metrics_for(name, cells.manifest(), bool(trace))}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 4
