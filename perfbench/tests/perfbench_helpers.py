"""Small cells for the CPU: a cell of the manifest with its grid cut to
a few cells a side (a CPU run drives the kernels' plain versions); the
four-card cell's manifest entries; a plant that saves what the judge
judges."""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from perfbench import cells
from perfbench import run as harness


def small_cell(name: str, n: int = 16, **changes) -> dict:
    """The cell with n cells along z, the other axes and a "band"
    wavenumber cut in proportion."""
    cell = cells.load_cell(name, cells.manifest())
    scale = n / cell["grid"][2]
    cell["grid"] = [int(g * scale) for g in cell["grid"]]
    if "band" in cell:
        cell["band"] = cell["band"] * scale
    cell.update(changes)
    return cell


def cpu_run(cell: dict, seed: int = 2**31 + 11, seconds: float = 0.3, trace: bool = False):
    """A whole run on the CPU, the look for a card skipped."""
    return harness.run_process(cell, seed, seconds, trace, "cpu", time.time())


FOUR_CARD = cells.HERE / "tests" / "data" / "four_card_cell.json"


def with_four_card_cell(man: dict) -> dict:
    """`man` with the four-card cell's entries (``data/four_card_cell.json``)
    appended, as a manifest that lists the cell has them."""
    with open(FOUR_CARD) as fh:
        extra = json.load(fh)
    return {k: v + extra[k] if k in extra else v for k, v in man.items()}


def save_judged():
    """A fault for ``faults.planted`` ("perfbench.tests.perfbench_helpers:
    save_judged"): the judge unchanged, each field it judges saved with its
    b under $PERFBENCH_SAVE (on four ranks, rank 0's gathered field)."""
    import torch
    from perfbench import judge
    real = judge.judge_solve

    def judge_solve(order, x, reported, b, deltas, limits):
        out = Path(os.environ["PERFBENCH_SAVE"])
        torch.save({"x": x.cpu(), "b": b.cpu()}, out / f"judged{len(list(out.iterdir()))}.pt")
        return real(order, x, reported, b, deltas, limits)
    return judge, "judge_solve", judge_solve
