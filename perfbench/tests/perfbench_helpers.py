"""Small cells for the CPU: a cell of the manifest with its grid cut to
a few cells a side (a CPU run drives the kernels' plain versions)."""

from __future__ import annotations

import time

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
