#!/usr/bin/env python3
"""A one-off check of the byte models of the roofline metrics against the
program's launch counters, on the card.

    python3 perfbench/model_check.py --workload poisson7.512.f32 --seed 1

It sets a cell up as a run does, then solves once with the program's
launch counters (``stencil_cuda.LAUNCHES``) reset, and prints, beside the
counts, what the metrics' models assume: red-black sweeps (one launch
each) = V-cycles x levels below the coarsest x (pre + post sweeps);
compact sweeps = 3 a Laplacian, one Laplacian an iteration (a direct
solve: one, its residual); and the models' bytes a solve. No benchmark run reads the counters.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import cells, peaks  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench.run import Run
    from poissbox_tpu_torch.ops import stencil_cuda
    cell = cells.load_cell(args.workload, cells.manifest())
    run = Run(cell, args.seed, args.device)
    stencil_cuda.reset_launches()
    res = run.solver.solve(run.pool[0])
    run.sync()
    its = int(res.iterations)
    launches = {k: v for k, v in stencil_cuda.LAUNCHES.items() if v}
    mg = run.mg
    out = {"workload": cell["name"], "iterations": its, "launches": launches, "mg": mg}
    if mg is not None:
        sm = cells.metric_module("smoother_roofline")
        sweeps = sum(v for k, v in launches.items() if k.startswith("rbsor."))
        per_cycle = (len(mg["levels"]) - 1) * (mg["pre"] + mg["post"])
        out.update(rbsor_launches=sweeps, vcycles_run=sweeps / per_cycle, vcycles_model=its,
                   smoothing_floor_ms=1e3 * peaks.floor_s(sm.solve_bytes(mg, its)),
                   smoothing_floor_ms_per_cycle=1e3 * peaks.floor_s(sm.cycle_bytes(mg)))
    if cell["config_spec"]["order"] == 6:
        cp = cells.metric_module("compact_roofline")
        lap = sum(v for k, v in launches.items() if k.startswith("compact."))
        out.update(compact_launches=lap, laplacians_run=lap / 3, laplacians_model=its,
                   laplacian_floor_ms=1e3 * peaks.floor_s(cp.laplacian_bytes(
                       cell["grid"], {"float32": 4, "float64": 8}[cell["dtype"]])))
    out["at"] = time.strftime("%Y-%m-%d %H:%M:%S")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
