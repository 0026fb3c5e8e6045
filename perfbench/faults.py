#!/usr/bin/env python3
"""Whole runs of a cell with a fault planted in the program, which the
comparison that decides ``correct`` has to catch.

    python3 perfbench/faults.py --workload <cell> --fault <name> --seeds 1,2,3 [--seconds 2]

The faults a solve can have (``FAULTS``): a solve that returns its state
unchanged (x = 0); an answer altered where it is produced (one cell of
x); every solve reported unconverged; and, for the compact operator, the
7-point Laplacian in K15's place (the operator's apply, which forms the
residual a solve reports) or the 7-point spectral solve in place of the
compact one; across ranks, the face exchange along x left out (each
rank's block wrapped on itself there). Each run prints its result line's
"correct" and "checks": the readings of a fault, which set a number's
upper reading. Benchmark runs do not run it; the tests plant the same
faults on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _wrap_solve(alter):
    from poissbox_tpu_torch.api import PoissonSolver
    real = PoissonSolver.solve

    def solve(self, b, x0=None):
        return alter(real(self, b, x0))
    return PoissonSolver, "solve", solve


def _altered(res):
    x = res.x.clone()
    x.view(-1)[x.numel() // 3] += 0.1 * float(x.abs().max())
    return res._replace(x=x)


def _unconverged(res):
    return res._replace(reason=res.reason.new_tensor(-3))


def _k15_lapl7():
    from perfbench.reference import operators
    from poissbox_tpu_torch.ops import compact
    return compact, "lapl", lambda u, deltas, method="auto": operators.lapl7(u, deltas)


def _solve_lapl7():
    from poissbox_tpu_torch.solvers import fft
    return fft, "compact_poisson_solve_fft", fft.poisson_solve_fft


def _x_exchange_left_out():
    """Across ranks: the face exchange along x left out, each rank taking
    its own opposite x planes for its neighbours' (a rank's block wrapped
    on itself); the other axes' exchanges go on."""
    from poissbox_tpu_torch.parallel import halo
    real = halo.start_face_exchange

    class Exchange:
        def __init__(self, block, width, others):
            self.block, self.width, self.others = block, width, others

        def wait(self):
            faces = dict(self.others.wait())
            n = self.block.shape[0]
            faces[0] = (self.block.narrow(0, n - self.width, self.width),
                        self.block.narrow(0, 0, self.width))
            return faces

    def start(block, mesh, width=1, dims=None):
        split = halo.sharded_dims(mesh, dims)
        if 0 not in split:
            return real(block, mesh, width, dims)
        return Exchange(block, width, real(block, mesh, width, [d for d in split if d]))
    return halo, "start_face_exchange", start


FAULTS = {
    "unchanged": lambda: _wrap_solve(lambda res: res._replace(x=res.x.new_zeros(res.x.shape))),
    "altered": lambda: _wrap_solve(_altered),
    "unconverged": lambda: _wrap_solve(_unconverged),
    "k15_lapl7": _k15_lapl7,
    "solve_lapl7": _solve_lapl7,
    "x_exchange_left_out": _x_exchange_left_out,
}


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault `name` planted, for the enclosed runs:
    an entry of FAULTS, or "<module>:<function>", a function that returns
    the same (owner, attribute, value) as they do."""
    if name in FAULTS:
        make = FAULTS[name]
    else:
        module, _, func = name.partition(":")
        make = getattr(importlib.import_module(module), func)
    owner, attr, value = make()
    real = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("faults: no CUDA card", file=sys.stderr)
        return 2
    from perfbench import cells
    from perfbench import run as harness
    cell = cells.load_cell(args.workload, cells.manifest())
    for s in args.seeds.split(","):
        if cell["chips"] > 1:
            # planted in every rank's process
            from perfbench import ranks
            out = ranks.launch(cell, int(s), args.seconds, False, args.device, time.time(),
                               fault=args.fault)
            if out.rc != 0:
                print(json.dumps({"workload": cell["name"], "fault": args.fault,
                                  "seed": int(s), "exit": out.rc}), flush=True)
                continue
            res = out.result
        else:
            with planted(args.fault):
                res = harness.run_process(cell, int(s), args.seconds, False, args.device,
                                          time.time())
        print(json.dumps({"workload": cell["name"], "fault": args.fault, "seed": int(s),
                          "correct": res["correct"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
