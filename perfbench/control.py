#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the reference
put in the program's place, computed one precision below the cell's, has
to fail the cell's limit.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

For each seed it makes the cell's pool of right-hand sides (the same
generator as a run), solves each b exactly by the reference's spectral
solve, once in the cell's precision (the witness, which has to pass) and
once in the precision below it (the control), and judges both by the
numbers a run compares that need no reported residual ("residual",
"error"): the worst over the pool. The precision below float64 is
float32 (b, the transforms and x in float32). Below float32, whose
products the program keeps out of TF32, it is TF32: b and x rounded to
TF32's 10-bit mantissa, the transforms in float32 (cuFFT has no TF32 or
bfloat16 transform).

It prints one JSON line a seed: each number's worst reading of the
control and of the witness, beside the cell's limit. Benchmark runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import cells, judge, pool  # noqa: E402
from perfbench.reference import operators  # noqa: E402


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits (to nearest,
    ties away from zero)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def control_solve(order: int, b: torch.Tensor, deltas, dtype: str) -> torch.Tensor:
    """The reference's solve one precision below `dtype`."""
    if dtype == "float64":
        return operators.solve(order, b.to(torch.float32), deltas, real=torch.float32)
    if dtype == "float32":
        return round_tf32(operators.solve(order, round_tf32(b), deltas, real=torch.float32))
    raise ValueError(f"no control below {dtype}")


def readings(cell: dict, seed: int, device) -> dict:
    """{number: {"control", "witness", "limit"}}, the worst over the pool."""
    order = cell["config_spec"]["order"]
    d = pool.deltas(cell["grid"], cell["length"])
    limits = {k: v for k, v in cell["limits"].items() if k in ("residual", "error")}
    out = {k: {"control": 0.0, "witness": 0.0, "limit": v} for k, v in limits.items()}
    own = pool.DTYPES[cell["dtype"]]
    for b in pool.right_hand_sides(cell, seed, device):
        for side, x in (("witness", operators.solve(order, b, d, real=own).to(own)),
                        ("control", control_solve(order, b, d, cell["dtype"]))):
            got = judge.judge_solve(order, x, 0.0, b, d, limits)
            for k, v in got.items():
                out[k][side] = max(out[k][side], v)
            del x
        del b
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload, cells.manifest())
    for s in args.seeds.split(","):
        print(json.dumps({"workload": cell["name"], "seed": int(s),
                          **readings(cell, int(s), torch.device(args.device))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
