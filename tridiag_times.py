#!/usr/bin/env python3
"""Device times of K13 (Thomas) and K16 (the twisted factorization) on one
GPU, through CudaTridiagFactor, for comparing two checkouts of the port in
turns on one card.

The system is the JAX package's bench system (alpha, 1, alpha), periodic,
solved along axis 0 of a seeded field at 512^3 f32, 512^3 f64, 256^3 f32
and 64^3 f64. For each size and algorithm: the median of 25 warm calls of
``solve`` between CUDA events, and the mean of 200 back-to-back launches of
the (n, Q) solve (the host's enqueue where it outlasts the kernel). Each
result is checked against the plain version, to 1e-5 (f32) or 1e-12 (f64)
of its largest value. The package is whichever ``poissbox_tpu_torch`` is on
the path, so the same script times another checkout:

    python3 tridiag_times.py
    PYTHONPATH=<other checkout> python3 tridiag_times.py --label parent

The last line of standard output is one JSON object: the card's name and
power limit, the label and the times in ms.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from poissbox_tpu_torch.ops.tridiag_cuda import CudaTridiagFactor

ALPHA = 9.0 / 62.0
SIZES = ((512, torch.float32), (512, torch.float64), (256, torch.float32), (64, torch.float64))
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def median_ms(fn, reps: int = 25, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def loop_ms(fn, reps: int = 200) -> float:
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tridiag_times: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    times = {}
    for n, dtype in SIZES:
        tag = f"{n}^3 {str(dtype).replace('torch.', '')}"
        g = torch.Generator(device="cuda").manual_seed(2)
        d = torch.rand((n,) * 3, generator=g, dtype=dtype, device="cuda")
        d2 = d.reshape(n, -1)
        a = torch.full((n,), ALPHA, dtype=dtype)
        for alg in ("thomas", "babe"):
            fac = CudaTridiagFactor(a, torch.ones(n, dtype=dtype), a.clone(), periodic=True,
                                    algorithm=alg)
            x, ref = fac.solve(d, 0), fac.solve(d, 0, plain=True)
            err = float((x - ref).abs().max()) / float(ref.abs().max())
            if not err <= TOL[dtype]:
                raise AssertionError(f"{alg} {tag}: relative {err:.3e} from the plain version")
            times[f"{alg} {tag}"] = {"median_ms": median_ms(lambda: fac.solve(d, 0)),
                                     "loop_ms": loop_ms(lambda: fac._solve_lines(d2, False)),
                                     "max_rel_err": err}
            print(f"  {args.label}: {alg} {tag}: {times[f'{alg} {tag}']}", flush=True)
        del d, d2
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "label": args.label, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
