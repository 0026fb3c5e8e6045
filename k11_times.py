#!/usr/bin/env python3
"""Device times of K11, the single red-black colour update, on one GPU,
beside the same C entry of another checkout's library, in turns on one card.

K11 (``stencil_cuda.sor_sweep_cuda`` -> ``poissbox_rbsor_colour`` in
``csrc/rbsor.cu``) is timed where the distributed multigrid levels run it:
bf16 at the (2, 2, 1) block of 512^3, (256, 256, 512), and at 512^3; f32
at 256^3 and at that block. Cubic cells, colour 0, x and b seeded uniform
in (-0.75, 1.25). For each case: the output against the plain version
(bit for bit), then seven rounds in turns of the median of 25 warm calls
between CUDA events, with the bound (x and b read once, the output written
once, over 3.35 TB/s) and the share of it.

With ``--against DIR`` the library of the checkout at DIR is built there
(its own ``_build``) and its ``poissbox_rbsor_colour``, which takes the
same arguments, is called on the same tensors: its output must equal this
checkout's bit for bit, and each round runs other, this, this, other:

    python3 k11_times.py
    python3 k11_times.py --against _checkout/parent

The last line of standard output is one JSON object: the card's name and
power limit and, by case, the times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from poissbox_tpu_torch.ops import _build
from poissbox_tpu_torch.ops import stencil_cuda as sc

CASES = (((256, 256, 512), torch.bfloat16), ((512,) * 3, torch.bfloat16),
         ((256,) * 3, torch.float32), ((256, 256, 512), torch.float32))
HBM_BPS = 3.35e12
W = 1.0
ROUNDS = 7


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


def other_library(root: str) -> ctypes.CDLL:
    """The kernel library of the checkout at `root`, built by its own
    _build module in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    path = subprocess.run(
        [sys.executable, "-c", "from poissbox_tpu_torch.ops import _build; print(_build.build())"],
        cwd=root, env=env, capture_output=True, text=True, check=True).stdout.strip()
    lib = ctypes.CDLL(path)
    i, d, p = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    lib.poissbox_rbsor_colour.argtypes = [i, i, i, p, p, p, p, i, i, i] + [d] * 6 + [i]
    lib.poissbox_rbsor_colour.restype = i
    return lib


def colour_with(lib, u, b, deltas, color):
    """One colour update through `lib`'s C entry, as sor_sweep_cuda calls it."""
    x = torch.empty_like(u)
    coefs, iso = sc._coefs(deltas, W)
    err = lib.poissbox_rbsor_colour(
        sc.DTYPE_CODE[u.dtype], iso, u.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream),
        ctypes.c_void_p(u.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(x.data_ptr()), *u.shape, *coefs, int(color))
    if err != 0:
        raise RuntimeError(f"the other checkout's K11 launch failed: CUDA error {err}")
    return x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="another checkout whose K11 is timed beside this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k11_times: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.load()
    other = other_library(args.against) if args.against else None
    results = {}
    for shape, dtype in CASES:
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        g = torch.Generator(device="cuda").manual_seed(sum(shape) + 5)
        u, b = ((torch.rand(shape, generator=g, device="cuda") * 2 - 0.75).to(dtype)
                for _ in range(2))
        d = (1.0 / max(shape),) * 3
        fns = {"this": lambda: sc.sor_sweep_cuda(u, b, d, W, 0)}
        got = fns["this"]()
        if not torch.equal(got, sc.sor_sweep_plain(u, b, d, W, 0)):
            raise AssertionError(f"K11 {tag}: differs from its plain version")
        if other is not None:
            fns["other"] = lambda: colour_with(other, u, b, d, 0)
            if not torch.equal(fns["other"](), got):
                raise AssertionError(f"K11 {tag}: this checkout's output differs from the "
                                     "other's")
        del got
        ts = {k: [] for k in fns}
        order = ["other", "this", "this", "other"] if other is not None else ["this"]
        for _ in range(ROUNDS):
            for k in order:
                ts[k].append(median_ms(fns[k]))
        bound = 3 * u.nbytes / HBM_BPS * 1e3
        res = {"bound_ms": bound}
        for k, v in ts.items():
            ms = statistics.median(v)
            res[k] = {"ms": ms, "min": min(v), "max": max(v), "share": bound / ms}
        results[tag] = res
        print(f"  K11 {tag}: bound {bound:.4f} ms; "
              + "; ".join(f"{k} {r['ms']:.4f} ms [{r['min']:.4f}, {r['max']:.4f}] "
                          f"({100 * r['share']:.1f} %)"
                          for k, r in res.items() if k != "bound_ms")
              + f" ({smi})", flush=True)
        del u, b
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "against": args.against, "k11": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
