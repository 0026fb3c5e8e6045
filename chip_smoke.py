#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Drives poissbox_tpu_torch's solver of record — CG preconditioned by one
geometric-multigrid V-cycle with red-black SOR smoothing — on the card,
through the hand-written kernels, and fails loudly if any phase fails:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the kernels from poissbox_tpu_torch/csrc with nvcc;
  3. kernels: every stencil7 epilogue and rbsor mode against its plain
     PyTorch version on the same card (64^3 f64, 256^3 f32, and an
     anisotropic grid), then kernel and plain times at 256^3 f32;
  4. main path: PoissonSolver MG-CG at 64^3 f64 (rtol 1e-8, 6 iterations)
     and 256^3 f32 (rtol 1e-6, 5 iterations) and the demo at 64^3, with
     the launch counters reset before and read after; then the same
     solves with the plain PyTorch operators (impl="roll") on the card.

The last two lines of standard output are a JSON object with one entry
per kernel mode, then {"ok": true, "device": {...}}.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import _build
from poissbox_tpu_torch.ops import stencil_cuda as sc
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner

# fields: max|kernel - plain| <= FIELD_TOL * max|plain|; reductions:
# |kernel - plain| <= RED_TOL * |plain|. The kernels keep the plain
# versions' grouping and are built without FMA contraction, so the only
# difference is the order of summation in the reductions.
FIELD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
RED_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}

PALLAS = "poissbox_tpu/ops/stencil_pallas.py"
KERNELS = {   # launch counter -> (source, TPU kernel it replaces)
    "stencil7.apply": ("stencil7.cu", f"{PALLAS}:348"),
    "stencil7.apply_dot": ("stencil7.cu", f"{PALLAS}:369"),
    "stencil7.residual": ("stencil7.cu", f"{PALLAS}:649"),
    "rbsor.zero": ("rbsor.cu", f"{PALLAS}:690"),
    "rbsor.zero_update": ("rbsor.cu", f"{PALLAS}:758"),
    "rbsor.general": ("rbsor.cu", f"{PALLAS}:848"),
    "rbsor.dots": ("rbsor.cu", f"{PALLAS}:848"),
}
W = 1.0        # SOR weight of the solver of record
ALPHA = 0.37   # CG step for the fused-update checks


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def mode_calls(deltas):
    """(name, kernel call, plain call) per mode; a name's prefix is the
    launch counter the mode moves."""
    return [
        ("stencil7.apply", lambda f: sc.apply_laplacian_cuda(f["u"], deltas),
         lambda f: sc.apply_laplacian_plain(f["u"], deltas)),
        ("stencil7.apply_dot", lambda f: sc.apply_laplacian_dot_cuda(f["u"], deltas),
         lambda f: sc.apply_laplacian_dot_plain(f["u"], deltas)),
        ("stencil7.residual", lambda f: sc.residual_cuda(f["u"], f["b"], deltas),
         lambda f: sc.residual_plain(f["u"], f["b"], deltas)),
    ] + [
        call for rev in (False, True) for call in [
            (f"rbsor.zero/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_zero_sweep_cuda(f["b"], deltas, W, rev),
             lambda f, rev=rev: sc.sor_rb_zero_sweep_plain(f["b"], deltas, W, rev)),
            (f"rbsor.zero_update/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_zero_update_cuda(
                 f["r"], f["ap"], f["alpha"], deltas, W, rev),
             lambda f, rev=rev: sc.sor_rb_zero_update_plain(
                 f["r"], f["ap"], f["alpha"], deltas, W, rev)),
            (f"rbsor.general/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u"], f["b"], deltas, W, rev),
             lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u"], f["b"], deltas, W, rev)),
            (f"rbsor.dots/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u"], f["b"], deltas, W, rev,
                                                     dots=True),
             lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u"], f["b"], deltas, W, rev,
                                                      dots=True)),
        ]
    ] + [
        ("rbsor.dots/multisweep3",
         lambda f: sc.sor_rb_multisweep_cuda(f["u"], f["b"], deltas, W, 3, dots=True),
         lambda f: sc.sor_rb_multisweep_plain(f["u"], f["b"], deltas, W, 3, dots=True)),
    ]


def fields(shape, dtype, seed):
    """Seeded inputs on the card; the offset keeps the sums well away from
    zero, so a relative tolerance on them is meaningful."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: torch.rand(shape, generator=g, dtype=dtype, device="cuda") * 2 - 0.75
    return {"u": mk(), "b": mk(), "r": mk(), "ap": mk(),
            "alpha": torch.tensor(ALPHA, dtype=dtype, device="cuda")}


def compare(name, got, ref, dtype) -> float:
    """Max abs field error; raises when a field or reduction is off."""
    worst = 0.0
    for g, r in zip(as_tuple(got), as_tuple(ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{r.dtype}{tuple(r.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite output")
        err = float((g - r).abs().max())
        if r.dim() == 0:
            rel = err / abs(float(r))
            if not rel <= RED_TOL[dtype]:
                raise AssertionError(f"{name}: reduction {float(g)!r} vs "
                                     f"{float(r)!r}, relative {rel:.3e}")
        else:
            scale = float(r.abs().max())
            if not err <= FIELD_TOL[dtype] * scale:
                raise AssertionError(f"{name}: field max|diff| {err:.3e} > "
                                     f"{FIELD_TOL[dtype]:g} * {scale:.3e}")
            worst = max(worst, err)
    return worst


def median_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device time of one call, from CUDA events around each of
    `reps` back-to-back calls after `warm` warm-up calls."""
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


def check_kernels() -> dict:
    """Phase 3: every mode against its plain version; returns, per launch
    counter, the max abs error and the times at 256^3 f32."""
    cases = [((64, 64, 64), (1.0, 1.0, 1.0), torch.float64),
             ((64, 32, 48), (1.0, 0.75, 1.5), torch.float64),
             ((64, 32, 48), (1.0, 0.75, 1.5), torch.float32),
             ((256, 256, 256), (1.0, 1.0, 1.0), torch.float32)]
    stats = {}
    for shape, length, dtype in cases:
        deltas = Grid3D(shape, length).deltas
        f = fields(shape, dtype, seed=sum(shape))
        big = shape == (256, 256, 256)
        for name, kern, plain in mode_calls(deltas):
            err = compare(f"{name} {shape} {dtype}", kern(f), plain(f), dtype)
            torch.cuda.synchronize()
            key = name.split("/")[0]
            if big and name.endswith("rev=False") or big and "/" not in name:
                ms = median_ms(lambda: kern(f))
                plain_ms = median_ms(lambda: plain(f))
                stats[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
                print(f"  {name:28s} 256^3 f32: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, max|diff| {err:.3e}")
        print(f"  all modes agree at {shape} {dtype}, lengths {length}", flush=True)
    return stats


def solve_case(n, dtype, rtol, expect_its):
    """One MG-CG solve through PoissonSolver on the card, checked."""
    opts = Options(["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
                    "-ksp_max_it", "50"])
    solver = PoissonSolver((n,) * 3, options=opts, dtype=dtype, device="cuda")
    u = np.random.default_rng(1).uniform(-1.0, 1.0, (n,) * 3)
    u = torch.as_tensor(u - u.mean(), dtype=dtype, device="cuda")
    b = solver.rhs_for(u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    its = int(res.iterations)
    t_solve = time.perf_counter() - t0
    rel = solver.residual_norm(res.x, b)
    if tuple(res.x.shape) != (n,) * 3 or not bool(torch.isfinite(res.x).all()):
        raise AssertionError(f"{n}^3: bad solution tensor")
    if its != expect_its or not res.reason_enum() > 0 or not rel <= rtol * 1.01:
        raise AssertionError(f"{n}^3 {dtype}: {its} iterations (expected "
                             f"{expect_its}), {res.reason_enum().name}, "
                             f"relative residual {rel:.3e} (rtol {rtol:g})")
    print(f"  {n}^3 {dtype} rtol {rtol:g}: {its} iterations, relative "
          f"residual {rel:.3e}, first solve {t_solve * 1e3:.2f} ms", flush=True)
    return solver, b


def timed_solve(fn, reps=3) -> float:
    """Median wall time of a solve that ends in a synchronise, in ms."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    phase("build")
    t0 = time.perf_counter()
    path = _build.load()._name
    print(f"  {path}: load {time.perf_counter() - t0:.1f} s, nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'} s")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    phase("kernels against plain versions")
    stats = check_kernels()

    phase("main path")
    sc.reset_launches()
    runs = [solve_case(64, torch.float64, 1e-8, 6),
            solve_case(256, torch.float32, 1e-6, 5)]
    from poissbox_tpu_torch import demo
    rel = demo.run(Options(["-n", "64", "-device", "cuda"]))
    if not rel <= 1e-5 * 1.01:
        raise AssertionError(f"demo: relative residual {rel:.3e}")
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    print(f"  launches: {launches}")

    phase("plain operators on the card, same solves")
    for (solver, b), (n, dtype, rtol, its) in zip(
            runs, [(64, torch.float64, 1e-8, 6), (256, torch.float32, 1e-6, 5)]):
        grid = solver.grid
        A = make_laplacian_operator(grid, impl="roll")
        M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(impl="roll"),
                                   dtype, "cuda")
        res = cg(A, b, M=M, rtol=rtol, max_it=50)
        if int(res.iterations) != its:
            raise AssertionError(f"plain {n}^3: {int(res.iterations)} iterations, "
                                 f"kernel path {its}")
        t_k = timed_solve(lambda: solver.solve(b))
        t_p = timed_solve(lambda: cg(A, b, M=M, rtol=rtol, max_it=50))
        print(f"  {n}^3 {dtype}: {its} iterations both; warm solve kernels "
              f"{t_k:.2f} ms, plain {t_p:.2f} ms ({smi})", flush=True)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda",
         "source": f"poissbox_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches[key], **stats[key]}
        for key, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
