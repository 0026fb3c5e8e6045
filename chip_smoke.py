#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Drives poissbox_tpu_torch's solver of record — CG preconditioned by one
geometric-multigrid V-cycle — on the card, through the hand-written
kernels, and fails loudly if any phase fails:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the kernels from poissbox_tpu_torch/csrc with nvcc
     (one compiler per source, in parallel);
  3. kernels: every stencil7 epilogue, rbsor mode, xfer leg and the CG
     update against its plain PyTorch version on the same card (64^3 f64,
     256^3 f32, an anisotropic grid; the bf16 modes on the f32 cases and
     512^3), then kernel and plain times at 256^3 f32 and, for the modes
     of the 512^3 path, at 512^3 f32;
  4. transfers: the banded-matrix y/z transfers against the roll form in
     f32 with TF32 allowed globally (the contractions must not use it),
     and their times against the roll form's;
  5. paths, each with the launch counters reset before and read after,
     each checked against the plain PyTorch path on the card (impl="roll",
     transfers="roll"), with warm solve times:
       (a)   MG-CG through the fused transfer legs (K6/K7): 64^3 f64 rtol
             1e-8 (6 iterations), 256^3 f32 rtol 1e-6 (5), the demo at 64^3;
       (a/r) the same solves with -mg_transfers roll through the kernels;
       (b)   512^3 f32 rtol 1e-6, the default MGConfig: V(1,1), bf16
             pre-smooth, K5 storing x1 in bf16, K6/K7 reading it (7);
       (b/r) the same with -mg_transfers roll (CG then takes K8);
       (c)   256^3 f32 rtol 1e-6 with -mg_levels_pc_type jacobi: K10 on
             every level, CG on K8 and apply_dots.

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
from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import _build
from poissbox_tpu_torch.ops import stencil_cuda as sc
from poissbox_tpu_torch.ops import transfer_cuda as tc
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers import ksp
from poissbox_tpu_torch.solvers import mg

BF16 = torch.bfloat16
# fields: max|kernel - plain| <= FIELD_TOL * max|plain|; reductions:
# |kernel - plain| <= RED_TOL * |plain|. The kernels keep the plain
# versions' grouping and are built without FMA contraction, so the only
# difference is the order of summation in the reductions, and for bf16
# a tie at the store (one bf16 ulp, 2^-7 of the field's max at most).
FIELD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, BF16: 2.0 ** -7}
RED_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# banded-matrix transfers against the roll form, float32
MM_TOL = 1e-6

PALLAS = "poissbox_tpu/ops/stencil_pallas.py"
INPLACE = "poissbox_tpu/ops/stencil_inplace.py"
KERNELS = {   # launch counter -> (source, TPU kernel(s) it replaces)
    "stencil7.apply": ("stencil7.cu", f"{PALLAS}:348"),
    "stencil7.apply_dot": ("stencil7.cu", f"{PALLAS}:369"),
    "stencil7.residual": ("stencil7.cu", f"{PALLAS}:649"),
    "stencil7.jacobi": ("stencil7.cu", f"{PALLAS}:655, {INPLACE}:247"),
    "rbsor.zero": ("rbsor.cu", f"{PALLAS}:690"),
    "rbsor.zero_update": ("rbsor.cu", f"{PALLAS}:758, {INPLACE}:679"),
    "rbsor.general": ("rbsor.cu", f"{PALLAS}:848, {INPLACE}:275"),
    "rbsor.dots": ("rbsor.cu", f"{PALLAS}:848, {INPLACE}:275"),
    "rbsor.zero.bf16": ("rbsor.cu", f"{PALLAS}:690"),
    "rbsor.general.bf16": ("rbsor.cu", f"{PALLAS}:690"),
    "rbsor.general.narrow": ("rbsor.cu", f"{PALLAS}:758, {INPLACE}:679"),
    "xfer.restrict": ("xfer.cu", f"{PALLAS}:971"),
    "xfer.restrict.bf16u": ("xfer.cu", f"{PALLAS}:971"),
    "xfer.prolong_add": ("xfer.cu", f"{PALLAS}:1044"),
    "xfer.prolong_add.bf16u": ("xfer.cu", f"{PALLAS}:1044"),
    "cgupd": ("cgupd.cu", f"{PALLAS}:596"),
}
# the modes of the 512^3 path, timed at 512^3 (the rest at 256^3)
AT_512 = ("rbsor.zero.bf16", "rbsor.general.bf16", "rbsor.general.narrow",
          "xfer.restrict.bf16u", "xfer.prolong_add.bf16u")
W = 1.0        # SOR weight of the solver of record
WJ = 8.0 / 9.0  # damped-Jacobi weight of the Jacobi smoother
ALPHA = 0.37   # CG step for the fused-update checks


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def mode_calls(deltas, narrow: bool):
    """(name, launch counter, kernel call, plain call) per mode; with
    `narrow` (float32 cases) the bf16 modes too. A timed name is the
    counter's own; a sweep mode's time is the wrapper's (the whole TPU
    kernel: K3 = zero + general, K5 = zero_update + general)."""
    d = deltas
    calls = [
        ("stencil7.apply", lambda f: sc.apply_laplacian_cuda(f["u"], d),
         lambda f: sc.apply_laplacian_plain(f["u"], d)),
        ("stencil7.apply_dot", lambda f: sc.apply_laplacian_dot_cuda(f["u"], d),
         lambda f: sc.apply_laplacian_dot_plain(f["u"], d)),
        ("stencil7.residual", lambda f: sc.residual_cuda(f["u"], f["b"], d),
         lambda f: sc.residual_plain(f["u"], f["b"], d)),
        ("stencil7.jacobi", lambda f: sc.jacobi_sweep_cuda(f["u"], f["b"], d, WJ),
         lambda f: sc.jacobi_sweep_plain(f["u"], f["b"], d, WJ)),
        ("xfer.restrict", lambda f: tc.residual_xrestrict_cuda(f["u"], f["b"], d),
         lambda f: tc.residual_xrestrict_plain(f["u"], f["b"], d)),
        ("xfer.prolong_add", lambda f: tc.xprolong_add_cuda(f["u"], f["e"]),
         lambda f: tc.xprolong_add_plain(f["u"], f["e"])),
        ("cgupd", lambda f: sc.cg_fused_update_cuda(f["alpha"], f["u"], f["p"],
                                                    f["r"], f["ap"]),
         lambda f: sc.cg_fused_update_plain(f["alpha"], f["u"], f["p"], f["r"],
                                            f["ap"])),
        ("rbsor.dots/multisweep3",
         lambda f: sc.sor_rb_multisweep_cuda(f["u"], f["b"], d, W, 3, dots=True),
         lambda f: sc.sor_rb_multisweep_plain(f["u"], f["b"], d, W, 3, dots=True)),
    ]
    for rev in (False, True):
        calls += [
            (f"rbsor.zero/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_zero_sweep_cuda(f["b"], d, W, rev),
             lambda f, rev=rev: sc.sor_rb_zero_sweep_plain(f["b"], d, W, rev)),
            (f"rbsor.zero_update/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_zero_update_cuda(
                 f["r"], f["ap"], f["alpha"], d, W, rev),
             lambda f, rev=rev: sc.sor_rb_zero_update_plain(
                 f["r"], f["ap"], f["alpha"], d, W, rev)),
            (f"rbsor.general/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u"], f["b"], d, W, rev),
             lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u"], f["b"], d, W, rev)),
            (f"rbsor.dots/rev={rev}",
             lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u"], f["b"], d, W, rev,
                                                     dots=True),
             lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u"], f["b"], d, W, rev,
                                                      dots=True)),
        ]
        if narrow:
            calls += [
                (f"rbsor.zero.bf16/rev={rev}",
                 lambda f, rev=rev: sc.sor_rb_zero_sweep_cuda(f["b16"], d, W, rev),
                 lambda f, rev=rev: sc.sor_rb_zero_sweep_plain(f["b16"], d, W, rev)),
                (f"rbsor.general.bf16/rev={rev}",
                 lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u16"], f["b16"], d, W, rev),
                 lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u16"], f["b16"], d, W,
                                                          rev)),
                (f"rbsor.general.narrow/rev={rev}",
                 lambda f, rev=rev: sc.sor_rb_zero_update_cuda(
                     f["r"], f["ap"], f["alpha"], d, W, rev, out_dtype=BF16),
                 lambda f, rev=rev: sc.sor_rb_zero_update_plain(
                     f["r"], f["ap"], f["alpha"], d, W, rev, out_dtype=BF16)),
            ]
    if narrow:
        calls += [
            ("xfer.restrict.bf16u",
             lambda f: tc.residual_xrestrict_cuda(f["u16"], f["b"], d),
             lambda f: tc.residual_xrestrict_plain(f["u16"], f["b"], d)),
            ("xfer.prolong_add.bf16u",
             lambda f: tc.xprolong_add_cuda(f["u16"], f["e"]),
             lambda f: tc.xprolong_add_plain(f["u16"], f["e"])),
        ]
    return calls


def fields(shape, dtype, seed):
    """Seeded inputs on the card; the offset keeps the sums well away from
    zero, so a relative tolerance on them is meaningful."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s=shape: torch.rand(s, generator=g, dtype=dtype, device="cuda") * 2 - 0.75
    f = {"u": mk(), "b": mk(), "r": mk(), "ap": mk(), "p": mk(),
         "e": mk((shape[0] // 2,) + tuple(shape[1:])),
         "alpha": torch.tensor(ALPHA, dtype=dtype, device="cuda")}
    if dtype == torch.float32:
        f["u16"], f["b16"] = f["u"].to(BF16), f["b"].to(BF16)
    return f


def compare(name, got, ref) -> float:
    """Max abs field error; raises when a field or reduction is off."""
    worst = 0.0
    for g, r in zip(as_tuple(got), as_tuple(ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{r.dtype}{tuple(r.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite output")
        err = float((g.double() - r.double()).abs().max())
        if r.dim() == 0:
            rel = err / abs(float(r))
            if not rel <= RED_TOL[r.dtype]:
                raise AssertionError(f"{name}: reduction {float(g)!r} vs "
                                     f"{float(r)!r}, relative {rel:.3e}")
        else:
            scale = float(r.double().abs().max())
            if not err <= FIELD_TOL[r.dtype] * scale:
                raise AssertionError(f"{name}: {r.dtype} field max|diff| "
                                     f"{err:.3e} > {FIELD_TOL[r.dtype]:g} * "
                                     f"{scale:.3e}")
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
    counter, the max abs error over the cases and the times at the
    mode's path shape (512^3 for AT_512, 256^3 otherwise)."""
    cases = [((64, 64, 64), (1.0, 1.0, 1.0), torch.float64),
             ((64, 32, 48), (1.0, 0.75, 1.5), torch.float64),
             ((64, 32, 48), (1.0, 0.75, 1.5), torch.float32),
             ((256, 256, 256), (1.0, 1.0, 1.0), torch.float32),
             ((512, 512, 512), (1.0, 1.0, 1.0), torch.float32)]
    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for shape, length, dtype in cases:
        deltas = Grid3D(shape, length).deltas
        f = fields(shape, dtype, seed=sum(shape))
        n = shape[0] if len(set(shape)) == 1 else 0
        for name, kern, plain in mode_calls(deltas, dtype == torch.float32):
            key = name.split("/")[0]
            if n == 512 and key not in AT_512 and not key.startswith(
                    ("xfer.", "cgupd", "stencil7.jacobi")):
                continue      # at 512^3, only this slice's modes
            err = compare(f"{name} {shape} {dtype}", kern(f), plain(f))
            torch.cuda.synchronize()
            st = stats[key]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            timed = "/" not in name or name.endswith("rev=False")
            if n in (256, 512) and timed:
                ms, plain_ms = median_ms(lambda: kern(f)), median_ms(lambda: plain(f))
                print(f"  {name:32s} {n}^3 f32: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, max|diff| {err:.3e}")
                if n == (512 if key in AT_512 else 256):
                    st.update(ms=ms, plain_ms=plain_ms)
        del f
        torch.cuda.empty_cache()
        print(f"  all modes agree at {shape} {dtype}, lengths {length}", flush=True)
    return stats


def check_contractions() -> None:
    """Phase 4: restrict_mm/prolong_mm equal the roll transfers in f32
    with torch's TF32 switch on (the contractions set full float32
    themselves), and their times against the roll form's."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g = torch.Generator(device="cuda").manual_seed(7)
        for n, axes in ((256, (0, 1, 2)), (256, (1, 2)), (512, (1, 2))):
            fine = (n // 2, n, n) if axes == (1, 2) else (n,) * 3
            coarse = tuple(s // 2 if a in axes else s for a, s in enumerate(fine))
            f = torch.rand(fine, generator=g, device="cuda") * 2 - 1
            c = torch.rand(coarse, generator=g, device="cuda") * 2 - 1
            for what, mm, roll, x in (
                    ("restrict", mg.restrict_mm, mg.restrict, f),
                    ("prolong", mg.prolong_mm, mg.prolong, c)):
                a, b = mm(x, axes=axes), roll(x, axes=axes)
                rel = float((a - b).abs().max()) / float(b.abs().max())
                if not rel <= MM_TOL:
                    raise AssertionError(f"{what}_mm {n}^3 axes {axes}: relative "
                                         f"{rel:.3e} from the roll form")
                t_mm = median_ms(lambda: mm(x, axes=axes), reps=9)
                t_roll = median_ms(lambda: roll(x, axes=axes), reps=9)
                print(f"  {what} axes {axes} on {tuple(x.shape)}: matmul "
                      f"{t_mm:.4f} ms, roll {t_roll:.4f} ms, relative diff "
                      f"{rel:.2e}", flush=True)
            del f, c
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def rhs(solver, n, dtype):
    """b = A u for u uniform(-1, 1) from numpy seed 1, mean removed."""
    u = np.random.default_rng(1).uniform(-1.0, 1.0, (n,) * 3)
    u -= u.mean()
    return solver.rhs_for(torch.as_tensor(u, dtype=dtype, device="cuda"))


def solve_case(n, dtype, rtol, extra, expect_its):
    """One MG-CG solve through PoissonSolver on the card, checked; returns
    (solver, b, iterations)."""
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
            "-ksp_max_it", "50", *extra]
    solver = PoissonSolver((n,) * 3, options=Options(argv), dtype=dtype,
                           device="cuda")
    b = rhs(solver, n, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    its = int(res.iterations)
    t_solve = time.perf_counter() - t0
    rel = solver.residual_norm(res.x, b)
    if tuple(res.x.shape) != (n,) * 3 or not bool(torch.isfinite(res.x).all()):
        raise AssertionError(f"{n}^3: bad solution tensor")
    bad_its = expect_its is not None and its != expect_its
    if bad_its or not res.reason_enum() > 0 or not rel <= rtol * 1.01:
        raise AssertionError(f"{n}^3 {dtype} {extra}: {its} iterations "
                             f"(expected {expect_its}), {res.reason_enum().name}, "
                             f"relative residual {rel:.3e} (rtol {rtol:g})")
    print(f"  {n}^3 {dtype} rtol {rtol:g} {' '.join(extra)}: {its} iterations, "
          f"relative residual {rel:.3e}, first solve {t_solve * 1e3:.2f} ms, "
          f"M: {solver._solver.M.resolved}", flush=True)
    return solver, b, its


def run_path(label, cases, required, totals, demo=False):
    """Drive one path with the counters reset before and read after; fail
    if a kernel the path needs was never launched. Returns the solves."""
    print(f"-- path {label}", flush=True)
    sc.reset_launches()
    runs = [solve_case(*c) for c in cases]
    if demo:
        from poissbox_tpu_torch import demo as demo_mod
        rel = demo_mod.run(Options(["-n", "64", "-device", "cuda"]))
        if not rel <= 1e-5 * 1.01:
            raise AssertionError(f"demo: relative residual {rel:.3e}")
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    idle = [k for k in required if launches[k] == 0]
    if idle:
        raise AssertionError(f"path {label}: kernels never launched: {idle}")
    print(f"  launches: { {k: v for k, v in launches.items() if v} }", flush=True)
    for k, v in launches.items():
        totals[k] += v
    return runs


def plain_solver(n, dtype, rtol, extra):
    """The same options on the plain PyTorch path on the card: the roll
    operator, impl='roll', transfers='roll'."""
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
            "-ksp_max_it", "50", *extra, "-mg_impl", "roll",
            "-mg_transfers", "roll"]
    grid = Grid3D((n,) * 3, device="cuda")
    A = make_laplacian_operator(grid, impl="roll")
    return ksp.make_solver(A, SolverOptions.from_options(Options(argv)),
                           dtype=dtype, grid=grid)


def warm_ms(fns: dict, reps: int = 3) -> dict:
    """Median wall time (ms) of each solve, ending in a synchronise, with
    the variants taken in turns."""
    ts = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in ts.items()}


def compare_paths(runs, cases, smi, roll_runs=None):
    """Each solve against the plain path on the card (same iteration
    count), then warm solve medians: kernels, kernels with roll transfers
    (where given), plain."""
    for i, ((solver, b, its), (n, dtype, rtol, extra, _)) in enumerate(zip(runs, cases)):
        plain = plain_solver(n, dtype, rtol, extra)
        p_its = int(plain(b).iterations)
        if p_its != its:
            raise AssertionError(f"plain {n}^3 {extra}: {p_its} iterations, "
                                 f"kernel path {its}")
        fns = {"kernels": lambda: solver.solve(b)}
        if roll_runs is not None:
            rsolver, rb, _ = roll_runs[i]
            fns["kernels, roll transfers"] = lambda: rsolver.solve(rb)
        fns["plain"] = lambda: plain(b)
        med = warm_ms(fns)
        print(f"  {n}^3 {dtype} {' '.join(extra)}: {its} iterations both; warm "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
              + f" ({smi})", flush=True)


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
    t_start = time.perf_counter()

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

    phase("banded-matrix transfers against the roll form")
    check_contractions()

    phase("paths")
    totals = {k: 0 for k in sc.LAUNCHES}
    f64, f32 = torch.float64, torch.float32
    cases_a = [(64, f64, 1e-8, [], 6), (256, f32, 1e-6, [], 5)]
    roll = ["-mg_transfers", "roll"]
    cases_ar = [(n, dt, rtol, roll, its) for n, dt, rtol, _, its in cases_a]
    cases_b = [(512, f32, 1e-6, [], 7)]
    cases_br = [(512, f32, 1e-6, roll, 7)]
    cases_c = [(256, f32, 1e-6, ["-mg_levels_pc_type", "jacobi"], None)]
    base = ["stencil7.apply", "stencil7.apply_dot", "rbsor.general"]
    runs_a = run_path("(a) fused legs, 64^3 f64 + 256^3 f32 + demo", cases_a,
                      base + ["rbsor.zero", "rbsor.zero_update", "rbsor.dots",
                              "xfer.restrict", "xfer.prolong_add"],
                      totals, demo=True)
    runs_ar = run_path("(a/r) roll transfers through the kernels", cases_ar,
                       base + ["stencil7.residual", "rbsor.zero_update"], totals)
    compare_paths(runs_a, cases_a, smi, runs_ar)
    del runs_a, runs_ar
    torch.cuda.empty_cache()
    runs_b = run_path("(b) 512^3 f32, bf16 pre-smooth", cases_b,
                      base + ["rbsor.zero_update", "rbsor.general.narrow",
                              "rbsor.zero.bf16", "rbsor.general.bf16",
                              "rbsor.dots", "xfer.restrict.bf16u",
                              "xfer.prolong_add.bf16u"], totals)
    runs_br = run_path("(b/r) 512^3 f32, roll transfers", cases_br,
                       base + ["cgupd", "stencil7.residual",
                               "rbsor.zero.bf16", "rbsor.general.bf16"], totals)
    compare_paths(runs_b, cases_b, smi, runs_br)
    del runs_b, runs_br
    torch.cuda.empty_cache()
    runs_c = run_path("(c) 256^3 f32, Jacobi smoother", cases_c,
                      ["stencil7.apply", "stencil7.apply_dot", "stencil7.jacobi",
                       "cgupd", "xfer.restrict", "xfer.prolong_add"], totals)
    compare_paths(runs_c, cases_c, smi)
    idle = [k for k in KERNELS if totals[k] == 0]
    if idle:
        raise AssertionError(f"kernels no path launched: {idle}")
    print(f"  chip_smoke wall so far {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda",
         "source": f"poissbox_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": totals[key], **stats[key]}
        for key, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
