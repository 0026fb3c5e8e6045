"""End-to-end demo (port of :mod:`poissbox_tpu.demo`): device report, grid
and operator setup, random solution, the operator self-checks, the
options-driven solve, and the final true-residual print.

  * check_grid ......... the device's DoF count is the global DoF count
  * check_lapl ......... matrix-free matvec == pointwise formulation
  * check_matrices ..... every operator view agrees, ||A x - P x||

    python -m poissbox_tpu_torch.demo -n 64 -device cuda \
        -ksp_rtol 1e-8 -ksp_monitor -ksp_converged_reason

`-device` is cpu (default) or cuda; on cuda the operator and every MG
level run the hand-written kernels. `-x64 0` runs in float32 (an rtol
below 1e-6 is then clamped to 1e-6, with a notice).
"""

from __future__ import annotations

import sys
import time

import torch

from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops.assemble import assemble_laplacian
from poissbox_tpu_torch.ops.stencil import (
    apply_laplacian_pointwise,
    make_laplacian_operator,
)
from poissbox_tpu_torch.solvers.ksp import solve


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t))


def run(opts: Options) -> float:
    """Run the demo; returns the final relative true residual
    ||Ax - b|| / ||b||."""
    n = opts.get_int("n", 64)
    device = torch.device(opts.get_str("device", "cpu"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda: torch.cuda.is_available() is False")
    # the reference's precision of record is double; `-x64 0` opts into
    # float32, clamping an rtol below its reach instead of spinning to
    # DIVERGED_MAX_IT
    use_x64 = opts.get_bool("x64", True)
    dtype = torch.float64 if use_x64 else torch.float32
    rtol_clamped = False
    if not use_x64 and opts.get_float("ksp_rtol", 1.0e-5) < 1.0e-6:
        requested_rtol = opts.get_float("ksp_rtol", 1.0e-5)
        opts.set("ksp_rtol", "1e-6")
        rtol_clamped = True
        print(f"NOTICE: -ksp_rtol {requested_rtol:g} is below f32 reach; "
              "clamped to 1e-6 (run with -x64 1 — the default — for the "
              "reference's f64 verification)")

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"poissbox_tpu_torch demo: device={device} ({kind}), dtype={dtype}")

    grid = Grid3D((n, n, n), device=device)
    print(f"grid {n}^3 = {grid.ndof} DoF, deltas={grid.deltas}")
    counts = grid.dof_counts()
    assert sum(counts) == grid.ndof, (counts, grid.ndof)
    print(f"DoF distribution over {len(counts)} device(s): {counts} (sum ok)")

    A = make_laplacian_operator(grid)
    g = torch.Generator().manual_seed(opts.get_int("seed", 2026))
    x_exact = A.project(grid.random(g, dtype))   # random in [-1, 1), mean-free
    b = A(x_exact)

    # check_lapl: matvec vs the independent pointwise formulation, with
    # its scale and tolerance (the raw 2-norm grows as eps/dx^2 sqrt(ndof))
    delta = _norm(b - apply_laplacian_pointwise(x_exact, grid.deltas))
    tol = 1000 * float(torch.finfo(dtype).eps)
    b_scale = _norm(b)
    bound = tol * b_scale + tol
    ok = delta < bound
    print(f"check_lapl: ||matvec - pointwise||_2 = {delta:.3e} "
          f"(relative {delta / b_scale:.3e}, tol {bound:.3e} "
          f"= 1000*eps*||b||) — {'ok' if ok else 'FAIL'}")
    assert ok

    # check_matrices: every operator view agrees, the assembled
    # StencilMatrix and (on a CUDA device) the kernel included
    Ax = A(x_exact)
    views = {"pointwise": make_laplacian_operator(grid, impl="pointwise"),
             "roll": make_laplacian_operator(grid, impl="roll"),
             "assembled": assemble_laplacian(grid.n, grid.deltas, dtype, device)}
    if device.type == "cuda":
        views["cuda"] = make_laplacian_operator(grid, impl="cuda")
    ax_scale = _norm(Ax)
    for name, Ai in views.items():
        d = _norm(Ax - Ai(x_exact))
        print(f"check_matrices[{name}]: ||A x - P x||_2 = {d:.3e} "
              f"(relative {d / ax_scale:.3e}, tol {tol:.1e}) — "
              f"{'ok' if d < tol * ax_scale + tol else 'FAIL'}")
        assert d < tol * ax_scale + tol, (name, d)

    if not opts.has("ksp_type"):
        opts.set("ksp_type", "cg")     # the solver of record
    if not opts.has("pc_type"):
        opts.set("pc_type", "mg")
    sopts = SolverOptions.from_options(opts)
    t0 = time.perf_counter()
    res = solve(A, b, opts, grid=grid)   # synchronises before it returns
    dt = time.perf_counter() - t0

    true_res = _norm(A(res.x) - b)
    b_norm = _norm(b)
    err = _norm(res.x - x_exact)
    print(f"solve: {int(res.iterations)} iterations in {dt:.3f}s "
          f"({sopts.ksp_type}+{sopts.pc_type}, setup included)")
    clamped_note = " (rtol clamped to f32 reach)" if rtol_clamped else ""
    print(f"converged reason: {res.reason_enum().message}{clamped_note}")
    print(f"verification: ||Ax - b||_2 = {true_res:.6e} "
          f"(relative {true_res / b_norm:.3e}), ||x - x_exact||_2 = {err:.3e}")

    if opts.get_bool("options_error_if_unused"):
        opts.check_unused(error=True)
    else:
        for k in opts.unused_keys():
            print(f"WARNING: option -{k} was set but never used")
    return true_res / b_norm


def main(argv=None) -> int:
    opts = Options(sys.argv[1:] if argv is None else argv)
    run(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
