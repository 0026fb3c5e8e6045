"""End-to-end demo (port of :mod:`poissbox_tpu.demo`): device report, grid
and operator setup, random solution, the operator self-checks, the
options-driven solve, and the final true-residual print.

  * check_grid ......... the device's DoF count is the global DoF count
  * check_lapl ......... matrix-free matvec == pointwise formulation
  * check_matrices ..... every operator view agrees, ||A x - P x||

    python -m poissbox_tpu_torch.demo -n 64 -device cuda \
        -ksp_rtol 1e-8 -ksp_monitor -ksp_converged_reason

`-device` is cuda (the default) or cpu; on cuda the operator and every MG
level run the hand-written kernels, and without a card it raises (the CPU
runs only when asked for, `-device cpu`). `-x64 0` runs in float32 (an rtol
below 1e-6 is then clamped to 1e-6, with a notice).

Across ranks, the reference's `mpirun -np 3` run:

    torchrun --nproc-per-node 3 -m poissbox_tpu_torch.demo -n 64 -device cpu

Each rank holds its owned box (64^3 on 3 ranks: 90112/86016/86016 DoF);
on cuda each rank takes card local_rank % device_count, over NCCL when
every rank has a card of its own and over gloo, staged through pinned host
buffers, when ranks share one. Process 0 prints; the self-checks compare
the distributed operator with the single-device views on the gathered
field.
"""

from __future__ import annotations

import sys
import time

import torch

import torch.distributed as dist

from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.mesh import Grid3D, init_process_group, world_size
from poissbox_tpu_torch.parallel.decomp import owned_boxes
from poissbox_tpu_torch.utils.logging import log0
from poissbox_tpu_torch.ops.assemble import assemble_laplacian
from poissbox_tpu_torch.ops.stencil import (
    apply_laplacian_pointwise,
    make_laplacian_operator,
)
from poissbox_tpu_torch.solvers.ksp import solve


def _norm(t: torch.Tensor, A=None) -> float:
    """||t||_2 over every rank's block (A's all-reduce) or of `t`."""
    if A is None or A.allreduce is None:
        return float(torch.linalg.vector_norm(t))
    return float(A.allreduce(torch.sum(t * t).reshape(1))) ** 0.5


def run(opts: Options) -> float:
    """Run the demo; returns the final relative true residual
    ||Ax - b|| / ||b||."""
    n = opts.get_int("n", 64)
    device = torch.device(opts.get_str("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda: torch.cuda.is_available() is False")
    init_process_group(device=device)     # torchrun's ranks; else a no-op
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
        log0(f"NOTICE: -ksp_rtol {requested_rtol:g} is below f32 reach; "
             "clamped to 1e-6 (run with -x64 1 — the default — for the "
             "reference's f64 verification)")

    grid = Grid3D((n, n, n), device=device).with_mesh()
    device = grid.device
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log0(f"poissbox_tpu_torch demo: {world_size()} rank(s), device={device} "
         f"({kind}), dtype={dtype}"
         + (f", backend {dist.get_backend()}" if grid.distributed else ""))
    log0(f"grid {n}^3 = {grid.ndof} DoF, deltas={grid.deltas}")
    counts = grid.dof_counts()
    assert sum(counts) == grid.ndof, (counts, grid.ndof)
    log0(f"DoF distribution over {len(counts)} device(s): {counts} (sum ok)")
    if grid.distributed:
        # the owned boxes tile the domain (check_linear_system)
        boxes = owned_boxes(grid.n, grid.pgrid)
        covered = sum(xn * yn * zn for (_, (xn, yn, zn)) in boxes.values())
        assert covered == grid.ndof
        log0(f"ownership: process grid {grid.pgrid}, {len(boxes)} boxes tile "
             "the domain (sum ok)")

    A = make_laplacian_operator(grid)
    g = torch.Generator().manual_seed(opts.get_int("seed", 2026))
    x_exact = A.project(grid.random(g, dtype))   # random in [-1, 1), mean-free
    b = A(x_exact)

    def view(fn):
        """A single-device view on the gathered field, cut to this rank's
        box (the view itself on one rank)."""
        if not grid.distributed:
            return fn
        return lambda x: grid.shard(fn(grid.unshard(x)))

    # check_lapl: matvec vs the independent pointwise formulation, with
    # its scale and tolerance (the raw 2-norm grows as eps/dx^2 sqrt(ndof))
    delta = _norm(b - view(lambda x: apply_laplacian_pointwise(x, grid.deltas))(x_exact), A)
    tol = 1000 * float(torch.finfo(dtype).eps)
    b_scale = _norm(b, A)
    bound = tol * b_scale + tol
    ok = delta < bound
    log0(f"check_lapl: ||matvec - pointwise||_2 = {delta:.3e} "
         f"(relative {delta / b_scale:.3e}, tol {bound:.3e} "
         f"= 1000*eps*||b||) — {'ok' if ok else 'FAIL'}")
    assert ok

    # check_matrices: every operator view agrees, the assembled
    # StencilMatrix and (on a CUDA device) the kernel included
    Ax = A(x_exact)
    one = Grid3D((n, n, n), device=device)
    views = {"pointwise": make_laplacian_operator(one, impl="pointwise"),
             "roll": make_laplacian_operator(one, impl="roll"),
             "assembled": assemble_laplacian(grid.n, grid.deltas, dtype, device)}
    if device.type == "cuda":
        views["cuda"] = make_laplacian_operator(one, impl="cuda")
    ax_scale = _norm(Ax, A)
    for name, Ai in views.items():
        d = _norm(Ax - view(Ai)(x_exact), A)
        log0(f"check_matrices[{name}]: ||A x - P x||_2 = {d:.3e} "
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

    true_res = _norm(A(res.x) - b, A)
    b_norm = _norm(b, A)
    err = _norm(res.x - x_exact, A)
    log0(f"solve: {int(res.iterations)} iterations in {dt:.3f}s "
         f"({sopts.ksp_type}+{sopts.pc_type}, setup included)")
    clamped_note = " (rtol clamped to f32 reach)" if rtol_clamped else ""
    log0(f"converged reason: {res.reason_enum().message}{clamped_note}")
    log0(f"verification: ||Ax - b||_2 = {true_res:.6e} "
         f"(relative {true_res / b_norm:.3e}), ||x - x_exact||_2 = {err:.3e}")

    if opts.get_bool("options_error_if_unused"):
        opts.check_unused(error=True)
    else:
        for k in opts.unused_keys():
            log0(f"WARNING: option -{k} was set but never used")
    return true_res / b_norm


def main(argv=None) -> int:
    opts = Options(sys.argv[1:] if argv is None else argv)
    try:
        run(opts)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
