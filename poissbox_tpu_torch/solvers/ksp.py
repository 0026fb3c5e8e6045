"""Options-driven solver dispatch — the KSPSetFromOptions / KSPSolve analogue
(port of :mod:`poissbox_tpu.solvers.ksp`).

:func:`make_solver` assembles the pipeline from a :class:`SolverOptions`:
the preconditioner (none/jacobi/mg), the Krylov method (cg/fcg), the
stopping controls and the monitor. The other methods of the JAX package
raise ``NotImplementedError`` until their slice lands (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.mg import (
    MGConfig,
    _build_levels,
    make_mg_preconditioner,
    sweeps_for_level_rtol,
)
from poissbox_tpu_torch.solvers.result import SolveResult

Tensor = torch.Tensor

_NOT_PORTED = "is not ported yet; see ROADMAP.md queue 1"


def make_preconditioner(
    A: LinearOperator,
    opts: SolverOptions,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    dtype=torch.float64,
    device="cpu",
) -> Optional[Callable[[Tensor], Tensor]]:
    """Build the preconditioner closure selected by `pc_type`."""
    if opts.pc_type in ("none", ""):
        return None
    if opts.pc_type == "jacobi":
        if A.diagonal is None:
            raise ValueError("jacobi preconditioning needs an operator diagonal")
        inv_diag = 1.0 / A.diagonal()
        return lambda r: inv_diag * r
    if opts.pc_type == "fft":
        raise NotImplementedError(f"pc_type fft {_NOT_PORTED}")
    if opts.pc_type == "mg":
        if shape is None or deltas is None:
            raise ValueError("mg preconditioning needs the grid shape and deltas")
        smoother = opts.mg_levels_pc_type
        if opts.mg_levels_ksp_type == "chebyshev":
            smoother = "chebyshev"
        # `-mg_levels_ksp_rtol` / `_max_it` set a static sweep count; with
        # neither, -1 lets solvers.mg._resolve_sweeps pick the size-aware
        # default, so this entry point and MGConfig() build the same cycle
        rtol_set = opts.mg_levels_ksp_rtol > 0.0
        max_set = opts.mg_levels_ksp_max_it >= 0
        if rtol_set or max_set:
            lv_rtol = opts.mg_levels_ksp_rtol if rtol_set else 1.0e-4
            lv_max = opts.mg_levels_ksp_max_it if max_set else 3
            sweeps = sweeps_for_level_rtol(smoother, lv_rtol, lv_max)
        else:
            sweeps = -1
        if (opts.mg_cycle_dtype == "bfloat16" and opts.ksp_rtol < 1e-5
                and opts.ksp_type != "fcg"):
            import warnings
            warnings.warn(
                f"mg_cycle_dtype=bfloat16 with ksp_rtol={opts.ksp_rtol:g}: "
                "bf16 preconditioner noise stalls CG near 5e-6 relative; "
                "use -ksp_type fcg or ksp_rtol >= 1e-5",
                stacklevel=2)
        cfg = MGConfig(
            levels=opts.mg_levels,
            smoother=smoother,
            pre_smooth=sweeps,
            post_smooth=sweeps,
            damping=None if opts.mg_levels_damping == 1.0
            and opts.mg_levels_pc_type == "jacobi" else opts.mg_levels_damping,
            coarse=opts.mg_coarse_pc_type,
            transfers=opts.mg_transfers,
            impl=opts.mg_impl,
            cycles=opts.mg_cycles,
            cycle=opts.mg_cycle,
            dtype=opts.mg_cycle_dtype,
            pre_dtype=opts.mg_pre_dtype,
        )
        return make_mg_preconditioner(shape, deltas, cfg, dtype, device)
    raise ValueError(
        f"unknown pc_type {opts.pc_type!r} (expected none|jacobi|fft|mg)")


def make_solver(
    A: LinearOperator,
    opts: SolverOptions | Options | None = None,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    dtype=torch.float64,
    device="cpu",
    grid=None,
) -> Callable[..., SolveResult]:
    """Assemble a `solve(b, x0=None) -> SolveResult` closure."""
    if opts is None:
        opts = SolverOptions()
    elif isinstance(opts, Options):
        opts = SolverOptions.from_options(opts)
    if grid is not None:
        shape = grid.n if shape is None else shape
        deltas = grid.deltas if deltas is None else deltas
        device = grid.device
    if opts.ksp_type in ("pipecg", "gmres", "richardson", "fft"):
        raise NotImplementedError(f"ksp_type {opts.ksp_type} {_NOT_PORTED}")
    if opts.ksp_type not in ("cg", "fcg"):
        raise ValueError(f"unknown ksp_type {opts.ksp_type!r} "
                         "(expected cg|fcg|pipecg|gmres|richardson|fft)")
    M = make_preconditioner(A, opts, shape, deltas, dtype, device)

    def solver(b, x0=None):
        return cg(A, b, x0, M=M, rtol=opts.ksp_rtol, atol=opts.ksp_atol,
                  max_it=opts.ksp_max_it, norm_type=opts.ksp_norm_type,
                  flexible=opts.ksp_type == "fcg", monitor=opts.ksp_monitor)

    # the built preconditioner and configuration, for `-ksp_view`
    solver.M = M
    solver.opts = opts
    solver.shape = tuple(shape) if shape is not None else None
    return solver


def view(opts: SolverOptions, shape=None, M=None) -> str:
    """`-ksp_view`-style description of the assembled solver, with the MG
    cycle as resolved (auto sweep counts, level stack)."""
    lines = [
        "KSP Object:",
        f"  type: {opts.ksp_type}",
        f"  norm type: {opts.ksp_norm_type}",
        f"  tolerances: rtol={opts.ksp_rtol:g}, atol={opts.ksp_atol:g}, "
        f"max_it={opts.ksp_max_it}",
        "PC Object:",
        f"  type: {opts.pc_type}",
    ]
    cfg = getattr(M, "config", None)
    if opts.pc_type == "mg" and cfg is not None:
        lines += [
            f"  cycle: {cfg.cycle.upper()}({cfg.pre_smooth},"
            f"{cfg.post_smooth}) x{cfg.cycles}",
            f"  smoother: {cfg.smoother}"
            + (f" (damping {cfg.damping:g})" if cfg.damping else ""),
            f"  coarse solve: {cfg.coarse}",
            f"  transfers: {cfg.transfers}",
        ]
        if cfg.dtype or cfg.pre_dtype:
            lines.append(f"  cycle dtype: {cfg.dtype or 'field'}"
                         f" / pre-smooth {cfg.pre_dtype or 'cycle'}")
        if shape is not None:
            levels = _build_levels(tuple(shape), (1.0,) * 3, cfg)
            lines.append("  levels: "
                         + " -> ".join("x".join(map(str, lv.shape)) for lv in levels))
    return "\n".join(lines)


def solve(
    A: LinearOperator,
    b: Tensor,
    opts: SolverOptions | Options | None = None,
    x0: Optional[Tensor] = None,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    grid=None,
) -> SolveResult:
    """One-shot options-driven solve (KSPSolve analogue). Prints
    `-ksp_view`, `-ksp_monitor` and `-ksp_converged_reason` output when
    those flags are set. (`-log_view` is not ported yet.)"""
    db = opts if isinstance(opts, Options) else None
    if isinstance(opts, Options):
        opts = SolverOptions.from_options(opts)
    opts = opts or SolverOptions()
    solver = make_solver(A, opts, shape, deltas, b.dtype, b.device, grid=grid)
    if opts.ksp_view:
        print(view(opts, solver.shape, solver.M))
    result = solver(b, x0)
    if b.device.type == "cuda":
        torch.cuda.synchronize(b.device)
    if db is not None and (db.get_bool("options_left")
                           or db.get_bool("options_error_if_unused")):
        db.check_unused()
    if opts.ksp_converged_reason:
        r = result.reason_enum()
        print(f"Linear solve {r.message} (reason {r.name}, "
              f"iterations {int(result.iterations)})")
    return result
