"""Options-driven solver dispatch — the KSPSetFromOptions / KSPSolve analogue
(port of :mod:`poissbox_tpu.solvers.ksp`).

:func:`make_solver` assembles the pipeline from a :class:`SolverOptions`:
the preconditioner (none/jacobi/fft/mg), the method (cg/fcg, pipecg,
gmres — PETSc's default and so the default here — fgmres, richardson, or
the FFT direct solve), the stopping controls and the monitor. Solvers are built
for the card unless `device` (or the grid's device) says otherwise; a
request for the card without one raises. Over a process grid (an operator
with ``allreduce``) every type runs on rank blocks, and so does
`-log_view`: every rank times its events together, the table takes the
slowest rank's times and the global DoF count, and process 0 prints it.
"""

from __future__ import annotations

import collections
import contextlib
import io
import time
import warnings
from typing import Callable, Optional, Sequence

import torch

from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.fft import fft_solver_result, make_fft_preconditioner
from poissbox_tpu_torch.solvers.gmres import gmres
from poissbox_tpu_torch.solvers.mg import (
    MGConfig,
    _build_levels,
    auto_bf16_presmooth,
    make_mg_preconditioner,
    sweeps_for_level_rtol,
)
from poissbox_tpu_torch.solvers.pipecg import pipecg
from poissbox_tpu_torch.solvers.result import SolveResult
from poissbox_tpu_torch.solvers.richardson import richardson
from poissbox_tpu_torch.utils.logging import is_process0
from poissbox_tpu_torch.utils import profiling
from poissbox_tpu_torch.utils.profiling import kernel_time, span

Tensor = torch.Tensor


def make_preconditioner(
    A: LinearOperator,
    opts: SolverOptions,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    dtype=torch.float64,
    device="cuda",
    grid=None,
) -> Optional[Callable[[Tensor], Tensor]]:
    """Build the preconditioner closure selected by `pc_type` (over a
    process grid the V-cycle's fine levels are distributed over `grid`,
    and fft is the pencil FFT on rank blocks)."""
    if opts.pc_type in ("none", ""):
        return None
    if opts.pc_type == "jacobi":
        if A.diagonal is None:
            raise ValueError("jacobi preconditioning needs an operator diagonal")
        inv_diag = 1.0 / A.diagonal()

        def jacobi(r):
            with span("PCApply", r):
                return inv_diag * r
        return jacobi
    if opts.pc_type == "fft":
        # the exact periodic 7-point inverse as a spectrally equivalent
        # preconditioner (for the compact 6th-order system)
        if deltas is None:
            raise ValueError("fft preconditioning needs the grid deltas")
        return make_fft_preconditioner(deltas, grid)
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
            warnings.warn(
                f"mg_cycle_dtype=bfloat16 with ksp_rtol={opts.ksp_rtol:g}: "
                "bf16 preconditioner noise stalls CG near 5e-6 relative; "
                "use -ksp_type fcg or ksp_rtol >= 1e-5",
                stacklevel=2)
        pre_dtype = opts.mg_pre_dtype
        if opts.ksp_type in ("gmres", "pipecg"):
            # GMRES stops on its estimate of ||M r||, and PIPECG on a
            # residual kept by a recurrence through M; both hold only for
            # a linear M, and a bf16 pre-smooth is not one: at 512^3 f32
            # on an H100 the JAX package's default bf16 pre-smooth left a
            # true residual of 7e-4 behind GMRES's estimate converged to
            # 1e-6, and PIPECG ran to its 50 iterations at 8.4e-5 (PERF.md).
            # So both keep the automatic pre-smooth in float32, and warn
            # on a bf16 one asked for. FGMRES takes any M and stops on the
            # true residual: it keeps the automatic pre-smooth, as CG does.
            if "bfloat16" in (opts.mg_pre_dtype, opts.mg_cycle_dtype):
                warnings.warn(
                    "a bf16 MG pre-smooth or cycle is not a linear "
                    f"preconditioner: {opts.ksp_type.upper()}'s residual "
                    "estimate can then stop far above the true residual; "
                    "use -ksp_type cg or fcg", stacklevel=2)
            elif auto_bf16_presmooth(MGConfig(dtype=opts.mg_cycle_dtype,
                                              pre_dtype=pre_dtype), shape, dtype):
                pre_dtype = "float32"
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
            pre_dtype=pre_dtype,
        )
        return make_mg_preconditioner(shape, deltas, cfg, dtype, device,
                                      grid=grid)
    raise ValueError(
        f"unknown pc_type {opts.pc_type!r} (expected none|jacobi|fft|mg)")


def make_solver(
    A: LinearOperator,
    opts: SolverOptions | Options | None = None,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    dtype=torch.float64,
    device="cuda",
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
    if opts.ksp_type not in ("cg", "fcg", "pipecg", "gmres", "fgmres", "richardson",
                             "fft"):
        raise ValueError(f"unknown ksp_type {opts.ksp_type!r} "
                         "(expected cg|fcg|pipecg|gmres|fgmres|richardson|fft)")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_solver(device={str(device)!r}) needs a CUDA "
                           "device; torch.cuda.is_available() is False")
    common = dict(rtol=opts.ksp_rtol, atol=opts.ksp_atol,
                  max_it=opts.ksp_max_it, monitor=opts.ksp_monitor)
    if opts.ksp_type == "fft":
        # a direct solve takes no preconditioner: skip the MG setup
        if deltas is None:
            raise ValueError("fft direct solve needs the grid deltas")
        M = None

        def method(b, x0=None):
            return fft_solver_result(A, b, deltas, grid)
    else:
        M = make_preconditioner(A, opts, shape, deltas, dtype, device, grid)

        if opts.ksp_type in ("cg", "fcg"):
            def method(b, x0=None):
                return cg(A, b, x0, M=M, norm_type=opts.ksp_norm_type,
                          flexible=opts.ksp_type == "fcg", **common)
        elif opts.ksp_type == "pipecg":
            def method(b, x0=None):
                return pipecg(A, b, x0, M=M, norm_type=opts.ksp_norm_type,
                              **common)
        elif opts.ksp_type in ("gmres", "fgmres"):
            def method(b, x0=None):
                return gmres(A, b, x0, M=M, restart=opts.gmres_restart,
                             flexible=opts.ksp_type == "fgmres", **common)
        else:
            def method(b, x0=None):
                return richardson(A, b, x0, M=M, **common)

    def solver(b, x0=None):
        with span("KSPSolve", b):
            return method(b, x0)

    # the built preconditioner and configuration, for `-ksp_view`
    solver.M = M
    solver.opts = opts
    solver.shape = tuple(shape) if shape is not None else None
    return solver


def view(opts: SolverOptions, shape=None, M=None) -> str:
    """`-ksp_view`-style description of the assembled solver, with the MG
    cycle as resolved (auto sweep counts, level stack; the JAX package's
    lines, then the transfer form and pre-smooth dtype the device
    resolved)."""
    lines = [
        "KSP Object:",
        f"  type: {opts.ksp_type}",
        f"  norm type: {opts.ksp_norm_type}",
        f"  tolerances: rtol={opts.ksp_rtol:g}, atol={opts.ksp_atol:g}, "
        f"max_it={opts.ksp_max_it}",
    ]
    if opts.ksp_type in ("gmres", "fgmres"):
        lines.append(f"  restart: {opts.gmres_restart}")
    lines += ["PC Object:", f"  type: {opts.pc_type}"]
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
        res = getattr(M, "resolved", None)
        if res is not None:
            lines.append(f"  resolved: transfers {res['transfers']}, "
                         f"pre-smooth {res['pre_dtype']}")
    return "\n".join(lines)


def _print_log_view(A: LinearOperator, b: Tensor, M, result,
                    t_setup: float, t_solve: float, logged: list) -> None:
    """`-log_view` analogue: PETSc's per-event performance summary
    (count, time/call, total, fraction), as the JAX package prints it,
    then the logged solve's spans.

    The events are not timed inside the solve: each event's time/call is
    measured standalone by the differenced protocol
    (:func:`poissbox_tpu_torch.utils.profiling.kernel_time`, chained
    applications decayed by 1e-3 so the values stay finite) and multiplied
    by its count, the number of its spans in the logged solve (`logged`,
    its span records): the operator applications the Krylov loop made, and
    the preconditioner applications (CG applies M once more than it
    iterates: its last iteration applies M before the stopping test reads
    the norm). The rest of the warm solve wall ("other") is the vector
    algebra, the reductions, the host loop and the fused hooks' gain or
    loss against the standalone events. Under the table, the logged
    solve's spans by name: count, host ms, self host ms and device ms
    (process 0's; "-" off the card).

    Over a process grid every rank runs this together (MatMult and PCApply
    exchange faces): each time is the slowest rank's (``A.allreduce_max``),
    an event that one rank cannot time is dropped on every rank, the DoF
    count is the global one, and process 0 prints.
    """
    reduce_max = getattr(A, "allreduce_max", None)

    def slowest(*vals: float) -> list:
        if reduce_max is None:
            return list(vals)
        return reduce_max(torch.tensor(vals, dtype=torch.float64,
                                       device=b.device)).tolist()

    def _warm_time(name, fn):
        try:
            t = kernel_time(fn, b, lo=2, hi=8, scale=1e-3, reduce_max=reduce_max)
        except (RuntimeError, ValueError) as err:
            # an event that cannot run alone is left out of the table
            print(f"log_view:   {name} not timed: {err}")
            t = None
        # the verdict is every rank's: none waits on a collective that
        # another has skipped
        if slowest(float(t is None))[0]:
            return None
        return t

    it = max(int(result.iterations), 1)
    counts = collections.Counter(s["name"] for s in logged)
    events = []
    t_mat = _warm_time("MatMult", A.apply)
    if t_mat is not None:
        events.append(("MatMult", counts["MatMult"], t_mat))
    if M is not None:
        t_pc = _warm_time("PCApply", M)
        if t_pc is not None:
            events.append(("PCApply", counts["PCApply"], t_pc))
    t_setup, t_solve = slowest(t_setup, t_solve)
    if not is_process0():
        return
    ndof = A.ndof or b.numel()
    print("log_view: event        count   time/call        total   %solve")
    accounted = 0.0
    for name, count, tc in events:
        tot = count * tc
        accounted += tot
        print(f"log_view:   {name:<10} {count:5d}   {tc * 1e3:9.3f} ms"
              f"   {tot:8.4f} s   {100.0 * tot / max(t_solve, 1e-12):5.1f}%")
    if events:
        rest = t_solve - accounted
        print(f"log_view:   {'other':<10} {'':5}   {'':12}"
              f"   {rest:8.4f} s   {100.0 * rest / max(t_solve, 1e-12):5.1f}%"
              "  (vector algebra, reductions, fusion/overlap delta)")
    print(f"log_view:   {'setup':<10} {1:5d}   {'':12}   {t_setup:8.4f} s")
    print(f"log_view:   {'solve':<10} {1:5d}   {'':12}   {t_solve:8.4f} s"
          f"   ({int(result.iterations)} iterations, "
          f"{t_solve / it * 1e3:.3f} ms/it, "
          f"{ndof * it / max(t_solve, 1e-12) / 1e9:.2f} GDoF/s of {ndof} DoF)")
    by_name = {}
    for s in sorted(logged, key=lambda s: s["id"]):
        row = by_name.setdefault(s["name"], [0, 0.0, 0.0, None])
        row[0] += 1
        row[1] += s["host_ms"]
        row[2] += s["self_host_ms"]
        if s["device_ms"] is not None:
            row[3] = (row[3] or 0.0) + s["device_ms"]
    print(f"log_view: span {'name':<13} {'count':>5} {'host ms':>12} "
          f"{'self host ms':>12} {'device ms':>12}")
    for name, (count, host, self_host, dev) in by_name.items():
        dev_s = "-" if dev is None else f"{dev:.3f}"
        print(f"log_view: span {name:<13} {count:5d} {host:12.3f} "
              f"{self_host:12.3f} {dev_s:>12}")


def _sync(t: Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


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
    `-ksp_view`, `-ksp_monitor`, `-ksp_converged_reason` and `-log_view`
    output when those flags are set. With `-log_view` the solve runs a
    second time, warm (kernels built, caches filled), its spans recorded,
    and that solve's wall and spans are the table's; the result returned
    is the first solve's."""
    db = opts if isinstance(opts, Options) else None
    if isinstance(opts, Options):
        opts = SolverOptions.from_options(opts)
    opts = opts or SolverOptions()
    log_view = db is not None and db.get_bool("log_view")
    t0 = time.perf_counter()
    solver = make_solver(A, opts, shape, deltas, b.dtype, b.device, grid=grid)
    t_setup = time.perf_counter() - t0
    if opts.ksp_view and is_process0():
        print(view(opts, solver.shape, solver.M))
    result = solver(b, x0)
    _sync(b)
    if log_view:
        # the same solver again, its spans recorded and its monitor's
        # second history discarded
        with contextlib.redirect_stdout(io.StringIO()), profiling.recording():
            t0 = time.perf_counter()
            solver(b, x0)
            _sync(b)
        t_solve = time.perf_counter() - t0
        recs = profiling.spans()      # the logged solve's root closed last
        logged = [s for s in recs if s["solve"] == recs[-1]["id"]]
        _print_log_view(A, b, solver.M, result, t_setup, t_solve, logged)
    if db is not None and (db.get_bool("options_left")
                           or db.get_bool("options_error_if_unused")):
        db.check_unused()
    if not is_process0():     # every rank holds the same reduced values
        return result
    if opts.ksp_monitor and opts.ksp_type == "fft":
        # the direct solve has no iterations: its one-line residual
        # history, printed after the solve
        for line in result.monitor_lines():
            print(line)
    if opts.ksp_converged_reason:
        r = result.reason_enum()
        print(f"Linear solve {r.message} (reason {r.name}, "
              f"iterations {int(result.iterations)})")
    return result
