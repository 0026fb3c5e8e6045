"""Restarted GMRES — PETSc's default KSP type, reached whenever
`-ksp_type` is not given (port of :mod:`poissbox_tpu.solvers.gmres`) —
and its flexible variant, `-ksp_type fgmres` (PETSc's KSPFGMRES; the JAX
package has none).

Left-preconditioned GMRES(m) with a stacked (m+1, *field) Krylov basis on
the device, classical Gram-Schmidt (once, PETSc's default) against the
rows built so far, and Givens rotations. Step j's coefficients h = V[:j+1] w
and its new row w - h V[:j+1] are two kernels that read rows 0..j only
(:mod:`poissbox_tpu_torch.ops.gmres_cuda`; the JAX package's `tensordot`s
run over the whole zero-padded basis), so the basis is never zero-filled:
nothing reads a row before it is written. The JAX package
masks the steps of a cycle after convergence inside a fixed-length
`fori_loop`; here the host loop stops the cycle at the first masked step,
which gives the same history and iteration count. Each step copies the
new Hessenberg column (j + 2 numbers at step j) to the host, the loop's one
synchronisation; the rotations and the triangular solve run there, in the
field dtype. A cycle ends with x += V[:j] y, by the same update kernel.

Flexible GMRES (Saad, SIAM J. Sci. Comput. 14 (1993) 461-469) shares that
step with the preconditioner moved to the right: step j stores
z_j = M v_j in a second stacked basis Z of m fields, orthogonalises A z_j
against V, and a cycle ends with x += Z[:j] y. M may change from one
application to the next (a bf16 pre-smooth is not linear), and the
residual it monitors is the unpreconditioned one, relative to ||b||.
Before it reports convergence it forms x, computes the true residual
b - A x with one operator apply, reports that norm, and restarts from that
residual where it misses the target (within `max_it`).

The spans `KSPGMRESOrthog` (a step's two kernels, its norm and its
normalisation) and `KSPGMRESBuildSoln` (forming x at a cycle's end) are
PETSc's event names; the counters `KSPGMRESOrthog.steps` and
`KSPGMRESOrthog.rows` (the rows built when each step ran, j + 1 at step j)
count in :func:`poissbox_tpu_torch.utils.profiling.count` beside them.

Over a process grid (``A.allreduce``) the fields are rank blocks and the
basis holds this rank's block of every vector: the initial norms go out
in one all-reduce, a restart's norm in one, and a Gram-Schmidt step takes
two, as the JAX package's two psums: the local coefficients h (with
K2's partial <V_j, A V_j> stacked on them on the fused path), then
||w - h V||^2. FGMRES adds one all-reduce a cycle, its true residual's
norm. Every rank then holds the same column, so the host's rotations and
every stopping decision agree; the restart length is agreed too
(:func:`clamp_restart`).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.mesh import ranks_on_device
from poissbox_tpu_torch.ops.gmres_cuda import gs_dots, gs_update_norm
from poissbox_tpu_torch.solvers.cg import _dot, _monitor_print, _sums
from poissbox_tpu_torch.solvers.result import SolveResult, classify
from poissbox_tpu_torch.utils import debugging
from poissbox_tpu_torch.utils.profiling import count, span

Tensor = torch.Tensor

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _basis_budget_bytes(device=None) -> int:
    """Device-memory budget for the Krylov bases: half of the card's
    memory, shared by the ranks on that card, 4 GiB elsewhere. The stacked
    bases are GMRES's dominant allocation; the rest is left to the
    operator, the preconditioner and the caller's fields."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.mem_get_info(device)[1] // 2 // ranks_on_device(device)
    return 4 << 30


def clamp_restart(restart: int, b: Tensor, budget_bytes=None,
                  allreduce_max=None, flexible: bool = False) -> int:
    """Shrink the restart length so that the stacked bases fit the
    budget, with a warning (more restarts, same convergence semantics).
    GMRES(m) holds m+1 fields, FGMRES(m) with a preconditioner 2m+1 (V and
    Z): at 512^3 f32, GMRES(30) needs 16.6 GB and FGMRES(30) 32.7 GB.

    Over a process grid pass the operator's `allreduce_max`: every rank
    then takes the largest box against the smallest budget, so all take
    the same length (a rank that restarted alone would leave the others
    in the next all-reduce) and warn alike."""
    budget = (_basis_budget_bytes(b.device) if budget_bytes is None
              else int(budget_bytes))
    field = b.numel() * b.element_size()
    if allreduce_max is not None:
        v = allreduce_max(torch.tensor([field, -budget], dtype=torch.float64,
                                       device=b.device))
        field, budget = int(v[0]), -int(v[1])
    fields = budget // max(field, 1)
    max_m = max(1, (fields - 1) // 2 if flexible else fields - 1)
    if restart > max_m:
        name, need = ("fgmres", 2 * restart + 1) if flexible else ("gmres", restart + 1)
        warnings.warn(
            f"{name}: restart {restart} needs {need * field / 2**30:.1f}"
            f" GiB of Krylov basis (> {budget / 2**30:.1f} GiB budget); "
            f"shrunk to restart={max_m}", RuntimeWarning, stacklevel=3)
        return max_m
    return restart


def gmres(
    A: LinearOperator,
    b: Tensor,
    x0: Optional[Tensor] = None,
    *,
    M: Optional[Callable[[Tensor], Tensor]] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 1000,
    restart: int = 30,
    monitor: bool = False,
    flexible: bool = False,
) -> SolveResult:
    """Solve A x = b by restarted GMRES(restart): left-preconditioned, or
    with `flexible` right-preconditioned FGMRES(restart).

    GMRES monitors the preconditioned residual norm (PETSc's default for
    left preconditioning), relative to ||M b||; FGMRES the unpreconditioned
    one, relative to ||b||, and it reports the true residual's norm (see
    the module docstring). The history has one entry per inner iteration.
    As in the JAX package, a cycle runs to its end (or convergence) even
    past `max_it`; its later entries fall off the end of the history.
    """
    name = "fgmres" if flexible else "gmres"
    reduce = getattr(A, "allreduce", None)
    zbasis = flexible and M is not None      # Z apart from V
    m = clamp_restart(int(restart), b,
                      allreduce_max=getattr(A, "allreduce_max", None)
                      if reduce is not None else None, flexible=zbasis)
    x = torch.zeros_like(b) if x0 is None else x0
    b = A.project(b)
    x = A.project(x)
    precond = M if M is not None else (lambda v: v)
    ft = _NP[b.dtype]

    def pres(v: Tensor) -> Tensor:
        return A.project(precond(v))

    # the residual the method monitors: M r (GMRES) or r itself (FGMRES)
    left = A.project if flexible else pres

    def residual(x: Tensor) -> tuple[Tensor, Tensor]:
        """x's monitored residual and its norm (one all-reduce)."""
        with span("MatMult"):
            r = b - A(x)
        r = left(r)
        rr, = _sums(reduce, _dot(r, r))
        return r, torch.sqrt(rr)

    with span("MatMult"):
        r0 = b - A(x)
    r0 = left(r0)
    pb = left(b)
    rr0, pbb = _sums(reduce, _dot(r0, r0), _dot(pb, pb))
    rnorm0_t, bnorm_t = torch.sqrt(rr0), torch.sqrt(pbb)
    with span("KSPSync"):
        rnorm0, bnorm = ft(rnorm0_t.item()), ft(bnorm_t.item())
    debugging.check_norm(rnorm0, name, 0)
    hist = [rnorm0]
    if monitor:
        _monitor_print(0, rnorm0)
    tiny = ft(np.finfo(ft).tiny)
    target = max(ft(rtol) * bnorm, ft(atol))
    use_fused = M is None and A.apply_dot is not None

    # uninitialised: step j reads rows 0..j, each written before
    V = torch.empty((m + 1,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    Z = (torch.empty((m,) + tuple(b.shape), dtype=b.dtype, device=b.device)
         if zbasis else V)
    resnorm, k = rnorm0, 0
    r, beta_t = r0, rnorm0_t
    while resnorm > target and np.isfinite(resnorm) and k < max_it:
        if r is None:
            r, beta_t = residual(x)      # a restart's (preconditioned) residual
        torch.div(r, torch.clamp(beta_t, min=float(tiny)), out=V[0])
        with span("KSPSync"):
            beta = ft(beta_t.item())
        H = np.zeros((m + 1, m), dtype=ft)
        cs = np.zeros(m, dtype=ft)
        sn = np.zeros(m, dtype=ft)
        g = np.zeros(m + 1, dtype=ft)
        g[0] = beta
        resnorm, jdone = beta, 0
        debugging.check_norm(resnorm, name, k)
        for j in range(m):
            if not resnorm > target:
                break            # the JAX package's masked steps
            with span("KSPIteration"):
                if use_fused:
                    # unpreconditioned: K2 returns <V_j, A V_j>, the j-th
                    # Gram-Schmidt coefficient (V_j is mean-free, so the
                    # projection does not change it)
                    with span("MatMult"):
                        Av, vAv = A.apply_dot(V[j])
                    w = A.project(Av)
                elif zbasis:
                    Z[j] = pres(V[j])
                    with span("MatMult"):
                        w = A(Z[j])
                    w = A.project(w)
                else:
                    with span("MatMult"):
                        w = A(V[j])
                    w = pres(w)
                with span("KSPGMRESOrthog"):
                    count("KSPGMRESOrthog.steps")
                    count("KSPGMRESOrthog.rows", j + 1)
                    h = gs_dots(V, j + 1, w)
                    if reduce is not None:
                        # this rank's coefficients (and K2's partial) summed
                        # over every rank in one all-reduce
                        h = reduce(torch.cat([h, vAv.reshape(1)]) if use_fused else h)
                        if use_fused:
                            h, vAv = h[:-1], h[-1]
                    if use_fused:
                        h[j] = vAv
                    ww, = _sums(reduce, gs_update_norm(V, j + 1, h, w, V[j + 1]))
                    hnext_t = torch.sqrt(ww)
                    V[j + 1].div_(torch.clamp(hnext_t, min=float(tiny)))
                with span("KSPSync"):
                    col = torch.cat([h, hnext_t.reshape(1)]).cpu().numpy().astype(ft)
                hcol = np.zeros(m + 1, dtype=ft)
                hcol[:j + 2] = col
                # the accumulated rotations on the new column
                for i in range(j):
                    hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                    hip = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                    hcol[i], hcol[i + 1] = hi, hip
                denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                cs[j] = hcol[j] / max(denom, tiny)
                sn[j] = hcol[j + 1] / max(denom, tiny)
                hcol[j] = cs[j] * hcol[j] + sn[j] * hcol[j + 1]
                hcol[j + 1] = 0.0
                gj = g[j]
                g[j] = cs[j] * gj
                g[j + 1] = -sn[j] * gj
                resnorm = abs(g[j + 1])
                H[:, j] = hcol
                jdone = j + 1
                k += 1
                debugging.check_norm(resnorm, name, k)
                if k <= max_it:
                    hist.append(resnorm)
                if monitor:
                    _monitor_print(k, resnorm)
        with span("KSPGMRESBuildSoln"):
            # the upper-triangular system H[:j, :j] y = g[:j] of the steps
            # taken, then x += V[:j] y (GMRES) or Z[:j] y (FGMRES)
            if jdone:
                y = torch.linalg.solve_triangular(
                    torch.from_numpy(H[:jdone, :jdone]),
                    torch.from_numpy(g[:jdone, None]), upper=True)[:, 0]
                xn = torch.empty_like(x)
                gs_update_norm(Z, jdone, (-y).to(b.device), x, xn)
                x = A.project(xn)
        r = None
        if flexible:
            # the true residual: the norm reported, and a restart's start
            r, beta_t = residual(x)
            with span("KSPSync"):
                resnorm = ft(beta_t.item())
            debugging.check_norm(resnorm, name, k)

    hist_t = torch.full((max_it + 1,), float("nan"), dtype=b.dtype,
                        device=b.device)
    hist_t[:len(hist)] = torch.tensor(np.asarray(hist, dtype=ft),
                                      device=b.device)
    resnorm_t = torch.tensor(resnorm, dtype=b.dtype, device=b.device)
    rtol_ = torch.tensor(rtol, dtype=b.dtype, device=b.device)
    atol_ = torch.tensor(atol, dtype=b.dtype, device=b.device)
    reason = classify(resnorm_t, k, bnorm_t, rtol_, atol_, max_it)
    return SolveResult(x, torch.tensor(k, dtype=torch.int32), resnorm_t,
                       hist_t, reason)
