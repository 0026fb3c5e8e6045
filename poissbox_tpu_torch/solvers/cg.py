"""Preconditioned conjugate gradients — the `-ksp_type cg` path (port of
:mod:`poissbox_tpu.solvers.cg`).

The JAX package runs the iteration inside ``lax.while_loop``; here it is
a Python loop on the host. Every value stays on the device: the breakdown
guards use ``torch.where``, and the loop reads one boolean per iteration
(the stopping test) with a single ``.item()``. The hooks a preconditioner
or operator binds — ``A.apply_dot``, ``A.fused_update``,
``A.pupdate_apply_dot``, ``M.apply_dots``, ``M.apply_update_dots`` — fold
reductions and the vector updates into the kernels' own passes, as in the
JAX package.

Over a process grid (an operator with ``A.allreduce``; JAX's psum is
implicit in GSPMD) the fields are rank blocks and every sum is a partial:
CG stacks the partials it needs at one point and all-reduces them once,
twice an iteration (pAp; then ||r||^2, sum(r), <r, M r>, sum(M r)
together), and every value the loop's stopping test reads is an
all-reduced one, so every rank takes the same decision.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.solvers.result import SolveResult, classify
from poissbox_tpu_torch.utils import debugging
from poissbox_tpu_torch.utils.logging import is_process0
from poissbox_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b)


def _sums(reduce, *vals):
    """The partial sums `vals` summed over every rank in ONE all-reduce of
    their stack (`reduce`, the operator's), Nones passed through; as they
    are on one device (reduce None)."""
    if reduce is None:
        return vals
    live = [v for v in vals if v is not None]
    it = iter(reduce(torch.stack(live)).unbind())
    return tuple(None if v is None else next(it) for v in vals)


def _monitor_print(k: int, rnorm: Tensor) -> None:
    """`-ksp_monitor` line in PETSc's format (synchronises), from process
    0 only (every rank holds the same all-reduced norm)."""
    if is_process0():
        print(f"  {int(k)} KSP Residual norm {float(rnorm):.12e}", flush=True)


def cg(
    A: LinearOperator,
    b: Tensor,
    x0: Optional[Tensor] = None,
    *,
    M: Optional[Callable[[Tensor], Tensor]] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 500,
    norm_type: str = "unpreconditioned",
    flexible: bool = False,
    monitor: bool = False,
) -> SolveResult:
    """Solve A x = b by (preconditioned) CG.

    Arguments as :func:`poissbox_tpu.solvers.cg.cg`: `norm_type`
    'unpreconditioned' monitors the true ||r||_2, 'natural' sqrt(|<r, M r>|);
    `flexible` takes the Polak-Ribiere beta (PETSc KSPFCG); `monitor`
    prints a `-ksp_monitor` line per iteration. `history[i]` is the
    monitored norm at iteration i, NaN past the final iteration.
    """
    if norm_type not in ("unpreconditioned", "natural"):
        raise ValueError(f"unknown norm_type {norm_type!r} "
                         "(expected unpreconditioned|natural)")
    b = A.project(b)
    precond = M if M is not None else (lambda v: v)
    natural = norm_type == "natural"
    if x0 is None:
        # zero-guess specialisation: r = b - A*0 = b, no matvec
        x = torch.zeros_like(b)
        r = b
    else:
        x = A.project(x0)
        with span("MatMult"):
            r = b - A(x)
    z = A.project(precond(r))
    p = z
    reduce = getattr(A, "allreduce", None)
    # |<r, z>|: the Laplacian here is negative definite; abs covers both
    # orientations and keeps rounding negatives from poisoning sqrt
    if natural:
        rz, = _sums(reduce, _dot(r, z))
        rnorm0 = bnorm = torch.sqrt(torch.abs(rz))
    else:
        rz, rr0, bb = _sums(reduce, _dot(r, z), _dot(r, r), _dot(b, b))
        rnorm0, bnorm = torch.sqrt(rr0), torch.sqrt(bb)

    hist = torch.full((max_it + 1,), float("nan"), dtype=b.dtype,
                      device=b.device)
    hist[0] = rnorm0
    if monitor:
        _monitor_print(0, rnorm0)

    atol_ = torch.tensor(atol, dtype=b.dtype, device=b.device)
    rtol_ = torch.tensor(rtol, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    # the canonical (mean-removal) projection is rank one, so it folds
    # into the reductions: <r, z> = <r, v> - mean(v) * sum(r), and the
    # search-direction update applies the mean shift inline; a custom
    # projector is applied explicitly instead
    project_z = A.nullspace is not None and getattr(
        A.nullspace, "is_constant_projector", False)
    explicit_proj = A.nullspace is not None and not project_z
    inv_n = 1.0 / (A.ndof or b.numel())
    # fused x/r update with the ||r||^2, sum(r) partials in its pass (K8)
    fuse_upd = getattr(A, "fused_update", None) is not None and b.dim() == 3
    # fused coupling reductions (<r, M r>, sum(M r)) from the V-cycle's
    # final post-smooth; not with an explicit projector or flexible CG
    apply_dots = (getattr(M, "apply_dots", None)
                  if not explicit_proj and not flexible else None)
    # full M-side fusion: r' = r - alpha*Ap, its reductions and the
    # coupling dots ride the V-cycle's kernels; supersedes fused_update
    # and apply_dots
    apply_upd_dots = (getattr(M, "apply_update_dots", None)
                      if not explicit_proj and not flexible
                      and b.dim() == 3 and reduce is None else None)
    # deferred search-direction update: p' = (v - zshift) + beta*p forms
    # inside the next iteration's matvec kernel (K12), so the loop carries
    # (v, beta, zshift) instead of p'; beta and zshift stay on the device
    defer_p = (getattr(A, "pupdate_apply_dot", None) is not None
               and b.dim() == 3)
    if defer_p and reduce is not None:
        raise NotImplementedError("the deferred p-update (K12) has no form "
                                  "across ranks (nor has it in the JAX package)")
    if defer_p:
        # the first direction, (z - 0) + 0 * 0 = z, formed in the kernel
        v_def, beta, zshift = z, zero, zero
        p = torch.zeros_like(b)

    resnorm = rnorm0
    k = 0
    while k < max_it:
        go = ((resnorm > rtol_ * bnorm) & (resnorm > atol_)
              & torch.isfinite(resnorm))
        if not debugging.proceed(go, resnorm, "fcg" if flexible else "cg", k):
            break
        with span("KSPIteration"):
            with span("MatMult"):
                if defer_p:
                    p, Ap, pAp = A.pupdate_apply_dot(v_def, p, beta, zshift)
                elif A.apply_dot is not None:
                    Ap, pAp = A.apply_dot(p)
                else:
                    Ap = A(p)
                    pAp = _dot(p, Ap)
            pAp, = _sums(reduce, pAp)
            # breakdown guard: pAp (or rz) vanishes once the residual is
            # rounding noise of the projected null space — stop with the
            # current iterate instead of dividing 0/0
            ok = (pAp != 0.0) & (rz != 0.0)
            alpha = torch.where(ok, rz / torch.where(ok, pAp, one), zero)
            if apply_upd_dots is not None:
                v, r, rr_k, sr, rv, sv = apply_upd_dots(r, Ap, alpha)
                rr = None if natural else rr_k
            else:
                if fuse_upd:
                    x, r, rr_k, sr_k = A.fused_update(alpha, x, p, r, Ap)
                else:
                    x = x + alpha * p
                    r = r - alpha * Ap
                    rr_k = sr_k = None
                # ||r||^2 and sum(r) from the fused update where it took them
                if apply_dots is not None:
                    v, rv, sv = apply_dots(r)
                    sr = torch.sum(r) if sr_k is None else sr_k
                    rr = None if natural else (_dot(r, r) if rr_k is None else rr_k)
                else:
                    v = precond(r)
                    if explicit_proj:
                        v = A.project(v)
                    if M is None and not explicit_proj:
                        rr = _dot(r, r) if rr_k is None else rr_k
                        rv, sv, sr = rr, (torch.sum(r) if sr_k is None else sr_k), None
                    else:
                        rv = _dot(r, v)
                        sv = torch.sum(v)
                        sr = torch.sum(r) if sr_k is None else sr_k
                        rr = None if natural else (_dot(r, r) if rr_k is None else rr_k)
            # beta_PR = <r_{k+1} - r_k, z_{k+1}> / rz_k = -alpha <Ap, z> / rz_k
            apz = _dot(Ap, v) if flexible else None
            sap = torch.sum(Ap) if flexible and project_z else None
            # the second reduction point: every partial of the step at once
            rr, sr, rv, sv, apz, sap = _sums(reduce, rr, sr, rv, sv, apz, sap)
            if project_z:
                rz_new = rv - sv * ((sv if sr is None else sr) * inv_n)
                zshift = sv * inv_n
            else:
                rz_new = rv
                zshift = zero
            if flexible:
                if project_z:
                    apz = apz - zshift * sap
                numer = -alpha * apz
            else:
                numer = rz_new
            beta = torch.where(ok, numer / torch.where(ok, rz, one), zero)
            norm = torch.sqrt(torch.abs(rz_new)) if natural else torch.sqrt(rr)
            resnorm = torch.where(ok, norm, zero)
            k += 1
            hist[k] = resnorm
            if monitor:
                _monitor_print(k, resnorm)
            if apply_upd_dots is not None:
                x = x + alpha * p
            if defer_p:
                v_def = v
            else:
                p = (v - zshift) + beta * p
            rz = rz_new

    reason = classify(resnorm, k, bnorm, rtol_, atol_, max_it)
    return SolveResult(
        x=A.project(x),
        iterations=torch.tensor(k, dtype=torch.int32),
        residual_norm=resnorm,
        history=hist,
        reason=reason,
    )
