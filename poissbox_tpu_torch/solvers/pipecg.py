"""Pipelined conjugate gradients — the `-ksp_type pipecg` path (port of
:mod:`poissbox_tpu.solvers.pipecg`).

Ghysels & Vanroose's single-reduction CG (PETSc's KSPPIPECG): the
iteration's reduction group (<r, u>, <w, u>, ||r||^2) is independent of
its operator applications (m = M w, n = A m), and only one such group
remains per iteration. The price is four extra recurrence vectors (z, q,
s, p beside x, r, u, w). On one card that trade buys nothing: plain `cg`
stays the default; `pipecg` is for meshes where reduction latency
dominates.

As in :mod:`poissbox_tpu_torch.solvers.cg`, the loop runs on the host and
reads one boolean per iteration (the stopping test) with a single
``.item()``; every scalar stays on the device. The residual is kept by
recurrence one step further from the truth than CG's, so its rounding
drift is larger: check the true residual as well as the monitored norm.

Over a process grid (``A.allreduce``) the fields are rank blocks: the
partial sums of each reduction point go out stacked in ONE all-reduce
(at the start <r, u>, <w, u>, ||r||^2, ||b||^2; then <r, u>, <w, u>,
||r||^2 an iteration), and the stopping test reads only reduced values.
The JAX package has no overlap of that all-reduce with M and A either:
the iterates are its recurrence's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.solvers.cg import _dot, _monitor_print, _sums
from poissbox_tpu_torch.solvers.result import SolveResult, classify
from poissbox_tpu_torch.utils import debugging

Tensor = torch.Tensor


def pipecg(
    A: LinearOperator,
    b: Tensor,
    x0: Optional[Tensor] = None,
    *,
    M: Optional[Callable[[Tensor], Tensor]] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 500,
    norm_type: str = "unpreconditioned",
    monitor: bool = False,
) -> SolveResult:
    """Solve A x = b by pipelined preconditioned CG.

    Arguments as :func:`poissbox_tpu.solvers.pipecg.pipecg`:
    'unpreconditioned' monitors the recurrence ||r||_2 relative to ||b||,
    'natural' sqrt(|<r, M r>|). There is no flexible variant: the
    pipelining identity fixes the Fletcher-Reeves beta.
    """
    if norm_type not in ("unpreconditioned", "natural"):
        raise ValueError(f"unknown norm_type {norm_type!r} "
                         "(expected unpreconditioned|natural)")
    natural = norm_type == "natural"
    b = A.project(b)
    precond = M if M is not None else (lambda v: v)

    def Mp(v: Tensor) -> Tensor:
        # every preconditioned vector is projected (MatNullSpace semantics)
        return A.project(precond(v))

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = A.project(x0)
        r = b - A(x)
    u = Mp(r)
    w = A(u)
    reduce = getattr(A, "allreduce", None)
    gamma, delta, rr, bb = _sums(reduce, _dot(r, u), _dot(w, u),
                                 None if natural else _dot(r, r),
                                 None if natural else _dot(b, b))
    rnorm0 = torch.sqrt(torch.abs(gamma)) if natural else torch.sqrt(rr)
    # natural norm: the initial natural residual stands in for ||b||_M
    bnorm = rnorm0 if natural else torch.sqrt(bb)

    hist = torch.full((max_it + 1,), float("nan"), dtype=b.dtype,
                      device=b.device)
    hist[0] = rnorm0
    if monitor:
        _monitor_print(0, rnorm0)

    atol_ = torch.tensor(atol, dtype=b.dtype, device=b.device)
    rtol_ = torch.tensor(rtol, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    # z, q, s, p start at zero: with beta = 0 the first iteration gives
    # z = n, q = m, s = w, p = u
    z = q = s = p = torch.zeros_like(b)
    gamma_old = alpha_old = zero
    resnorm = rnorm0
    k = 0
    while k < max_it:
        go = ((resnorm > rtol_ * bnorm) & (resnorm > atol_)
              & torch.isfinite(resnorm))
        if not debugging.proceed(go, resnorm, "pipecg", k):
            break
        m = Mp(w)
        n = A(m)
        # k = 0: beta = 0, alpha = gamma / delta; then beta = gamma_k /
        # gamma_{k-1}, alpha = gamma / (delta - beta * gamma / alpha_{k-1})
        if k == 0:
            beta = zero
        else:
            beta = torch.where(gamma_old == 0.0, zero,
                               gamma / torch.where(gamma_old == 0.0, one, gamma_old))
        denom = delta - beta * gamma / torch.where(alpha_old == 0.0, one, alpha_old)
        # breakdown guard as in cg
        ok = (denom != 0.0) & (gamma != 0.0)
        alpha = torch.where(ok, gamma / torch.where(ok, denom, one), zero)
        z = n + beta * z          # z = A q
        q = m + beta * q          # q = M s
        s = w + beta * s          # s = A p
        p = u + beta * p
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        gamma_old = gamma
        # the iteration's one reduction point
        gamma, delta, rr = _sums(reduce, _dot(r, u), _dot(w, u),
                                 None if natural else _dot(r, r))
        norm = torch.sqrt(torch.abs(gamma)) if natural else torch.sqrt(rr)
        resnorm = torch.where(ok, norm, zero)
        alpha_old = alpha
        k += 1
        hist[k] = resnorm
        if monitor:
            _monitor_print(k, resnorm)

    reason = classify(resnorm, k, bnorm, rtol_, atol_, max_it)
    return SolveResult(
        x=A.project(x),
        iterations=torch.tensor(k, dtype=torch.int32),
        residual_norm=resnorm,
        history=hist,
        reason=reason,
    )
