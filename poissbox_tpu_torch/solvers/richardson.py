"""Damped (preconditioned) Richardson iteration — the `-ksp_type richardson`
path (port of :mod:`poissbox_tpu.solvers.richardson`).

x <- x + omega * M(b - A x); with M one V-cycle this is the stationary
multigrid iteration. A host loop reading one boolean per iteration, as
:mod:`poissbox_tpu_torch.solvers.cg`. Over a process grid
(``A.allreduce``) the initial ||r||^2 and ||b||^2 go out in one
all-reduce, then one ||r||^2 a step, so every rank stops together.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.solvers.cg import _dot, _monitor_print, _sums
from poissbox_tpu_torch.solvers.result import SolveResult, classify
from poissbox_tpu_torch.utils import debugging

Tensor = torch.Tensor


def richardson(
    A: LinearOperator,
    b: Tensor,
    x0: Optional[Tensor] = None,
    *,
    M: Optional[Callable[[Tensor], Tensor]] = None,
    omega: float = 1.0,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 100,
    monitor: bool = False,
) -> SolveResult:
    """Solve A x = b by damped preconditioned Richardson iteration; the
    monitored norm is the true ||b - A x||_2."""
    x = torch.zeros_like(b) if x0 is None else x0
    b = A.project(b)
    x = A.project(x)
    precond = M if M is not None else (lambda v: v)

    r0 = b - A(x)
    reduce = getattr(A, "allreduce", None)
    rr0, bb = _sums(reduce, _dot(r0, r0), _dot(b, b))
    rnorm0, bnorm = torch.sqrt(rr0), torch.sqrt(bb)
    hist = torch.full((max_it + 1,), float("nan"), dtype=b.dtype,
                      device=b.device)
    hist[0] = rnorm0
    if monitor:
        _monitor_print(0, rnorm0)

    atol_ = torch.tensor(atol, dtype=b.dtype, device=b.device)
    rtol_ = torch.tensor(rtol, dtype=b.dtype, device=b.device)
    w = torch.tensor(omega, dtype=b.dtype, device=b.device)

    r, resnorm = r0, rnorm0
    k = 0
    while k < max_it:
        go = ((resnorm > rtol_ * bnorm) & (resnorm > atol_)
              & torch.isfinite(resnorm))
        if not debugging.proceed(go, resnorm, "richardson", k):
            break
        # r is b - A x of the current x (the JAX package forms it twice)
        x = A.project(x + w * precond(r))
        r = b - A(x)
        rr, = _sums(reduce, _dot(r, r))
        resnorm = torch.sqrt(rr)
        k += 1
        hist[k] = resnorm
        if monitor:
            _monitor_print(k, resnorm)

    reason = classify(resnorm, k, bnorm, rtol_, atol_, max_it)
    return SolveResult(x, torch.tensor(k, dtype=torch.int32), resnorm, hist,
                       reason)
