"""Damped (preconditioned) Richardson iteration — the `-ksp_type richardson`
path (port of :mod:`poissbox_tpu.solvers.richardson`).

x <- x + omega * M(b - A x); with M one V-cycle this is the stationary
multigrid iteration. A host loop reading one boolean per iteration, as
:mod:`poissbox_tpu_torch.solvers.cg`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from poissbox_tpu_torch.linops import LinearOperator, require_one_rank
from poissbox_tpu_torch.solvers.cg import _dot, _monitor_print
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
    require_one_rank(A, "Richardson")
    x = torch.zeros_like(b) if x0 is None else x0
    b = A.project(b)
    x = A.project(x)
    precond = M if M is not None else (lambda v: v)

    r0 = b - A(x)
    rnorm0 = torch.sqrt(_dot(r0, r0))
    bnorm = torch.sqrt(_dot(b, b))
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
        resnorm = torch.sqrt(_dot(r, r))
        k += 1
        hist[k] = resnorm
        if monitor:
            _monitor_print(k, resnorm)

    reason = classify(resnorm, k, bnorm, rtol_, atol_, max_it)
    return SolveResult(x, torch.tensor(k, dtype=torch.int32), resnorm, hist,
                       reason)
