"""Mixed-precision iterative refinement (port of
:mod:`poissbox_tpu.solvers.refine`): float32 corrections by a fast inner
solve, float64 iterate and true residuals.

    r_k = b - A x_k          (float64, KA on the card)
    solve A d = r_k to ~1e-6 (float32, e.g. MG-CG on the kernels)
    x_{k+1} = x_k + d        (float64)

Each outer iteration recovers about six digits. torch has no global x64
switch: b and the residuals are cast to ``torch.float64`` explicitly, and
the inner solve receives the residual cast to ``torch.float32``. Over a
process grid (``A64.allreduce``) ||b|| and every outer residual are global
norms, all-reduced, so every rank takes the outer test alike.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.solvers.result import SolveResult

Tensor = torch.Tensor


class RefineResult(NamedTuple):
    x: Tensor                 # float64 solution
    outer_iterations: int
    inner_iterations: int     # total Krylov iterations of the inner solves
    residual_norm: Tensor     # float64 true residual ||b - A x||
    history: Tensor           # float64 residual before each outer step, and at the end


def _norm(A: LinearOperator, v: Tensor) -> float:
    """||v||_2 of the whole field: the block's sum of squares all-reduced
    where `A` works on rank blocks."""
    ss = torch.sum(v * v).reshape(1)
    if A.allreduce is not None:
        ss = A.allreduce(ss)
    return math.sqrt(float(ss[0]))


def refine(
    A64: LinearOperator,
    inner_solve: Callable[[Tensor], SolveResult],
    b: Tensor,
    *,
    rtol: float = 1.0e-12,
    max_outer: int = 4,
    x0: Optional[Tensor] = None,
) -> RefineResult:
    """Refine to a true relative residual `rtol` in float64.

    Args:
      A64: the operator, applied to float64 fields (residuals).
      inner_solve: the float32 correction solver; it receives the residual
        cast to float32 and returns a SolveResult.
      b: right-hand side (cast to float64).
      rtol: target relative true residual.
      max_outer: outer iteration cap.

    A host loop: a few outer iterations, each one inner solve, where the
    time goes.
    """
    b = A64.project(b.to(torch.float64))
    x = torch.zeros_like(b) if x0 is None else x0.to(torch.float64)
    bnorm = _norm(A64, b)
    hist = []
    inner_total = 0
    for _ in range(max_outer):
        r = b - A64(x)
        resnorm = _norm(A64, r)
        hist.append(resnorm)
        if resnorm <= rtol * bnorm:
            break
        inner = inner_solve(r.to(torch.float32))
        inner_total += int(inner.iterations)
        x = A64.project(x + inner.x.to(torch.float64))
    r = b - A64(x)
    resnorm = _norm(A64, r)
    hist.append(resnorm)
    return RefineResult(
        x=x,
        outer_iterations=len(hist) - 1,
        inner_iterations=inner_total,
        residual_norm=torch.tensor(resnorm, dtype=torch.float64, device=b.device),
        history=torch.tensor(hist, dtype=torch.float64, device=b.device),
    )
