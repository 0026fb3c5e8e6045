"""A plain flexible GMRES, FGMRES(m), for the benchmark's reference: plain
PyTorch in float64, no kernels, nothing of the program under test.

Written from Saad, "A flexible inner-outer preconditioned GMRES
algorithm", SIAM J. Sci. Comput. 14 (1993) 461-469, Algorithm 2.2:

    r0 = b - A x0, beta = ||r0||, v1 = r0 / beta
    for j = 1..m:  z_j = M_j v_j;  w = A z_j
                   h_ij = (w, v_i), w -= h_ij v_i   (i = 1..j)
                   h_j+1,j = ||w||, v_j+1 = w / h_j+1,j
    x_m = x0 + Z_m y_m,  y_m = argmin ||beta e1 - H_m y||;  restart

Departures, each as PETSc's KSPFGMRES does it (the configuration's
source): the least-squares problem is reduced by Givens rotations as the
cycle runs, so |g_j+1|, the norm of the residual of x0 + Z_j y_j, is
known after every step, and the cycle stops at the first step where it
is at most max(rtol ||b||, atol); at a cycle's end x is formed and the
true residual b - A x computed, which decides whether to restart (from
that residual) or stop, and is the norm returned; `max_it` bounds the
steps over all cycles. A breakdown (h_j+1,j = 0, the exact solution in
the space built) divides by the smallest positive float64, which leaves
v_j+1 zero and the estimate 0. The orthogonalisation is Algorithm 2.2's
modified Gram-Schmidt.

The operator and the preconditioner are callables on float64 tensors;
the preconditioner may change from one call to the next (the method's
point). A singular operator's caller keeps b and M's output in its
range (for the periodic Laplacian: mean-free).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor
TINY = torch.finfo(torch.float64).tiny


class KrylovResult(NamedTuple):
    x: Tensor                 # the iterate, float64
    iterations: int           # inner steps over every cycle
    history: Tensor           # ||r0||, then |g_j+1| after every step
    residual_norm: float      # ||b - A x|| of the returned x


def _norm(v: Tensor) -> float:
    return float(torch.linalg.vector_norm(v))


def fgmres(apply: Callable[[Tensor], Tensor], b: Tensor,
           precond: Optional[Callable[[Tensor], Tensor]] = None, *,
           rtol: float = 1.0e-5, atol: float = 0.0, restart: int = 30,
           max_it: int = 10000) -> KrylovResult:
    """FGMRES(restart) from x0 = 0 on A x = b (`apply` is A, `precond`
    M, the identity where None)."""
    M = precond if precond is not None else (lambda v: v)
    b = b.to(torch.float64)
    x = torch.zeros_like(b)
    target = max(rtol * _norm(b), atol)
    r = b - apply(x)
    beta = _norm(r)
    history = [beta]
    its = 0
    while beta > target and its < max_it:
        V, Z = [r / beta], []
        H = torch.zeros(restart + 1, restart, dtype=torch.float64)
        cs = torch.zeros(restart, dtype=torch.float64)
        sn = torch.zeros(restart, dtype=torch.float64)
        g = torch.zeros(restart + 1, dtype=torch.float64)
        g[0] = beta
        j = 0
        while j < restart and its < max_it:
            Z.append(M(V[j]))
            w = apply(Z[j])
            for i in range(j + 1):
                H[i, j] = torch.sum(w * V[i])
                w = w - H[i, j] * V[i]
            H[j + 1, j] = _norm(w)
            V.append(w / max(float(H[j + 1, j]), TINY))
            for i in range(j):
                hi = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = hi
            denom = max(float(torch.hypot(H[j, j], H[j + 1, j])), TINY)
            cs[j], sn[j] = H[j, j] / denom, H[j + 1, j] / denom
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            j += 1
            its += 1
            history.append(abs(float(g[j])))
            if history[-1] <= target:
                break
        y = torch.linalg.solve_triangular(H[:j, :j], g[:j, None], upper=True)[:, 0]
        for i in range(j):
            x = x + y[i] * Z[i]
        r = b - apply(x)
        beta = _norm(r)
    return KrylovResult(x, its, torch.tensor(history, dtype=torch.float64), beta)
