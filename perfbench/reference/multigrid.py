"""A plain geometric-multigrid V-cycle with Chebyshev level smoothing, and
a plain preconditioned CG, for the benchmark's reference: plain PyTorch
in float64, no kernels, nothing of the program under test.

The hierarchy: each level halves every extent of the one above and
doubles its spacing, while every extent is even and the smallest is
above `coarse_size`; every level's operator is the 7-point periodic
Laplacian (``operators.lapl7``) of its own spacing. One V-cycle for
A e = r on level k:

    e  = S_pre(0; r)                       pre-smooth from a zero guess
    e += P V_{k+1}(R (r - A e))            coarse correction
    e  = S_post(e; r)                      post-smooth
    (coarsest level: e = the minimal-norm exact solve, operators.solve)

R is cell-centred full weighting, c_I = (3 f_2I + 3 f_2I+1 + f_2I+2 +
f_2I-1) / 8 along each axis, periodic; P is trilinear, P = 8 R^T: fine
cell 2I + s takes 3/4 of c_I and 1/4 of c_I-1 (s = 0) or c_I+1 (s = 1).

S is the Chebyshev iteration of degree d for A x = r on the interval
[lo, hi] x lambda_max of -A (lambda_max = 4 sum(1/h^2), exact for the
periodic operator), written from the Chebyshev polynomials' three-term
recurrence T_j+1(t) = 2 t T_j(t) - T_j-1(t). With the signed interval
[a, b] = [-hi, -lo] lambda_max of A, centre theta = (a + b) / 2, half
width delta = (b - a) / 2 and sigma = theta / delta, the error after j
steps is p_j(A) e_0, p_j(lambda) = T_j((theta - lambda) / delta) / T_j(sigma),
which gives, with tau_j = T_j(sigma) and omega_j+1 = 2 sigma tau_j / tau_j+1,

    x_1   = x_0 + r_0 / theta
    x_j+1 = x_j-1 + omega_j+1 (x_j - x_j-1 + r_j / theta),   r_j = b - A x_j.

Departures from PETSc's KSPCHEBYSHEV under PCGAMG (the configuration's
source: ``-mg_levels_ksp_type chebyshev -mg_levels_pc_type jacobi``,
``-mg_levels_ksp_max_it 2``, ``-mg_levels_ksp_chebyshev_esteig
0,0.1,0,1.1``), each as the program makes it:

  * the interval is [0.1, 1.0] lambda_max, lambda_max known exactly; PETSc
    takes [0.11, 1.1] lambda_hat of D^-1 A, lambda_hat from a 10-step
    Krylov estimate;
  * no Jacobi scaling: the diagonal is constant, so Chebyshev on D^-1 A
    over an interval scaled by D is the same polynomial in A;
  * the degree is the caller's (2 for PETSc's 2 iterations); the
    pre-smooth starts from zero, the post-smooth from the corrected
    iterate, as PCMG's levels do;
  * the coarsest level is solved exactly (minimal norm), where GAMG's
    coarse solve is a direct LU of its own coarse operator; the
    hierarchy is geometric where GAMG's is algebraic.

The PCG is Saad, "Iterative Methods for Sparse Linear Systems" (2003),
Algorithm 9.1, from x_0 = 0, with M's output and b kept mean-free (the
periodic Laplacian's null space) and PETSc's unpreconditioned norm: it
stops before an iteration where ||r|| <= max(rtol ||b||, atol).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from perfbench.reference import operators

Tensor = torch.Tensor


def hierarchy(shape: Sequence[int], deltas: Sequence[float],
              coarse_size: int = 4) -> list:
    """[(shape, deltas)] of every level, the finest first."""
    n, d = tuple(int(v) for v in shape), tuple(float(h) for h in deltas)
    levels = [(n, d)]
    while min(n) > coarse_size and all(v % 2 == 0 for v in n):
        n, d = tuple(v // 2 for v in n), tuple(2.0 * h for h in d)
        levels.append((n, d))
    return levels


def restrict(f: Tensor) -> Tensor:
    """Full weighting along every axis."""
    for ax in range(3):
        g = (3.0 * (f + torch.roll(f, -1, ax)) + torch.roll(f, -2, ax)
             + torch.roll(f, 1, ax)) * 0.125
        f = g[(slice(None),) * ax + (slice(None, None, 2),)]
    return f.contiguous()


def prolong(c: Tensor) -> Tensor:
    """Trilinear prolongation along every axis."""
    for ax in range(3):
        even = 0.75 * c + 0.25 * torch.roll(c, 1, ax)
        odd = 0.75 * c + 0.25 * torch.roll(c, -1, ax)
        c = torch.stack([even, odd], dim=ax + 1).flatten(ax, ax + 1)
    return c


def chebyshev(x: Optional[Tensor], b: Tensor, deltas: Sequence[float], degree: int,
              lo: float = 0.1, hi: float = 1.0) -> Tensor:
    """`degree` Chebyshev steps for lapl7 x = b from `x` (zero where
    None), by the three-term recurrence of the module's docstring."""
    lam = 4.0 * sum(1.0 / (h * h) for h in deltas)
    a, bb = -hi * lam, -lo * lam
    theta, delta = 0.5 * (a + bb), 0.5 * (bb - a)
    sigma = theta / delta
    x0 = torch.zeros_like(b) if x is None else x
    x1 = x0 + (b - operators.lapl7(x0, deltas)) / theta
    tau0, tau1 = 1.0, sigma
    for _ in range(degree - 1):
        tau2 = 2.0 * sigma * tau1 - tau0
        omega = 2.0 * sigma * tau1 / tau2
        r = b - operators.lapl7(x1, deltas)
        x0, x1 = x1, x0 + omega * (x1 - x0 + r / theta)
        tau0, tau1 = tau1, tau2
    return x1


def v_cycle(r: Tensor, levels: list, pre: int, post: int, k: int = 0) -> Tensor:
    """One V-cycle for A e = r on level k of `levels`, with Chebyshev
    smoothing of degree `pre` before the correction and `post` after."""
    shape, deltas = levels[k]
    if k == len(levels) - 1:
        return operators.solve(2, r, deltas)
    e = chebyshev(None, r, deltas, pre) if pre > 0 else torch.zeros_like(r)
    e = e + prolong(v_cycle(restrict(r - operators.lapl7(e, deltas)), levels, pre, post, k + 1))
    return chebyshev(e, r, deltas, post) if post > 0 else e


class PCGResult(NamedTuple):
    x: Tensor                 # the iterate, float64, mean-free
    iterations: int
    history: Tensor           # ||r_k|| for k = 0..iterations


def pcg(apply: Callable[[Tensor], Tensor], b: Tensor,
        precond: Optional[Callable[[Tensor], Tensor]] = None, *,
        rtol: float = 1.0e-5, atol: float = 0.0, max_it: int = 10000) -> PCGResult:
    """Preconditioned CG from x_0 = 0 on A x = b (`apply` A, `precond`
    M, the identity where None); b and every M r have their mean removed."""
    M = precond if precond is not None else (lambda v: v)
    b = b.to(torch.float64)
    b = b - b.mean()
    x, r = torch.zeros_like(b), b.clone()
    target = max(rtol * float(torch.linalg.vector_norm(b)), atol)
    z = M(r)
    z = z - z.mean()
    p, rz = z, float(torch.sum(r * z))
    history = [float(torch.linalg.vector_norm(r))]
    its = 0
    while history[-1] > target and its < max_it and math.isfinite(history[-1]):
        Ap = apply(p)
        alpha = rz / float(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        z = z - z.mean()
        rz, rz_old = float(torch.sum(r * z)), rz
        p = z + (rz / rz_old) * p
        its += 1
        history.append(float(torch.linalg.vector_norm(r)))
    return PCGResult(x - x.mean(), its, torch.tensor(history, dtype=torch.float64))
