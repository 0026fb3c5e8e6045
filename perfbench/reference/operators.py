"""The plain reference operators of the benchmark: the 2nd-order 7-point
periodic Laplacian, the 6th-order staggered compact Laplacian, and an
exact periodic solve of either. Plain PyTorch, float64 unless asked
otherwise; nothing of the program under test is imported.

The 7-point operator is the stencil itself, written with ``torch.roll``.

The compact operator is div(grad(u)) of the upstream's compact schemes
(3decomp/poissbox src/compact_schemes.f90): along each axis a staggered
first derivative D (cell -> vertex) and its forward form D' (vertex ->
cell), and a staggered midpoint interpolation I and I', each a periodic
constant-coefficient system

    alpha g[i-1] + g[i] + alpha g[i+1] = a (f[r] + s f[l]) + b (f[rr] + s f[ll])

(derivative: a = 63/62 / h, b = 17/62 / (3 h), alpha = 9/62, s = -1;
interpolation: a = 3/4, b = 1/20, alpha = 3/10, s = +1). Every such
operator is circulant, so the Laplacian

    L = D'x Dx (I'y Iy)(I'z Iz) + (I'x Ix) D'y Dy (I'z Iz) + (I'x Ix)(I'y Iy) D'z Dz

is diagonal in Fourier space, with the 1-D factors

    D'D(t) = -4 (a sin(t/2) + b sin(3t/2))^2 / (1 + 2 alpha cos t)^2
    I'I(t) =  4 (a cos(t/2) + b cos(3t/2))^2 / (1 + 2 alpha cos t)^2

at t = 2 pi k / n. The tests hold both operators to dense matrices built
row by row from these definitions.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

Tensor = torch.Tensor

GRAD = (63.0 / 62.0, 17.0 / 62.0 / 3.0, 9.0 / 62.0)   # (a h, b h, alpha)
INTERP = (0.75, 1.0 / 20.0, 3.0 / 10.0)                 # (a, b, alpha)


def lapl7(u: Tensor, deltas: Sequence[float]) -> Tensor:
    """The 7-point periodic Laplacian of `u`, in `u`'s dtype."""
    out = torch.zeros_like(u)
    for ax, h in enumerate(deltas):
        out += (torch.roll(u, 1, ax) + torch.roll(u, -1, ax) - 2.0 * u) * (1.0 / (h * h))
    return out


def _theta(n: int, half: bool, device) -> Tensor:
    k = torch.arange(n // 2 + 1 if half else n, dtype=torch.float64, device=device)
    return 2.0 * math.pi * k / n


def symbol7_1d(n: int, h: float, half: bool = False, device="cpu") -> Tensor:
    """The 1-D second difference's eigenvalues, (2 cos t - 2) / h^2."""
    return (2.0 * torch.cos(_theta(n, half, device)) - 2.0) / (h * h)


def compact_factors_1d(n: int, h: float, half: bool = False, device="cpu"):
    """(D'D, I'I) of one axis: the eigenvalues of the compact second
    derivative and of the compact interpolation pair."""
    t = _theta(n, half, device)
    ga, gb, galpha = GRAD
    ia, ib, ialpha = INTERP
    dd = -4.0 * ((ga * torch.sin(t / 2) + gb * torch.sin(1.5 * t)) / h) ** 2 \
        / (1.0 + 2.0 * galpha * torch.cos(t)) ** 2
    ii = 4.0 * (ia * torch.cos(t / 2) + ib * torch.cos(1.5 * t)) ** 2 \
        / (1.0 + 2.0 * ialpha * torch.cos(t)) ** 2
    return dd, ii


def symbol(order: int, shape: Sequence[int], deltas: Sequence[float], device="cpu") -> Tensor:
    """The operator's eigenvalues on the rfftn grid (last axis halved)."""
    nx, ny, nz = shape
    views = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
    if order == 2:
        parts = [symbol7_1d(n, h, half=(ax == 2), device=device).view(views[ax])
                 for ax, (n, h) in enumerate(zip(shape, deltas))]
        return parts[0] + parts[1] + parts[2]
    if order == 6:
        f = [compact_factors_1d(n, h, half=(ax == 2), device=device)
             for ax, (n, h) in enumerate(zip(shape, deltas))]
        (dx, ix), (dy, iy), (dz, iz) = [(d.view(views[ax]), i.view(views[ax]))
                                        for ax, (d, i) in enumerate(f)]
        return dx * iy * iz + ix * dy * iz + ix * iy * dz
    raise ValueError(f"order must be 2 or 6, got {order}")


def lapl6(u: Tensor, deltas: Sequence[float]) -> Tensor:
    """The 6th-order compact Laplacian of a float64 field, by its symbol."""
    lam = symbol(6, u.shape, deltas, device=u.device)
    return torch.fft.irfftn(torch.fft.rfftn(u) * lam, s=u.shape)


def apply(order: int, u: Tensor, deltas: Sequence[float]) -> Tensor:
    """A u for the configuration's operator order."""
    return lapl7(u, deltas) if order == 2 else lapl6(u, deltas)


def solve(order: int, b: Tensor, deltas: Sequence[float], real=torch.float64) -> Tensor:
    """The minimal-norm solution of A x = b: every mode divided by its
    eigenvalue, the null modes (the mean; for order 6 also the modes the
    staggered interpolation annihilates) set to zero. `real` is the
    precision the transforms run in (float64 or float32)."""
    lam = symbol(order, b.shape, deltas, device=b.device)
    tiny = lam.abs().max() * 1e-12
    inv = torch.where(lam.abs() > tiny, 1.0 / torch.where(lam.abs() > tiny, lam, 1.0),
                      torch.zeros_like(lam)).to(real)
    return torch.fft.irfftn(torch.fft.rfftn(b.to(real)) * inv, s=b.shape)


def relative_residual(order: int, x: Tensor, b: Tensor, deltas: Sequence[float]) -> float:
    """||A x - P b|| / ||b||, every operation in float64."""
    rnorm, bnorm = residual_norms(order, x, b, deltas)
    return rnorm / bnorm


def residual_norms(order: int, x: Tensor, b: Tensor, deltas: Sequence[float]):
    """(||P b - A x||, ||b||) in float64, P the removal of the mean (the
    null space's component, which no x can produce)."""
    x64 = x.to(torch.float64)
    r = apply(order, x64, deltas)
    del x64
    b64 = b.to(torch.float64)
    r -= b64 - b64.mean()
    return float(torch.linalg.vector_norm(r)), float(torch.linalg.vector_norm(b64))


def relative_error(order: int, x: Tensor, b: Tensor, deltas: Sequence[float]) -> float:
    """||x - x*|| / ||x*||, x* the exact minimal-norm solution of A x = b
    (:func:`solve`, float64) and x's mean removed."""
    err = solve(order, b, deltas)
    ref = float(torch.linalg.vector_norm(err))
    x64 = x.to(torch.float64)
    err -= x64 - x64.mean()
    del x64
    return float(torch.linalg.vector_norm(err)) / ref
