"""Finite-difference coefficient sets (port of
:mod:`poissbox_tpu.ops.coefficients`): the 7-point star and the constants
of the 6th-order staggered compact schemes."""

from __future__ import annotations

from typing import NamedTuple

import torch


def lapl_1d_coeffs(dx, dtype=torch.float64) -> torch.Tensor:
    """[1, -2, 1] / dx^2 — 2nd-order 1-D Laplacian."""
    invdx2 = 1.0 / torch.tensor(dx, dtype=dtype) ** 2
    return torch.stack([invdx2, -2.0 * invdx2, invdx2])


def lapl_star_coeffs(dx, dy, dz, dtype=torch.float64) -> torch.Tensor:
    """7-point star as a 3x3x3 coefficient box, (x, y, z) offsets, centre
    at [1, 1, 1], accumulating -2(1/dx^2 + 1/dy^2 + 1/dz^2) there."""
    box = torch.zeros((3, 3, 3), dtype=dtype)
    box[:, 1, 1] += lapl_1d_coeffs(dx, dtype)
    box[1, :, 1] += lapl_1d_coeffs(dy, dtype)
    box[1, 1, :] += lapl_1d_coeffs(dz, dtype)
    return box


class CompactCoeffs(NamedTuple):
    """Parameters of a staggered compact scheme:

        alpha*g_{i-1} + g_i + alpha*g_{i+1} = a*(f_r + s*f_l) + b*(f_rr + s*f_ll)

    with s = opsign (-1 difference, +1 interpolation); see the RHS
    evaluator in ops.compact.
    """

    a: float
    b: float
    alpha: float
    opsign: int


def compact_grad_coeffs(dx) -> CompactCoeffs:
    """6th-order staggered first derivative."""
    return CompactCoeffs(
        a=(63.0 / 62.0) / dx,
        b=(17.0 / 62.0) / (3.0 * dx),
        alpha=9.0 / 62.0,
        opsign=-1,
    )


def compact_interp_coeffs() -> CompactCoeffs:
    """6th-order staggered midpoint interpolation."""
    return CompactCoeffs(a=0.75, b=1.0 / 20.0, alpha=3.0 / 10.0, opsign=+1)
