"""Finite-difference coefficient sets (port of the 7-point part of
:mod:`poissbox_tpu.ops.coefficients`; the compact-scheme constants come
with the compact stack)."""

from __future__ import annotations

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
