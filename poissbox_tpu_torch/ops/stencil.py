"""Matrix-free 7-point Laplacian stencil operators (port of
:mod:`poissbox_tpu.ops.stencil`).

Three equivalent implementations, cross-checked by the tests and the demo:

  * :func:`apply_laplacian` — periodic shifted adds (``torch.roll``);
  * :func:`apply_laplacian_pointwise` — an independent contraction with
    the full 3x3x3 coefficient box;
  * the hand-written CUDA kernel of :mod:`poissbox_tpu_torch.ops.stencil_cuda`
    (impl ``"cuda"``), whose plain version runs for CPU tensors.

All are periodic; fields are cell-centred on a uniform grid.
"""

from __future__ import annotations

from typing import Sequence

import torch

from poissbox_tpu_torch.linops import LinearOperator, make_nullspace_projector
from poissbox_tpu_torch.ops.coefficients import lapl_star_coeffs
from poissbox_tpu_torch.ops.stencil_cuda import (
    apply_laplacian_cuda,
    apply_laplacian_dot_cuda,
)


def apply_laplacian(u: torch.Tensor, deltas: Sequence[float]) -> torch.Tensor:
    """Periodic 2nd-order Laplacian via shifted adds, per axis
    (f_{+1} + f_{-1}) * invdx2, centre term subtracted last."""
    if u.dim() != len(deltas):
        raise ValueError(f"field rank {u.dim()} != len(deltas) {len(deltas)}")
    acc = torch.zeros_like(u)
    center = 0.0
    for ax, dd in enumerate(deltas):
        inv = 1.0 / float(dd) ** 2
        acc = acc + (torch.roll(u, 1, ax) + torch.roll(u, -1, ax)) * inv
        center += 2.0 * inv
    return acc - center * u


def apply_laplacian_pointwise(u: torch.Tensor,
                              deltas: Sequence[float]) -> torch.Tensor:
    """Independent evaluation through the full 3x3x3 star box."""
    dx, dy, dz = deltas
    box = lapl_star_coeffs(dx, dy, dz, dtype=u.dtype).to(u.device)
    out = torch.zeros_like(u)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                c = box[di + 1, dj + 1, dk + 1]
                # rolling by -d brings u[i+d] to position i
                shifted = torch.roll(u, (-di, -dj, -dk), (0, 1, 2))
                out = out + c * shifted
    return out


def default_impl(device) -> str:
    """The stencil implementation for fields on `device`: the CUDA kernels
    on a CUDA device (every grid size: the JAX package's min(shape) >= 16
    gate is a TPU tiling rule), the roll formulation on the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "roll"
    raise ValueError(f"no stencil implementation for device {device!r}")


def make_laplacian_operator(grid, impl: str = "auto"):
    """The matrix-free Laplacian LinearOperator for a Grid3D.

    `impl`: 'roll', 'pointwise', or 'cuda' (the hand-written kernels;
    `apply` and `apply_dot` bind kernel KA). 'auto' follows the grid's
    device (:func:`default_impl`).
    """
    deltas = grid.deltas
    if impl == "auto":
        impl = default_impl(grid.device)
    apply_dot = None
    if impl == "roll":
        apply = lambda u: apply_laplacian(u, deltas)
    elif impl == "pointwise":
        apply = lambda u: apply_laplacian_pointwise(u, deltas)
    elif impl == "cuda":
        apply = lambda u: apply_laplacian_cuda(u, deltas)
        apply_dot = lambda u: apply_laplacian_dot_cuda(u, deltas)
    else:
        raise ValueError(f"unknown stencil impl {impl!r} (expected "
                         "auto|roll|pointwise|cuda)")

    diag_val = -2.0 * sum(1.0 / float(d) ** 2 for d in deltas)
    return LinearOperator(
        apply=apply,
        diagonal=lambda: diag_val,
        nullspace=make_nullspace_projector(),
        symmetric=True,
        apply_dot=apply_dot,
        direct_solve=None,   # the FFT solve is not ported yet
    )


def laplacian_local(u_padded: torch.Tensor,
                    deltas: Sequence[float]) -> torch.Tensor:
    """Apply the 7-point star to a halo-padded block (width-1 halos):
    input (nx+2, ny+2, nz+2), output (nx, ny, nz)."""
    invs = [1.0 / float(d) ** 2 for d in deltas]
    c = u_padded[1:-1, 1:-1, 1:-1]
    out = (u_padded[2:, 1:-1, 1:-1] + u_padded[:-2, 1:-1, 1:-1]) * invs[0]
    out = out + (u_padded[1:-1, 2:, 1:-1] + u_padded[1:-1, :-2, 1:-1]) * invs[1]
    out = out + (u_padded[1:-1, 1:-1, 2:] + u_padded[1:-1, 1:-1, :-2]) * invs[2]
    return out - (2.0 * sum(invs)) * c
