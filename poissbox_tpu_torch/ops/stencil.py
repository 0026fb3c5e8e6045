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
    cg_fused_update_cuda,
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


def default_impl(device, mesh=None) -> str:
    """The stencil implementation for fields on `device`: "dist" (the
    correction-form operators of parallel.dist_stencil) over a process
    grid of more than one rank; otherwise the CUDA kernels on a CUDA
    device (every grid size: the JAX package's min(shape) >= 16 gate is a
    TPU tiling rule), the roll formulation on the CPU."""
    if mesh is not None and mesh.size > 1:
        return "dist"
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "roll"
    raise ValueError(f"no stencil implementation for device {device!r}")


def make_laplacian_operator(grid, impl: str = "auto"):
    """The matrix-free Laplacian LinearOperator for a Grid3D.

    `impl`: 'roll', 'pointwise', 'cuda' (the hand-written kernels;
    `apply` and `apply_dot` bind KA `stencil7`, `fused_update` K8
    `cgupd`), or, over a process grid of more than one rank, 'dist' (the
    correction-form operators on this rank's block: K1, K2 and K8 on the
    block on a card, the roll form on the CPU) and 'uneven' (the same operators, with the mean-removal
    projector applied explicitly, as the JAX package does on a grid the
    process grid does not divide; 'dist' becomes 'uneven' there). 'auto'
    follows the grid (:func:`default_impl`). Over several ranks
    `direct_solve` is the pencil FFT (``fft.poisson_solve_fft_dist``), the
    operator carries `allreduce` and `ndof`, and its fused hooks return
    this rank's partial sums.
    """
    deltas = grid.deltas
    mesh = grid.mesh if grid.distributed else None
    if impl == "auto":
        impl = default_impl(grid.device, mesh)
    if impl == "dist" and grid.uneven:
        impl = "uneven"
    apply_dot = fused_update = allreduce = None
    nullspace = make_nullspace_projector()
    if impl in ("dist", "uneven"):
        if mesh is None:
            raise ValueError(f"impl={impl!r} needs a grid over a process grid "
                             "of more than one rank")
        from poissbox_tpu_torch.parallel import dist_stencil as ds
        from poissbox_tpu_torch.parallel.halo import allreduce_sum
        from poissbox_tpu_torch.parallel.uneven import make_masked_projector
        apply = lambda u: ds.apply_laplacian_sharded(u, grid)
        apply_dot = lambda u: ds.apply_laplacian_dot_sharded(u, grid, reduce=False)
        fused_update = lambda a, x, p, r, ap: ds.cg_fused_update_sharded(
            a, x, p, r, ap, grid, reduce=False)
        allreduce = lambda t: allreduce_sum(t, mesh)
        nullspace = (make_masked_projector(grid) if impl == "uneven"
                     else make_nullspace_projector(mesh, grid.ndof))
    elif impl == "roll":
        apply = lambda u: apply_laplacian(u, deltas)
    elif impl == "pointwise":
        apply = lambda u: apply_laplacian_pointwise(u, deltas)
    elif impl == "cuda":
        apply = lambda u: apply_laplacian_cuda(u, deltas)
        apply_dot = lambda u: apply_laplacian_dot_cuda(u, deltas)
        fused_update = cg_fused_update_cuda
    else:
        raise ValueError(f"unknown stencil impl {impl!r} (expected "
                         "auto|roll|pointwise|cuda|dist|uneven)")

    diag_val = -2.0 * sum(1.0 / float(d) ** 2 for d in deltas)

    def direct_solve(b):
        from poissbox_tpu_torch.solvers.fft import poisson_solve_fft, poisson_solve_fft_dist
        if mesh is not None:
            return poisson_solve_fft_dist(b, grid)
        return poisson_solve_fft(b, deltas)

    return LinearOperator(
        apply=apply,
        diagonal=lambda: diag_val,
        nullspace=nullspace,
        symmetric=True,
        apply_dot=apply_dot,
        fused_update=fused_update,
        direct_solve=direct_solve,
        allreduce=allreduce,
        ndof=grid.ndof if mesh is not None else None,
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
