"""Numerical operators: the 7-point stencil in plain PyTorch (stencil),
its assembled view (assemble), the 6th-order compact stack (compact,
compact_pcr; across ranks compact_dist) and its tridiagonal solvers
(tridiag, tridiag_cuda), and the
Hopper kernels with their plain versions (stencil_cuda, transfer_cuda,
compact_pcr, tridiag_cuda, spectral_cuda, gmres_cuda; sources in
../csrc, built, loaded and launched by _build)."""

from poissbox_tpu_torch.ops import (
    assemble,
    coefficients,
    compact,
    compact_dist,
    compact_pcr,
    gmres_cuda,
    spectral_cuda,
    stencil,
    stencil_cuda,
    tridiag,
    tridiag_cuda,
)

__all__ = ["assemble", "coefficients", "compact", "compact_dist", "compact_pcr",
           "gmres_cuda", "spectral_cuda", "stencil", "stencil_cuda", "tridiag", "tridiag_cuda"]
