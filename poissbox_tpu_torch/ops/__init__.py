"""Numerical operators: the 7-point stencil in plain PyTorch (stencil),
its assembled view (assemble), and the Hopper kernels with their plain
versions (stencil_cuda; sources in ../csrc, built by _build)."""

from poissbox_tpu_torch.ops import assemble, coefficients, stencil, stencil_cuda

__all__ = ["assemble", "coefficients", "stencil", "stencil_cuda"]
