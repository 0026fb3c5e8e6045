"""poissbox_tpu_torch — the PyTorch and CUDA port of poissbox_tpu.

The same periodic 3-D Poisson-solver framework as :mod:`poissbox_tpu`,
written with PyTorch tensors and, where the JAX package runs Pallas
kernels on a TPU, hand-written CUDA kernels for an NVIDIA Hopper card
(``csrc/``, built with nvcc at first use). The JAX package stays the
reference: the tests hold every ported function against it.

This package imports ``torch`` and numpy, never ``jax``. Its modules
mirror the JAX package's paths:

  - grid, process grid ... poissbox_tpu_torch.mesh
  - across ranks ......... poissbox_tpu_torch.parallel.{decomp,halo,dist_stencil,uneven,pencil}
  - stencil operators .... poissbox_tpu_torch.ops.stencil
  - CUDA kernels ......... poissbox_tpu_torch.ops.stencil_cuda
  - assembled operator ... poissbox_tpu_torch.ops.assemble
  - compact 6th order .... poissbox_tpu_torch.ops.compact, ops.compact_pcr, ops.compact_dist
  - tridiagonal solves ... poissbox_tpu_torch.ops.tridiag, ops.tridiag_cuda
  - FFT direct solves .... poissbox_tpu_torch.solvers.fft
  - CG / FCG ............. poissbox_tpu_torch.solvers.cg
  - PIPECG, (F)GMRES, Richardson  poissbox_tpu_torch.solvers.{pipecg,gmres,richardson}
  - multigrid ............ poissbox_tpu_torch.solvers.mg
  - options-driven solve . poissbox_tpu_torch.solvers.ksp
  - refinement ........... poissbox_tpu_torch.solvers.refine
  - checkpointing ........ poissbox_tpu_torch.checkpoint
  - facade ............... poissbox_tpu_torch.api.PoissonSolver
  - options database ..... poissbox_tpu_torch.config
  - native planner, options  poissbox_tpu_torch.native (C++ by ctypes, built at first use)
  - census, scaling model  poissbox_tpu_torch.utils.{census,scaling}

Dtype is an explicit argument (float32 or float64) and every constructor
takes a ``device``. What is not ported yet (ROADMAP.md lists it) is
absent or raises ``NotImplementedError``.
"""

from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.constants import default_real
from poissbox_tpu_torch.linops import LinearOperator, make_nullspace_projector
from poissbox_tpu_torch.mesh import Grid3D

__version__ = "0.1.0"

__all__ = [
    "default_real",
    "Grid3D",
    "LinearOperator",
    "make_nullspace_projector",
    "Options",
    "__version__",
]
