"""Krylov + multigrid solvers (port of :mod:`poissbox_tpu.solvers`).

  - solvers.cg ......... conjugate gradients, flexible CG
  - solvers.mg ......... geometric-multigrid V/W-cycle preconditioner
  - solvers.ksp ........ options-driven dispatcher

PIPECG, GMRES, Richardson, refinement and the FFT solve are not ported
yet (ROADMAP.md, queue 1).
"""

from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.ksp import make_solver, solve
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner, v_cycle
from poissbox_tpu_torch.solvers.result import ConvergedReason, SolveResult

__all__ = [
    "SolveResult",
    "ConvergedReason",
    "cg",
    "MGConfig",
    "make_mg_preconditioner",
    "v_cycle",
    "solve",
    "make_solver",
]
