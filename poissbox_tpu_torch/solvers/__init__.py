"""Krylov + multigrid solvers (port of :mod:`poissbox_tpu.solvers`).

  - solvers.cg ......... conjugate gradients, flexible CG
  - solvers.pipecg ..... pipelined CG, one reduction group an iteration
  - solvers.gmres ...... restarted GMRES (PETSc's default KSP type)
  - solvers.richardson . damped Richardson iteration
  - solvers.mg ......... geometric-multigrid V/W-cycle preconditioner
  - solvers.fft ........ FFT direct solves (7-point and compact 6th order)
  - solvers.ksp ........ options-driven dispatcher
  - solvers.refine ..... mixed-precision iterative refinement (float32
                         inner solves, float64 true residuals)
"""

from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.fft import compact_poisson_solve_fft, poisson_solve_fft
from poissbox_tpu_torch.solvers.gmres import gmres
from poissbox_tpu_torch.solvers.ksp import make_solver, solve
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner, v_cycle
from poissbox_tpu_torch.solvers.pipecg import pipecg
from poissbox_tpu_torch.solvers.refine import RefineResult, refine
from poissbox_tpu_torch.solvers.result import ConvergedReason, SolveResult
from poissbox_tpu_torch.solvers.richardson import richardson

__all__ = [
    "SolveResult",
    "ConvergedReason",
    "cg",
    "pipecg",
    "gmres",
    "richardson",
    "poisson_solve_fft",
    "compact_poisson_solve_fft",
    "MGConfig",
    "make_mg_preconditioner",
    "v_cycle",
    "solve",
    "make_solver",
    "refine",
    "RefineResult",
]
