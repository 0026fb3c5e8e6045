"""High-level facade (port of :mod:`poissbox_tpu.api`): grid + operator +
preconditioner + options bound once, then solves.

    solver = PoissonSolver((256, 256, 256), dtype=torch.float32,
                           device="cuda")
    u = solver.random_solution(seed=0)
    result = solver.solve(solver.rhs_for(u))      # SolveResult
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.constants import default_real
from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers.ksp import make_solver
from poissbox_tpu_torch.solvers.result import SolveResult

Tensor = torch.Tensor


class PoissonSolver:
    """Periodic 3-D Poisson solver on one device.

    Args:
      n: grid shape (nx, ny, nz).
      length: domain extents (unit cube by default).
      options: solver configuration; defaults to CG + multigrid, the
        solver of record.
      dtype: field dtype, torch.float32 or torch.float64.
      device: where the fields live; on "cuda" the operator and every MG
        level run the hand-written kernels.
      order: 2 (the 7-point operator); the 6th-order compact operator is
        not ported yet.
    """

    def __init__(self, n: Sequence[int],
                 length: Sequence[float] = (1.0, 1.0, 1.0),
                 options: Options | SolverOptions | None = None,
                 dtype=None,
                 device="cpu",
                 order: int = 2):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoissonSolver(device='cuda') needs a CUDA "
                               "device; torch.cuda.is_available() is False")
        if order == 6:
            raise NotImplementedError(
                "order=6 (the compact stack) is not ported yet; see ROADMAP.md")
        if order != 2:
            raise ValueError(f"order must be 2 or 6, got {order}")
        self.grid = Grid3D(tuple(n), tuple(length), device)
        self.A: LinearOperator = make_laplacian_operator(self.grid)
        if isinstance(options, Options):
            options = SolverOptions.from_options(options)
        if options is None:
            options = SolverOptions(ksp_type="cg", pc_type="mg")
        self.options = options
        self.dtype = dtype or default_real()
        self._solver = make_solver(self.A, options, self.grid.n,
                                   self.grid.deltas, self.dtype, device)

    # -- fields ------------------------------------------------------------
    def random_solution(self, seed: int = 0) -> Tensor:
        """Mean-free random field in [-1, 1) from a seeded torch.Generator."""
        g = torch.Generator().manual_seed(seed)
        return self.A.project(self.grid.random(g, self.dtype))

    def rhs_for(self, x: Tensor) -> Tensor:
        """Manufactured RHS b = A x."""
        return self.A(x)

    # -- solves ------------------------------------------------------------
    def solve(self, b: Tensor, x0: Optional[Tensor] = None) -> SolveResult:
        """Options-driven solve (KSPSolve analogue)."""
        return self._solver(b, x0)

    def solve_refined(self, b: Tensor, rtol: float = 1.0e-12,
                      max_outer: int = 4):
        raise NotImplementedError(
            "solve_refined (solvers/refine.py) is not ported yet; see ROADMAP.md")

    def solve_checkpointed(self, b: Tensor, path: str, **kw):
        raise NotImplementedError(
            "solve_checkpointed (checkpoint.py) is not ported yet; see ROADMAP.md")

    def residual_norm(self, x: Tensor, b: Tensor) -> float:
        """True relative residual ||A x - b|| / ||b||."""
        r = float(torch.linalg.vector_norm(self.A(x) - b))
        return r / float(torch.linalg.vector_norm(b))
