"""High-level facade (port of :mod:`poissbox_tpu.api`): grid + operator +
preconditioner + options bound once, then solves.

    solver = PoissonSolver((256, 256, 256), dtype=torch.float32,
                           device="cuda")
    u = solver.random_solution(seed=0)
    b = solver.rhs_for(u)
    result = solver.solve(b)                      # SolveResult
    refined = solver.solve_refined(b)             # f64-accurate (RefineResult)
    result, its = solver.solve_checkpointed(b, "ckpt/solve", every=25)

Across ranks (``torchrun --nproc-per-node N``, after
``mesh.init_process_group()``), ``PoissonSolver(n, shard=True)``
decomposes the grid over the world group and every field is this rank's
owned box: ``random_solution``, ``rhs_for``, ``solve``,
``solve_refined``, ``solve_checkpointed`` and ``residual_norm`` take and
return blocks (``solver.grid.unshard`` gathers one). Everything runs
there that runs on one device: both orders, every `-ksp_type` (CG/FCG,
PIPECG, GMRES, Richardson, `fft`) and `-pc_type` (the V-cycle's fine
levels distributed, `fft` the pencil FFT), `-log_view`, refinement over
the distributed float32 MG-CG, and checkpoints of one file a rank. Each
call is a collective: call it on every rank. Owned boxes need no padding,
so the JAX package's ``_prep`` (which scatters a logical field into its
padded uneven layout) has no counterpart.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.constants import default_real
from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.mesh import Grid3D, make_process_grid
from poissbox_tpu_torch.ops.compact import make_compact_laplacian_operator
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.ksp import make_solver
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner
from poissbox_tpu_torch.solvers.refine import RefineResult, refine
from poissbox_tpu_torch.solvers.result import SolveResult

Tensor = torch.Tensor


class PoissonSolver:
    """Periodic 3-D Poisson solver on one device or across ranks.

    Args:
      n: grid shape (nx, ny, nz).
      length: domain extents (unit cube by default).
      options: solver configuration; defaults to CG + multigrid, the
        solver of record.
      dtype: field dtype, torch.float32 or torch.float64.
      device: where the fields live, the card unless the caller asks for
        "cpu"; on "cuda" the operator and every MG level run the
        hand-written kernels, and without a card it raises.
      order: 2 (the 7-point operator) or 6 (the 6th-order compact
        Laplacian with its default method, "auto": the K15 line kernel;
        ``ops.compact.make_compact_laplacian_operator(grid,
        method="pallas")`` builds the K17 Thomas pipeline instead). Krylov
        solves keep the 2nd-order GMG preconditioner, spectrally
        equivalent, and `-ksp_type fft` solves it exactly through its
        symbol.

    Besides the options-driven :meth:`solve` (every `-ksp_type` of the JAX
    package), :meth:`solve_refined` reaches float64 accuracy by iterative
    refinement over float32 MG-CG, and :meth:`solve_checkpointed` saves
    the solve every few iterations so that a killed run resumes.
    """

    def __init__(self, n: Sequence[int],
                 length: Sequence[float] = (1.0, 1.0, 1.0),
                 options: Options | SolverOptions | None = None,
                 dtype=None,
                 device="cuda",
                 order: int = 2,
                 shard: bool | Sequence[int] = False):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoissonSolver(device='cuda') needs a CUDA "
                               "device; torch.cuda.is_available() is False")
        grid = Grid3D(tuple(n), tuple(length), device)
        if shard is True:
            grid = grid.with_mesh()
        elif shard:
            grid = grid.with_mesh(make_process_grid(shard))
        self.grid = grid
        if order == 2:
            self.A: LinearOperator = make_laplacian_operator(self.grid)
        elif order == 6:
            self.A = make_compact_laplacian_operator(self.grid)
        else:
            raise ValueError(f"order must be 2 or 6, got {order}")
        if isinstance(options, Options):
            options = SolverOptions.from_options(options)
        if options is None:
            options = SolverOptions(ksp_type="cg", pc_type="mg")
        self.options = options
        self.dtype = dtype or default_real()
        self._solver = make_solver(self.A, options, self.grid.n,
                                   self.grid.deltas, self.dtype, self.grid.device,
                                   grid=self.grid)

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
                      max_outer: int = 4) -> RefineResult:
        """float64-accurate solve by mixed-precision iterative refinement:
        float32 MG-CG corrections (rtol 1e-6, at most 50 iterations each;
        the MG is built at each call, over the grid's process grid),
        float64 true residuals."""
        M = make_mg_preconditioner(self.grid.n, self.grid.deltas, MGConfig(),
                                   dtype=torch.float32, device=self.grid.device,
                                   grid=self.grid)
        inner = lambda r: cg(self.A, r, M=M, rtol=1e-6, max_it=50)
        return refine(self.A, inner, b, rtol=rtol, max_outer=max_outer)

    def solve_checkpointed(self, b: Tensor, path: str, *,
                           rtol: float = 1.0e-6, max_it: int = 500,
                           every: int = 25):
        """Preemption-tolerant MG-CG solve: a snapshot every `every`
        iterations; a killed run resumes from `path` with at most `every`
        iterations lost (checkpoint.solve_with_checkpoints; across ranks
        one file a rank under `path`). Returns (SolveResult,
        total_iterations)."""
        from poissbox_tpu_torch.checkpoint import solve_with_checkpoints
        M = make_mg_preconditioner(self.grid.n, self.grid.deltas, MGConfig(),
                                   dtype=self.dtype, device=self.grid.device,
                                   grid=self.grid)
        return solve_with_checkpoints(self.A, b, path, M=M, rtol=rtol,
                                      max_it=max_it, every=every, grid=self.grid)

    def residual_norm(self, x: Tensor, b: Tensor) -> float:
        """True relative residual ||A x - b|| / ||b|| (over every rank's
        block)."""
        if self.A.allreduce is None:
            r = float(torch.linalg.vector_norm(self.A(x) - b))
            return r / float(torch.linalg.vector_norm(b))
        d = self.A(x) - b
        rr, bb = self.A.allreduce(torch.stack([torch.sum(d * d), torch.sum(b * b)]))
        return math.sqrt(float(rr)) / math.sqrt(float(bb))
