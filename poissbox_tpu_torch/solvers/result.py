"""Solve results and convergence reasons (port of
:mod:`poissbox_tpu.solvers.result`).

Every solver returns a :class:`SolveResult` with the iterate, the
iteration count, the residual norm, and a fixed-length residual history
(NaN-padded past the final iteration, as in the JAX package).
"""

from __future__ import annotations

import enum
import math
from typing import NamedTuple

import torch


class ConvergedReason(enum.IntEnum):
    """Subset of PETSc's KSPConvergedReason; positive = converged."""

    CONVERGED_RTOL = 2
    CONVERGED_ATOL = 3
    DIVERGED_MAX_IT = -3
    DIVERGED_NAN = -9

    @property
    def message(self) -> str:
        return {
            ConvergedReason.CONVERGED_RTOL: "converged: relative tolerance",
            ConvergedReason.CONVERGED_ATOL: "converged: absolute tolerance",
            ConvergedReason.DIVERGED_MAX_IT: "diverged: maximum iterations",
            ConvergedReason.DIVERGED_NAN: "diverged: NaN/Inf residual",
        }[self]


class SolveResult(NamedTuple):
    """Result returned by every Krylov solver."""

    x: torch.Tensor              # final iterate
    iterations: torch.Tensor     # int32 iteration count
    residual_norm: torch.Tensor  # final ||r||_2
    history: torch.Tensor        # (max_it + 1,) residual norms, NaN-padded
    reason: torch.Tensor         # int32 ConvergedReason value

    @property
    def converged(self) -> torch.Tensor:
        return self.reason > 0

    def reason_enum(self) -> ConvergedReason:
        """Host-side accessor (synchronises with the device)."""
        return ConvergedReason(int(self.reason))

    def monitor_lines(self, prefix: str = "") -> list[str]:
        """Render the residual history like `-ksp_monitor` output."""
        lines = []
        for i, r in enumerate(self.history.cpu().tolist()):
            if math.isnan(r):
                break
            lines.append(f"{prefix}{i:3d} KSP Residual norm {float(r):.12e}")
        return lines


def classify(resnorm, iters, rnorm0, rtol, atol, max_it) -> torch.Tensor:
    """Map the final state to a ConvergedReason code, on the device."""
    code = lambda c: torch.tensor(int(c), dtype=torch.int32,
                                  device=resnorm.device)
    nan = torch.isnan(resnorm) | torch.isinf(resnorm)
    return torch.where(
        nan, code(ConvergedReason.DIVERGED_NAN),
        torch.where(
            resnorm <= atol, code(ConvergedReason.CONVERGED_ATOL),
            torch.where(resnorm <= rtol * rnorm0,
                        code(ConvergedReason.CONVERGED_RTOL),
                        code(ConvergedReason.DIVERGED_MAX_IT))))
