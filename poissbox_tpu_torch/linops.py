"""Linear-operator protocol: the apply closure, an optional diagonal, an
optional null-space projector, and the fused hooks a kernel-backed
operator binds (port of :mod:`poissbox_tpu.linops`)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def make_nullspace_projector() -> Callable[[Tensor], Tensor]:
    """Projector removing the constant null-space component: x - mean(x)."""

    def project(x: Tensor) -> Tensor:
        return x - torch.mean(x)

    # marker read by solvers.cg: the rank-one mean-removal form lets the
    # projection fold into the CG reductions instead of costing its own
    # memory passes; custom projectors take the generic path
    project.is_constant_projector = True
    return project


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """A matrix-free linear operator A: field -> field.

    Attributes:
      apply: y = A(x).
      diagonal: returns diag(A) as a scalar or field (Jacobi); None if
        unavailable.
      nullspace: projector onto range(A); None for nonsingular operators.
      symmetric: operator symmetry (CG requires it).
      apply_dot: optional fused x -> (A x, <x, A x>), so CG forms p'Ap
        without re-reading p and Ap (the CUDA stencil kernel binds it).
      direct_solve: optional exact x = A^+ b (None until the FFT solve is
        ported).
    """

    apply: Callable[[Tensor], Tensor]
    diagonal: Optional[Callable[[], object]] = None
    nullspace: Optional[Callable[[Tensor], Tensor]] = None
    symmetric: bool = True
    apply_dot: Optional[Callable[[Tensor], tuple]] = None
    direct_solve: Optional[Callable[[Tensor], Tensor]] = None

    def __call__(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def project(self, x: Tensor) -> Tensor:
        """Apply the null-space projector if one is attached."""
        return x if self.nullspace is None else self.nullspace(x)

