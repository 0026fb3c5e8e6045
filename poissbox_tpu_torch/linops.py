"""Linear-operator protocol: the apply closure, an optional diagonal, an
optional null-space projector, and the fused hooks a kernel-backed
operator binds (port of :mod:`poissbox_tpu.linops`)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def make_nullspace_projector(mesh=None, ndof: Optional[int] = None
                             ) -> Callable[[Tensor], Tensor]:
    """Projector removing the constant null-space component: x - mean(x).
    Over a process grid of more than one rank `x` is this rank's block and
    the mean is the global one: the block's sum all-reduced (once) over
    `ndof`, the global cell count."""

    if mesh is None or mesh.size == 1:
        def project(x: Tensor) -> Tensor:
            return x - torch.mean(x)
    else:
        from poissbox_tpu_torch.parallel.halo import allreduce_sum
        inv_n = 1.0 / float(ndof)

        def project(x: Tensor) -> Tensor:
            return x - allreduce_sum(torch.sum(x), mesh) * inv_n

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
      fused_update: optional (alpha, x, p, r, Ap) -> (x + alpha p,
        r - alpha Ap, ||r'||^2, sum(r')) in one pass (K8 on the CUDA
        operator); CG takes it when the preconditioner binds no fused
        entry of its own.
      direct_solve: optional exact x = A^+ b (the FFT solve of the
        7-point and the compact 6th-order operators).
      pupdate_apply_dot: optional (v, p, beta, zshift) -> (p', A p',
        <p', A p'>) for p' = (v - zshift) + beta * p (K12): CG then defers
        its search-direction update into the next matvec. Unbound by
        default, as in the JAX package; a caller binds it with
        dataclasses.replace.
      allreduce: set on an operator whose fields are rank blocks (a process
        grid of more than one rank): sums a 1-D tensor of partial sums over
        every rank. Its fused hooks (`apply_dot`, `fused_update`) then
        return THIS rank's partial sums, and the solver reduces them,
        stacked, once per reduction point.
      allreduce_max: set with `allreduce`: the elementwise maximum of a
        1-D tensor over every rank (the decisions every rank must take
        alike: GMRES's restart length, `-log_view`'s slowest rank).
      ndof: the global DoF count where fields are rank blocks (None: the
        field's own size).
    """

    apply: Callable[[Tensor], Tensor]
    diagonal: Optional[Callable[[], object]] = None
    nullspace: Optional[Callable[[Tensor], Tensor]] = None
    symmetric: bool = True
    apply_dot: Optional[Callable[[Tensor], tuple]] = None
    fused_update: Optional[Callable[..., tuple]] = None
    direct_solve: Optional[Callable[[Tensor], Tensor]] = None
    pupdate_apply_dot: Optional[Callable[..., tuple]] = None
    allreduce: Optional[Callable[[Tensor], Tensor]] = None
    allreduce_max: Optional[Callable[[Tensor], Tensor]] = None
    ndof: Optional[int] = None

    def __call__(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def project(self, x: Tensor) -> Tensor:
        """Apply the null-space projector if one is attached."""
        return x if self.nullspace is None else self.nullspace(x)

