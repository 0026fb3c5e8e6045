"""Decompositions that do not divide the grid (port of
:mod:`poissbox_tpu.parallel.uneven`).

PETSc's DMDA runs any rank count over any grid: 64^3 on 3 ranks is the
reference's demo, split 90112/86016/86016. The JAX package stores such a
field in a padded layout (each split axis stored as p * ceil(n/p) planes,
pad cells held at zero by masks, seams repaired after each roll) because
XLA shards only evenly. Here every rank holds its owned box, whatever its
size, so that layout and its helpers (``valid_mask``, ``to_padded``,
``from_padded``, ``shift_padded``) have no counterpart: the uneven
operators are the correction-form operators of
:mod:`poissbox_tpu_torch.parallel.dist_stencil`, which hold on boxes of any
size and offset, under the names the callers use.

What stays: the per-axis plan (:func:`axis_plan`), :func:`is_uneven`, the
red-black colour of a rank's block from global indices (:func:`color_offset`,
:func:`color_mask`), and the null-space projector, which removes the mean
over the GLOBAL DoF count (:func:`make_masked_projector`; as in the JAX
package it is applied explicitly, not folded into CG's reductions).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from poissbox_tpu_torch.ops.stencil_cuda import colour_mask
from poissbox_tpu_torch.parallel.dist_stencil import (
    apply_laplacian_sharded,
    jacobi_sweep_sharded,
    offset_parity,
    residual_sharded,
    sor_sweep_sharded,
)
from poissbox_tpu_torch.parallel.halo import allreduce_sum

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def axis_plan(n: int, p: int):
    """The JAX package's padded-layout plan for one axis: (L, counts,
    starts, fixes_plus, fixes_minus). Here only `counts` (the DMDA
    remainder convention, as ``decomp.owned_boxes``) describes storage;
    the rest is kept for parity with the reference's planner."""
    if p <= 1:
        return n, (n,), (0,), (), ()
    base, rem = divmod(n, p)
    if rem == 0:
        return base, (base,) * p, tuple(i * base for i in range(p)), (), ()
    L = base + 1
    counts = tuple(base + 1 if i < rem else base for i in range(p))
    starts = tuple(i * L for i in range(p))
    ends = tuple(starts[i] + counts[i] - 1 for i in range(p))
    fixes_plus = tuple(
        (ends[i], starts[(i + 1) % p]) for i in range(p) if counts[i] < L)
    fixes_minus = tuple(
        (starts[i], ends[(i - 1) % p]) for i in range(p)
        if counts[(i - 1) % p] < L)
    return L, counts, starts, fixes_plus, fixes_minus


def is_uneven(n: Sequence[int], pgrid: Sequence[int]) -> bool:
    return any(nd % p for nd, p in zip(n, pgrid))


def color_offset(grid) -> int:
    """The parity a rank adds to its local (i + j + k) to get the global
    one: (i0 + j0 + k0) & 1 of its box."""
    return offset_parity(grid) if grid.mesh is not None else 0


def color_mask(grid, color: int, dtype) -> Tensor:
    """Red-black mask of this rank's block from GLOBAL indices: 1 where
    the global (i + j + k) % 2 is `color` (one bool field, then the cast:
    no int64 field)."""
    return colour_mask(grid.local_shape, color ^ color_offset(grid),
                       grid.device).to(dtype)


# the uneven operators are the correction-form ones (any box, any offset)
apply_laplacian_uneven = apply_laplacian_sharded
residual_uneven = residual_sharded
jacobi_sweep_uneven = jacobi_sweep_sharded
sor_sweep_uneven = sor_sweep_sharded


def make_masked_projector(grid):
    """Null-space projector for rank blocks: x - (sum x / ndof), the sum
    taken over every rank (one all-reduce) and divided by the GLOBAL cell
    count. Not marked ``is_constant_projector``, as in the JAX package:
    CG applies it explicitly."""
    inv_n = 1.0 / float(grid.ndof)

    def project(x: Tensor) -> Tensor:
        return x - allreduce_sum(torch.sum(x), grid.mesh) * inv_n

    return project
