"""The compact-scheme operators across ranks: each sweep on the pencil
that holds its lines whole (port of :mod:`poissbox_tpu.ops.compact_dist`).

Same numerics as the one-rank operators of
:mod:`~poissbox_tpu_torch.ops.compact_pcr`, and the same sweep programs
(``grad_sweeps``, ``div_sweeps``, ``interp_sweeps``, ``lapl_sweeps``): a
field moves to the pencil of a sweep's axis
(:mod:`~poissbox_tpu_torch.parallel.pencil`, one all-to-all for every
field the sweep reads), and the sweep runs on this rank's pencil block,
as the JAX package's ``_local_1d`` runs each line operator under
``shard_map``. A pencil holds whole lines and K15's kernel is chosen by
the line length alone, so on the card each sweep is the one-rank
operator's K15 launch on a smaller batch of lines. The Laplacian is the
regrouped three-sweep form of the one-rank operator (four layout
changes, where the JAX package's div(grad) makes eight, one for each
field between sweeps): the same values to rounding, since the per-axis
circulant operators commute.

Where a layout of the route does not divide the grid (always on an uneven
decomposition), the field is gathered, the one-rank operator runs (K15 on
the card) and each rank keeps its box: the JAX package's
``_uneven_fallback``, counted in ``halo.COUNTS["gathers"]``.

Only the K15 sweeps run across ranks: the one-rank ``method="pallas"``
(K17) exists for option parity with the JAX package, whose
``compact_dist`` has no method. On a grid of one rank every transpose is
the identity and these are the one-rank operators, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch

from poissbox_tpu_torch.ops import compact_pcr
from poissbox_tpu_torch.parallel import pencil
from poissbox_tpu_torch.parallel.halo import allgather_field

Tensor = torch.Tensor


def _run(sweeps, fields: Sequence[Tensor], grid) -> list[Tensor]:
    """Each sweep on the pencil of its axis, one transpose before it, the
    outputs moved back to the home layout; where a layout does not divide
    the grid, the one-rank sweeps on the gathered fields, this rank's box
    of each output kept."""
    if not pencil.pencil_ok(grid.n, grid.pgrid):
        out = compact_pcr.run_sweeps(sweeps, [allgather_field(f, grid) for f in fields])
        return [grid.shard(o) for o in out]
    prev = None
    for program, axis in sweeps:
        fields = pencil.to_pencil(list(fields), grid, axis, prev)
        fields = compact_pcr.sweep(program, fields, axis, key=f"compact.{'xyz'[axis]}")
        prev = axis
    return pencil.from_pencil(fields, grid, prev)


def grad(f: Tensor, grid) -> Tensor:
    """Staggered gradient tensor of this rank's cell-centred block:
    (xn, yn, zn, 3)."""
    g = _run(compact_pcr.grad_sweeps(grid.n, grid.deltas, f.dtype), [f], grid)
    return torch.stack(g, dim=-1)


def div(F: Tensor, grid) -> Tensor:
    """Divergence of this rank's block of a vertex-located (.., 3) field."""
    comps = [F[..., k].contiguous() for k in range(3)]
    return _run(compact_pcr.div_sweeps(grid.n, grid.deltas, F.dtype), comps, grid)[0]


def lapl(f: Tensor, grid) -> Tensor:
    """6th-order compact Laplacian of this rank's block: the z, y and x
    sweeps of ``compact_pcr.lapl_sweeps`` on the Z, Y and X pencils (1, 2
    and 2 fields moved in, 1 back)."""
    return _run(compact_pcr.lapl_sweeps(grid.n, grid.deltas, f.dtype), [f], grid)[0]


def interp(f: Tensor, grid, stagger: int = -1) -> Tensor:
    """Tri-directional interpolation of this rank's block, z -> y -> x."""
    return _run(compact_pcr.interp_sweeps(grid.n, stagger, f.dtype), [f], grid)[0]
