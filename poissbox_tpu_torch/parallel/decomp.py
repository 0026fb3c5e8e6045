"""3-D process-grid decomposition, the PETSC_DECIDE analogue (a copy of
:mod:`poissbox_tpu.parallel.decomp`'s pure-Python planner).

The JAX package's module is copied, not imported: importing any module of
``poissbox_tpu`` imports jax. As there, :func:`decompose_3d` runs the
native C++ planner (:mod:`poissbox_tpu_torch.native`, the port's own copy,
identical semantics) once its library is built; the Python implementation
below is its reference and runs otherwise.

Given `ndev` ranks and a global grid (nx, ny, nz), :func:`decompose_3d`
returns the (px, py, pz) factorisation of least halo surface, preferring
factors that divide the grid and parallelism on the slowest-varying axes.
:func:`owned_boxes` gives each process coordinate its box, remainder cells
to the leading ranks (DMDAGetCorners' layout).
"""

from __future__ import annotations

import itertools
from typing import Sequence


def _factor_triples(n: int):
    """All ordered triples (a, b, c) with a*b*c == n."""
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            yield (a, b, m // b)


def decompose_3d(ndev: int, shape: Sequence[int]) -> tuple[int, int, int]:
    """Choose a process grid (px, py, pz) for `ndev` ranks on grid `shape`:
    least surface 2*(sx*sy + sy*sz + sz*sx) of the per-rank box, exact
    division preferred, then splitting x, then y, z kept whole. The native
    planner answers where its library is built (a built library that
    fails raises: nothing falls back)."""
    from poissbox_tpu_torch import native
    if native.available():
        return native.decompose_3d(ndev, shape)
    return python_decompose_3d(ndev, shape)


def python_decompose_3d(ndev: int, shape: Sequence[int]) -> tuple[int, int, int]:
    """:func:`decompose_3d` in Python: the native planner's reference."""
    nx, ny, nz = shape
    best = None
    for (px, py, pz) in _factor_triples(ndev):
        if px > nx or py > ny or pz > nz:
            continue
        exact = (nx % px == 0) and (ny % py == 0) and (nz % pz == 0)
        sx, sy, sz = -(-nx // px), -(-ny // py), -(-nz // pz)
        surface = 2.0 * (sx * sy * (pz > 1) + sy * sz * (px > 1) + sz * sx * (py > 1))
        key = (not exact, surface, pz, py, px)
        if best is None or key < best[0]:
            best = (key, (px, py, pz))
    if best is None:
        raise ValueError(f"cannot decompose {ndev} devices over grid {tuple(shape)}")
    return best[1]


def axis_boxes(n: int, p: int) -> list[tuple[int, int]]:
    """(start, count) of each of `p` ranks along an axis of `n` cells,
    remainder cells to the leading ranks."""
    base, rem = divmod(n, p)
    counts = [base + (1 if i < rem else 0) for i in range(p)]
    return [(sum(counts[:i]), counts[i]) for i in range(p)]


def owned_boxes(shape: Sequence[int], pgrid: Sequence[int]):
    """Owned-box (start, count) per process coordinate, the DMDAGetCorners
    analogue: a dict mapping (ix, iy, iz) to ((xs, ys, zs), (xn, yn, zn))."""
    out = {}
    starts_counts = [axis_boxes(n, p) for n, p in zip(shape, pgrid)]
    for (ix, iy, iz) in itertools.product(*(range(p) for p in pgrid)):
        xs, xn = starts_counts[0][ix]
        ys, yn = starts_counts[1][iy]
        zs, zn = starts_counts[2][iz]
        out[(ix, iy, iz)] = ((xs, ys, zs), (xn, yn, zn))
    return out


def dof_distribution(shape: Sequence[int], pgrid: Sequence[int]) -> list[int]:
    """Per-rank DoF counts, in rank order (the reference reports
    90112/86016/86016 for 64^3 on 3 ranks)."""
    return [
        xn * yn * zn
        for (_, (_, (xn, yn, zn))) in sorted(owned_boxes(shape, pgrid).items())
    ]
