"""6th-order staggered compact finite-difference operators (port of
:mod:`poissbox_tpu.ops.compact`).

Periodic, staggered cell<->vertex operators: a derivative or an
interpolation couples each grid line through the constant-coefficient
periodic tridiagonal system alpha*g_{i-1} + g_i + alpha*g_{i+1} = RHS_i(f).
`grad` runs the z, y, x sweeps (cell -> face -> edge -> vertex), `div` the
x, y, z sweeps (vertex -> cell); `lapl` is div(grad).

``method`` selects the line solver:

  * ``"auto"``, ``"pcr"``, ``"pallas"``, ``"cuda"``: the circulant PCR
    path of :mod:`~poissbox_tpu_torch.ops.compact_pcr` — on a CUDA tensor
    the K15 line kernel for every field, on a CPU tensor its plain
    versions (``"pallas"`` is accepted so the JAX package's option values
    run unchanged);
  * ``"pscan"``, ``"seq"``: the RHS built with rolls, then the
    :class:`~poissbox_tpu_torch.ops.tridiag.TridiagFactor` solve (the
    plain, kernel-free path; the reference against which the kernel path
    is held on the card).

Not ported, on purpose: the JAX package's layout cycling (``_cyc``), its
``_fused_ok`` gate and the fused Thomas pipeline through K17
(``compact.py:186-262``, ``:396-425``). They exist because the TPU's PCR
kernels compile only at Mosaic-safe extents and in 32-bit types; here one
PCR path serves every n >= 4 in float32 and float64, along any axis in
the field's own layout.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from poissbox_tpu_torch.linops import LinearOperator, make_nullspace_projector
from poissbox_tpu_torch.ops import compact_pcr
from poissbox_tpu_torch.ops.coefficients import (
    CompactCoeffs,
    compact_grad_coeffs,
    compact_interp_coeffs,
)
from poissbox_tpu_torch.ops.tridiag import TridiagFactor

Tensor = torch.Tensor

_PCR = ("auto", "pcr", "pallas", "cuda")
_TRIDIAG = ("pscan", "seq")


def _check_method(method: str) -> None:
    if method not in _PCR + _TRIDIAG:
        raise ValueError(f"unknown compact method {method!r} (expected "
                         "auto|pcr|pallas|cuda|pscan|seq)")


# ---------------------------------------------------------------------------
# RHS evaluation
# ---------------------------------------------------------------------------

def compact_rhs(f: Tensor, a: float, b: float, opsign: int, stagger: int,
                axis: int = -1) -> Tensor:
    """Periodic staggered compact-scheme RHS along `axis`: with shift = 0
    (stagger -1, cells -> vertices) or 1 (stagger +1) and s = opsign,
    rhs_i = a*(f_{i+shift} + s*f_{i-1+shift}) + b*(f_{i+1+shift} + s*f_{i-2+shift})."""
    if stagger not in (-1, +1):
        raise ValueError(f"stagger must be -1 (cell->vertex) or +1 "
                         f"(vertex->cell), got {stagger}")
    if opsign not in (-1, +1):
        raise ValueError(f"opsign must be -1 (difference) or +1 "
                         f"(interpolation), got {opsign}")
    shift = 0 if stagger == -1 else 1
    s = float(opsign)
    at = lambda k: torch.roll(f, -k, axis)   # f_{i+k}
    return a * (at(shift) + s * at(shift - 1)) + b * (at(shift + 1) + s * at(shift - 2))


@functools.lru_cache(maxsize=None)
def _toeplitz_factor(n: int, alpha: float, dtype: torch.dtype,
                     method: str) -> TridiagFactor:
    """The periodic (alpha, 1, alpha) system of size n, factored once."""
    return TridiagFactor(torch.full((n,), alpha, dtype=dtype),
                         torch.ones(n, dtype=dtype),
                         torch.full((n,), alpha, dtype=dtype),
                         periodic=True, method=method)


def _apply_compact(f: Tensor, coeffs: CompactCoeffs, stagger: int, axis: int,
                   method: str = "auto") -> Tensor:
    _check_method(method)
    axis %= f.dim()
    n = f.shape[axis]
    if method in _PCR:
        spec = compact_pcr._spec(coeffs, coeffs.opsign, stagger, n,
                                 compact_pcr._dtype_rtol(f.dtype))
        return compact_pcr.op_1d(f.contiguous(), spec, axis)
    rhs = compact_rhs(f, coeffs.a, coeffs.b, coeffs.opsign, stagger, axis)
    return _toeplitz_factor(n, float(coeffs.alpha), f.dtype, method).solve(rhs, axis)


# ---------------------------------------------------------------------------
# 1-D operators (batched along all other axes)
# ---------------------------------------------------------------------------

def grad_1d(f: Tensor, dx: float, stagger: int = -1, axis: int = -1,
            method: str = "auto") -> Tensor:
    """6th-order staggered first derivative along `axis`; stagger -1:
    cell-centred input, vertex-located derivative."""
    return _apply_compact(f, compact_grad_coeffs(dx), stagger, axis, method)


def div_1d(f: Tensor, dx: float, axis: int = -1, method: str = "auto") -> Tensor:
    """grad_1d with forward stagger (vertices -> cells)."""
    return grad_1d(f, dx, stagger=+1, axis=axis, method=method)


def interp_1d(f: Tensor, stagger: int = -1, axis: int = -1,
              method: str = "auto") -> Tensor:
    """6th-order staggered midpoint interpolation along `axis`."""
    return _apply_compact(f, compact_interp_coeffs(), stagger, axis, method)


def interp_1d_div(f: Tensor, axis: int = -1, method: str = "auto") -> Tensor:
    """interp_1d with forward stagger (vertices -> cells)."""
    return interp_1d(f, stagger=+1, axis=axis, method=method)


# ---------------------------------------------------------------------------
# 3-D operators
# ---------------------------------------------------------------------------

def grad(f: Tensor, deltas: Sequence[float], method: str = "auto") -> Tensor:
    """Staggered gradient tensor of a cell-centred field: (nx, ny, nz, 3),
    z -> y -> x sweeps, interpolating the non-differenced components."""
    _check_method(method)
    if method in _PCR:
        return compact_pcr.grad(f, deltas)
    dx, dy, dz = deltas
    fz_i = interp_1d(f, axis=2, method=method)
    fz_d = grad_1d(f, dz, axis=2, method=method)
    c1 = interp_1d(fz_i, axis=1, method=method)
    c2 = grad_1d(fz_i, dy, axis=1, method=method)
    c3 = interp_1d(fz_d, axis=1, method=method)
    g1 = grad_1d(c1, dx, axis=0, method=method)
    g2 = interp_1d(c2, axis=0, method=method)
    g3 = interp_1d(c3, axis=0, method=method)
    return torch.stack([g1, g2, g3], dim=-1)


def div(F: Tensor, deltas: Sequence[float], method: str = "auto") -> Tensor:
    """Divergence of a vertex-located vector field (nx, ny, nz, 3) ->
    cells: x -> y -> z sweeps, differencing one component per sweep."""
    _check_method(method)
    if method in _PCR:
        return compact_pcr.div(F, deltas)
    dx, dy, dz = deltas
    e1 = div_1d(F[..., 0], dx, axis=0, method=method)
    e2 = interp_1d_div(F[..., 1], axis=0, method=method)
    e3 = interp_1d_div(F[..., 2], axis=0, method=method)
    f1 = interp_1d_div(e1, axis=1, method=method)
    f2 = div_1d(e2, dy, axis=1, method=method)
    f3 = interp_1d_div(e3, axis=1, method=method)
    return (interp_1d_div(f1 + f2, axis=2, method=method)
            + div_1d(f3, dz, axis=2, method=method))


def interp(f: Tensor, stagger: int = -1, method: str = "auto") -> Tensor:
    """Tri-directional interpolation, z -> y -> x."""
    _check_method(method)
    if method in _PCR:
        return compact_pcr.interp(f, stagger=stagger)
    out = interp_1d(f, stagger=stagger, axis=2, method=method)
    out = interp_1d(out, stagger=stagger, axis=1, method=method)
    return interp_1d(out, stagger=stagger, axis=0, method=method)


def interp_div(f: Tensor, method: str = "auto") -> Tensor:
    """interp with forward (vertex -> cell) staggering."""
    return interp(f, stagger=+1, method=method)


def lapl(f: Tensor, deltas: Sequence[float], method: str = "auto") -> Tensor:
    """6th-order compact Laplacian div(grad(f)) (cell -> vertex -> cell);
    on the PCR path the regrouped three-sweep form of
    :func:`compact_pcr.lapl`."""
    _check_method(method)
    if method in _PCR:
        return compact_pcr.lapl(f, deltas)
    return div(grad(f, deltas, method), deltas, method)


def make_compact_laplacian_operator(grid, method: str = "auto") -> LinearOperator:
    """The 6th-order compact Laplacian as a LinearOperator: solvable by
    Krylov methods (the 2nd-order GMG preconditions it; the operators are
    spectrally equivalent over resolved modes) or exactly by
    ``ksp_type="fft"`` through the operator's rational trigonometric
    symbol (`direct_solve`). `method` selects the line solver of `apply`
    (see the module docstring).

    The staggered interpolation annihilates Nyquist modes, so the kernel
    is larger than span{1}: the direct solve returns the minimal-norm
    pseudo-inverse solution, and Krylov solves expect a RHS in range(A)
    (e.g. a manufactured b = A u of a smooth u).
    """
    _check_method(method)
    deltas = tuple(float(d) for d in grid.deltas)

    def direct_solve(b: Tensor) -> Tensor:
        from poissbox_tpu_torch.solvers.fft import compact_poisson_solve_fft
        return compact_poisson_solve_fft(b, deltas)

    return LinearOperator(
        apply=lambda u: lapl(u, deltas, method),
        nullspace=make_nullspace_projector(),
        symmetric=True,
        direct_solve=direct_solve,
    )
