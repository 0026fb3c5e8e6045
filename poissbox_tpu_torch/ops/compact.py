"""6th-order staggered compact finite-difference operators (port of
:mod:`poissbox_tpu.ops.compact`).

Periodic, staggered cell<->vertex operators: a derivative or an
interpolation couples each grid line through the constant-coefficient
periodic tridiagonal system alpha*g_{i-1} + g_i + alpha*g_{i+1} = RHS_i(f).
`grad` runs the z, y, x sweeps (cell -> face -> edge -> vertex), `div` the
x, y, z sweeps (vertex -> cell); `lapl` is div(grad).

``method`` selects the line solver:

  * ``"auto"``, ``"pcr"``, ``"cuda"``: the circulant PCR path of
    :mod:`~poissbox_tpu_torch.ops.compact_pcr` — on a CUDA tensor the K15
    line kernel for every field, on a CPU tensor its plain versions;
  * ``"pallas"``: the JAX package's Thomas branch for that value. A 3-D
    field runs layout-cycled: each sweep moves its axis to the front
    (``movedim(...).contiguous()``, the copies XLA makes there) and K17
    (:mod:`~poissbox_tpu_torch.ops.tridiag_cuda`) forms the compact RHS
    inside the Thomas sweeps along axis 0 — one operator, two operators of
    one input (dual), a same-axis chain, or the summed final sweep of
    `div`; `lapl` is the fused pipeline that never stores the gradient.
    1-D and 2-D fields build the RHS with rolls and solve with the
    operator's :class:`~poissbox_tpu_torch.ops.tridiag_cuda.CudaTridiagFactor`.
    The JAX package's tile and batch gates (``f.size // n < 1024``,
    ``_fused_ok``) have no counterpart: a thread-per-line kernel has no
    minimum batch. This path exists only so that the option means what it
    means in the JAX package: no workload prefers it (on an H100 its
    Laplacian takes about 8.9x K15's at 512^3 f32 and 6.6x in f64, most of
    it in the 13 layout transposes, PERF.md), and once option parity is no
    longer required it should go, or route to K15;
  * ``"pscan"``, ``"seq"``: the RHS built with rolls, then the
    :class:`~poissbox_tpu_torch.ops.tridiag.TridiagFactor` solve (the
    plain, kernel-free path; the reference against which the kernel paths
    are held on the card).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from poissbox_tpu_torch.linops import LinearOperator, make_nullspace_projector
from poissbox_tpu_torch.ops import compact_pcr, tridiag_cuda
from poissbox_tpu_torch.ops.coefficients import (
    CompactCoeffs,
    compact_grad_coeffs,
    compact_interp_coeffs,
)
from poissbox_tpu_torch.ops.tridiag import TridiagFactor

Tensor = torch.Tensor

_PCR = ("auto", "pcr", "cuda")
_TRIDIAG = ("pscan", "seq")


def _check_method(method: str) -> None:
    if method not in _PCR + ("pallas",) + _TRIDIAG:
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
def _toeplitz_factor(n: int, alpha: float, dtype: torch.dtype, method: str):
    """The periodic (alpha, 1, alpha) system of size n, factored once:
    for "pallas" a CudaTridiagFactor (K13/K14 solves, K17's Thomas
    vectors), else the plain TridiagFactor."""
    a = torch.full((n,), alpha, dtype=dtype)
    b = torch.ones(n, dtype=dtype)
    if method == "pallas":
        return tridiag_cuda.CudaTridiagFactor(a, b, a.clone(), periodic=True)
    return TridiagFactor(a, b, a.clone(), periodic=True, method=method)


def _apply_compact(f: Tensor, coeffs: CompactCoeffs, stagger: int, axis: int,
                   method: str = "auto") -> Tensor:
    _check_method(method)
    axis %= f.dim()
    n = f.shape[axis]
    if method in _PCR:
        spec = compact_pcr._spec(coeffs, coeffs.opsign, stagger, n,
                                 compact_pcr._dtype_rtol(f.dtype))
        return compact_pcr.op_1d(f.contiguous(), spec, axis)
    if method == "pallas":
        # lines-major layout; for a 3-D field the RHS forms inside K17
        fm = f if axis == 0 else f.movedim(axis, 0)
        fac = _toeplitz_factor(n, float(coeffs.alpha), f.dtype, method)
        if fm.dim() == 3:
            out = fac.solve_compact(fm, *_op(coeffs, stagger)[1])
        else:
            rhs = compact_rhs(fm, coeffs.a, coeffs.b, coeffs.opsign, stagger, 0)
            out = fac.solve(rhs, 0)
        return out if axis == 0 else out.movedim(0, axis).contiguous()
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
#
# method="pallas" runs layout-cycled, as the JAX package does: each sweep
# solves along axis 0, and the layouts cycle (a, b, c) -> (c, a, b) so one
# transpose feeds each sweep and the last sweep lands in the output layout.
# Sweeps that share an input run as K17's dual mode, the x sweeps of the
# Laplacian (grad_x then div_x on one component) as its chain mode, and
# div's final z sweep, op(f1 + f2) + op'(f3), as its sum mode.

def _cyc(v: Tensor) -> Tensor:
    """(a, b, c) -> (c, a, b): bring the next sweep axis to the front."""
    return v.movedim(2, 0).contiguous()


def _op(coeffs: CompactCoeffs, stagger: int):
    """(alpha, rhs spec) of one staggered compact operator; the spec is
    K17's (a, b, opsign, shift)."""
    shift = 0 if stagger == -1 else 1
    return float(coeffs.alpha), (coeffs.a, coeffs.b, coeffs.opsign, shift)


def _pfac(n: int, alpha: float, dtype):
    return _toeplitz_factor(n, alpha, dtype, "pallas")


def _dual(f: Tensor, op1, op2):
    """(op1(f), op2(f)) along axis 0, one K17 launch."""
    (al1, s1), (al2, s2) = op1, op2
    n = f.shape[0]
    return tridiag_cuda.compact_dual(f, _pfac(n, al1, f.dtype), s1,
                                     _pfac(n, al2, f.dtype), s2)


def _chain(f: Tensor, op1, op2) -> Tensor:
    """op2(op1(f)) along axis 0, one K17 launch."""
    (al1, s1), (al2, s2) = op1, op2
    n = f.shape[0]
    return tridiag_cuda.compact_chain(f, _pfac(n, al1, f.dtype), s1,
                                      _pfac(n, al2, f.dtype), s2)


def _sum2(fa: Tensor, fb: Tensor, f3: Tensor, op1, op2) -> Tensor:
    """op1(fa + fb) + op2(f3) along axis 0, one K17 launch."""
    (al1, s1), (al2, s2) = op1, op2
    n = fa.shape[0]
    return tridiag_cuda.compact_sum(fa, fb, f3, _pfac(n, al1, fa.dtype), s1,
                                    _pfac(n, al2, fa.dtype), s2)


def grad(f: Tensor, deltas: Sequence[float], method: str = "auto") -> Tensor:
    """Staggered gradient tensor of a cell-centred field: (nx, ny, nz, 3),
    z -> y -> x sweeps, interpolating the non-differenced components."""
    _check_method(method)
    if method in _PCR:
        return compact_pcr.grad(f, deltas)
    dx, dy, dz = deltas
    if method == "pallas" and f.dim() == 3:
        op_i = _op(compact_interp_coeffs(), -1)
        fz = _cyc(f)                                   # (z, x, y)
        fz_i, fz_d = _dual(fz, op_i, _op(compact_grad_coeffs(dz), -1))
        yi, yd = _cyc(fz_i), _cyc(fz_d)                # (y, z, x)
        c1, c2 = _dual(yi, op_i, _op(compact_grad_coeffs(dy), -1))
        c3 = interp_1d(yd, axis=0, method=method)
        x1, x2, x3 = _cyc(c1), _cyc(c2), _cyc(c3)      # (x, y, z)
        g1 = grad_1d(x1, dx, axis=0, method=method)
        g2 = interp_1d(x2, axis=0, method=method)
        g3 = interp_1d(x3, axis=0, method=method)
        return torch.stack([g1, g2, g3], dim=-1)
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
    if method == "pallas" and F.dim() == 4:
        e1 = div_1d(F[..., 0], dx, axis=0, method=method)
        e2 = interp_1d_div(F[..., 1], axis=0, method=method)
        e3 = interp_1d_div(F[..., 2], axis=0, method=method)
        # y sweep in (y, x, z)
        y1, y2, y3 = (e.movedim(1, 0).contiguous() for e in (e1, e2, e3))
        f1 = interp_1d_div(y1, axis=0, method=method)
        f2 = div_1d(y2, dy, axis=0, method=method)
        f3 = interp_1d_div(y3, axis=0, method=method)
        # z sweep in (z, y, x), one launch: interp'(f1 + f2) + div'(f3)
        out = _sum2(_cyc(f1), _cyc(f2), _cyc(f3), _op(compact_interp_coeffs(), +1),
                    _op(compact_grad_coeffs(dz), +1))
        return out.permute(2, 1, 0).contiguous()
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
    if method == "pallas" and f.dim() == 3:
        out = interp_1d(_cyc(f), stagger=stagger, axis=0, method=method)
        out = interp_1d(_cyc(out), stagger=stagger, axis=0, method=method)
        return interp_1d(_cyc(out), stagger=stagger, axis=0, method=method)
    out = interp_1d(f, stagger=stagger, axis=2, method=method)
    out = interp_1d(out, stagger=stagger, axis=1, method=method)
    return interp_1d(out, stagger=stagger, axis=0, method=method)


def interp_div(f: Tensor, method: str = "auto") -> Tensor:
    """interp with forward (vertex -> cell) staggering."""
    return interp(f, stagger=+1, method=method)


def lapl(f: Tensor, deltas: Sequence[float], method: str = "auto") -> Tensor:
    """6th-order compact Laplacian div(grad(f)) (cell -> vertex -> cell);
    on the PCR path the regrouped three-sweep form of
    :func:`compact_pcr.lapl`; with "pallas" the JAX package's fused Thomas
    pipeline: the same per-component operator chains as div(grad), with
    the shared-input sweeps as dual launches, the x sweeps of grad and div
    as chained launches and div's z sweep as the summed launch, so the
    gradient tensor is never stored."""
    _check_method(method)
    if method in _PCR:
        return compact_pcr.lapl(f, deltas)
    if method != "pallas" or f.dim() != 3:
        return div(grad(f, deltas, method), deltas, method)
    dx, dy, dz = deltas
    op_i = _op(compact_interp_coeffs(), -1)     # interp, cell -> vertex
    op_ip = _op(compact_interp_coeffs(), +1)    # interp', vertex -> cell
    gz, gy, gx = (_op(compact_grad_coeffs(d), -1) for d in (dz, dy, dx))
    dvz, dvx = (_op(compact_grad_coeffs(d), +1) for d in (dz, dx))
    # grad z sweep in (z, x, y): interp and grad of one read
    fz_i, fz_d = _dual(_cyc(f), op_i, gz)
    # grad y sweep in (y, z, x)
    yi, yd = _cyc(fz_i), _cyc(fz_d)
    c1, c2 = _dual(yi, op_i, gy)
    c3 = interp_1d(yd, axis=0, method=method)
    # x sweeps of grad and div chained: component 1 grad_x -> div'_x,
    # components 2 and 3 interp_x -> interp'_x
    x1, x2, x3 = _cyc(c1), _cyc(c2), _cyc(c3)   # (x, y, z)
    e1 = _chain(x1, gx, dvx)
    e2 = _chain(x2, op_i, op_ip)
    e3 = _chain(x3, op_i, op_ip)
    # div y sweep in (y, x, z)
    y1, y2, y3 = (e.movedim(1, 0).contiguous() for e in (e1, e2, e3))
    f1 = interp_1d(y1, stagger=+1, axis=0, method=method)
    f2 = grad_1d(y2, dy, stagger=+1, axis=0, method=method)
    f3 = interp_1d(y3, stagger=+1, axis=0, method=method)
    # div z sweep in (z, y, x): interp'(f1 + f2) + div'(f3), one launch
    out = _sum2(_cyc(f1), _cyc(f2), _cyc(f3), op_ip, dvz)
    return out.permute(2, 1, 0).contiguous()


def make_compact_laplacian_operator(grid, method: str = "auto") -> LinearOperator:
    """The 6th-order compact Laplacian as a LinearOperator: solvable by
    Krylov methods (the 2nd-order GMG preconditions it; the operators are
    spectrally equivalent over resolved modes) or exactly by
    ``ksp_type="fft"`` through the operator's rational trigonometric
    symbol (`direct_solve`). `method` selects the line solver of `apply`
    (see the module docstring).

    On a grid over several ranks the fields are rank blocks: `apply` is
    :func:`~poissbox_tpu_torch.ops.compact_dist.lapl` (K15 on each rank's
    pencils), `direct_solve` the pencil FFT
    (:func:`~poissbox_tpu_torch.solvers.fft.compact_poisson_solve_fft_dist`),
    and the operator carries `allreduce`, `ndof` and the global
    mean-removal projector, as the distributed 7-point operator does. Only
    the K15 methods ("auto", "pcr", "cuda") run there.

    The staggered interpolation annihilates Nyquist modes, so the kernel
    is larger than span{1}: the direct solve returns the minimal-norm
    pseudo-inverse solution, and Krylov solves expect a RHS in range(A)
    (e.g. a manufactured b = A u of a smooth u).
    """
    _check_method(method)
    deltas = tuple(float(d) for d in grid.deltas)
    if grid.distributed:
        if method not in _PCR:
            raise NotImplementedError(
                f"compact method {method!r} across ranks: the distributed "
                "operators run K15's sweeps only (auto|pcr|cuda), as the JAX "
                "package's compact_dist has no method")
        from poissbox_tpu_torch.ops import compact_dist
        from poissbox_tpu_torch.parallel.halo import allreduce_sum
        from poissbox_tpu_torch.solvers.fft import compact_poisson_solve_fft_dist
        mesh = grid.mesh
        return LinearOperator(
            apply=lambda u: compact_dist.lapl(u, grid),
            nullspace=make_nullspace_projector(mesh, grid.ndof),
            symmetric=True,
            direct_solve=lambda b: compact_poisson_solve_fft_dist(b, grid),
            allreduce=lambda t: allreduce_sum(t, mesh),
            ndof=grid.ndof,
        )

    def direct_solve(b: Tensor) -> Tensor:
        from poissbox_tpu_torch.solvers.fft import compact_poisson_solve_fft
        return compact_poisson_solve_fft(b, deltas)

    return LinearOperator(
        apply=lambda u: lapl(u, deltas, method),
        nullspace=make_nullspace_projector(),
        symmetric=True,
        direct_solve=direct_solve,
    )
