"""FFT direct Poisson solves — the fully periodic fast path (port of
:mod:`poissbox_tpu.solvers.fft`).

The DFT diagonalizes the periodic 7-point Laplacian: its eigenvalue on
mode (kx, ky, kz) is sum_d -4 sin^2(pi k_d / n_d) / d_d^2, so A^+ is two
FFTs and a pointwise multiply by the pseudo-inverse eigenvalues (the
constant mode's is zero: the same null-space semantics as the projected
Krylov solves). The 6th-order compact Laplacian is diagonalized too, by
its rational trigonometric symbol (:func:`compact_inv_eigenvalues`),
which is real, so both solves take the real-input layout:
``torch.fft.rfftn``, a multiply on the half spectrum, ``irfftn``. The
transforms are library calls, as XLA's are in the JAX package; no Pallas
kernel is involved. On one rank the multiply is one in-place pass
(:func:`~poissbox_tpu_torch.ops.spectral_cuda.symbol_scale`, a CUDA
kernel on the card) that evaluates each mode's symbol from per-axis 1-D
tables: :func:`symbol_tables` builds them once a (shape, spacing, dtype,
device, form) and keeps the last few, so no solve rebuilds the 3-D
symbol; :data:`SYMBOL_TABLES` counts the builds against the applies.

Not ported, on purpose: ``_rfft_last``, ``_rfftn_packed``,
``_spectral_solve_*`` and ``_tangled_solve_core`` (``fft.py:63-196``).
They rebuild the real transform from complex ones because XLA's native
rfft mis-computes large sizes on the TPU (``fft.py:67-69``); cuFFT's real
transforms have no such fault, so this module follows the JAX package's
CPU branch (``fft.py:204-207``, ``:510-511``).

Across ranks (``fft.py:247-393``) the 3-D transform is the transpose
method: 1-D ``torch.fft`` transforms along each axis on the pencil that
holds it whole, the pencil transposes of
:mod:`~poissbox_tpu_torch.parallel.pencil` between them. Three routes,
chosen in this order:

  * packed: ``rfft`` along z on Z-pencils, the body of the half spectrum
    (the first nz/2 modes) through the Y and X pencils, the Nyquist plane
    (nx, ny, 1) gathered once and transformed whole on every rank, back
    to Z-pencils and ``irfft`` (half the transpose bytes of the complex
    route);
  * complex: full complex transforms through the Z, Y and X pencils;
  * gather: the one-rank solve on the gathered field, this rank's box
    kept (``fft.py:352-361``).

The JAX package takes the packed route where the halved spectrum divides
the z-sharding (``_packed_dist_ok``) and lets GSPMD pad every other
layout. Owned boxes have no padding, so here a route is taken only where
every layout it passes through divides (:func:`fft_route`): packed where
nz is even and the real field's home and Z layouts and the body's Z, Y
and X layouts divide; complex where the full field's do; gather otherwise
(every uneven decomposition). Each rank builds the inverse eigenvalues of
its own pencil block from index ranges.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch

from poissbox_tpu_torch.ops import spectral_cuda
from poissbox_tpu_torch.ops.coefficients import (
    compact_grad_coeffs,
    compact_interp_coeffs,
)
from poissbox_tpu_torch.parallel import pencil
from poissbox_tpu_torch.parallel.halo import allgather_field, allreduce_max
from poissbox_tpu_torch.solvers.result import ConvergedReason, SolveResult
from poissbox_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _ranges(shape, box, device):
    """The mode indices along each axis: all of them, or the box's."""
    if box is None:
        return [torch.arange(n, device=device) for n in shape]
    return [torch.arange(s, s + c, device=device) for s, c in zip(*box)]


def _lam(k: Tensor, n: int, d: float, dtype) -> Tensor:
    """The 7-point Laplacian's 1-D eigenvalue -4 sin^2(pi k / n) / d^2,
    cancellation-free (2 cos(theta) - 2 loses ~7 digits on the low modes
    in float32)."""
    s = torch.sin((math.pi / n) * k.to(dtype))
    return (-4.0 / d**2) * s * s


def _inv_eigenvalues(shape, deltas, dtype, rfft: bool, device=None,
                     box=None) -> Tensor:
    """Pseudo-inverse eigenvalues of the periodic 7-point Laplacian, in
    rfft layout (last axis halved) or full-fft layout; with `box`
    ((starts), (counts)) only those modes (a rank's pencil block)."""
    nx, ny, nz = shape
    dx, dy, dz = deltas
    kx, ky, kz = _ranges(shape, box, device)
    if rfft and box is None:
        kz = kz[: nz // 2 + 1]
    eig = (_lam(kx, nx, dx, dtype)[:, None, None] + _lam(ky, ny, dy, dtype)[None, :, None]
           + _lam(kz, nz, dz, dtype)[None, None, :])
    nz_mask = eig != 0.0
    return torch.where(nz_mask, 1.0 / torch.where(nz_mask, eig, 1.0), 0.0)


# ---------------------------------------------------------------------------
# The one-rank solves: per-axis symbol tables and one in-place multiply
# ---------------------------------------------------------------------------

SYMBOL_TABLES = {"builds": 0, "applies": 0}
_TABLES: OrderedDict = OrderedDict()
_TABLES_KEPT = 8


def _mirrored(half: Tensor, n: int) -> Tensor:
    """A table of the modes 0 .. n//2 extended to 0 .. n-1 by t[n-k] =
    t[k], exactly."""
    return torch.cat([half, half[1:(n + 1) // 2].flip(0)])


def _axis_tables(n: int, d: float, form: str) -> list[Tensor]:
    """One axis's tables in float64 on the CPU, built on k <= n/2 and
    mirrored: [DG, II] (the real parts of the products
    :func:`_compact_symbol` forms) or [lambda]."""
    k = torch.arange(n // 2 + 1)
    if form == "sum":
        return [_mirrored(_lam(k, n, d, torch.float64), n)]
    return [_mirrored(p.real, n) for p in _axis_parts(k, n, d, torch.float64)]


def symbol_tables(shape, deltas, dtype, device, form: str):
    """(tables, peak, rel) of the `form` symbol ("compact" or "sum") for
    :func:`~poissbox_tpu_torch.ops.spectral_cuda.symbol_scale`: the
    per-axis tables computed in float64 and rounded once to `dtype`, the
    largest |S| over the spectrum as a 0-d tensor on `device` (S is even,
    so the half spectrum's), and the kernel-mode tolerance relative to it.
    Built once a key and kept, the last few keys in use."""
    key = (tuple(shape), tuple(float(d) for d in deltas), dtype, torch.device(device), form)
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    SYMBOL_TABLES["builds"] += 1
    axes = [_axis_tables(n, d, form) for n, d in zip(key[0], key[1])]
    tables = torch.stack([torch.cat(rows) for rows in zip(*axes)]).to(dtype=dtype,
                                                                       device=device)
    if form == "compact":
        peak = torch.max(torch.abs(spectral_cuda.symbol_plain(tables, key[0], form)))
        rel = 1e-6 if dtype == torch.float32 else 1e-12
    else:
        peak, rel = torch.zeros((), dtype=dtype, device=device), 0.0
    _TABLES[key] = (tables, peak, rel)
    if len(_TABLES) > _TABLES_KEPT:
        _TABLES.popitem(last=False)
    return _TABLES[key]


def _spectral_solve(b: Tensor, deltas: Sequence[float], form: str) -> Tensor:
    """x = A^+ b by rfftn, the `form` symbol's pseudo-inverse applied in
    place on the half spectrum, irfftn."""
    shape = tuple(b.shape)
    xhat = torch.fft.rfftn(b)
    with span("FFTSymbol"):
        tables, peak, rel = symbol_tables(shape, deltas, b.dtype, b.device, form)
        spectral_cuda.symbol_scale(xhat, tables, peak, rel, form)
    SYMBOL_TABLES["applies"] += 1
    return torch.fft.irfftn(xhat, s=shape).to(b.dtype)


def poisson_solve_fft(b: Tensor, deltas: Sequence[float]) -> Tensor:
    """x = A^+ b for the periodic 7-point Laplacian: exact to rounding for
    any RHS; the null-space component of b is annihilated, so x is the
    minimal-norm solution."""
    return _spectral_solve(b, deltas, "sum")


def make_fft_preconditioner(deltas: Sequence[float], grid=None):
    """The exact periodic 7-point inverse as a preconditioner
    (`-pc_type fft`): spectrally equivalent to the 6th-order compact
    operator, so FCG on that system converges in a handful of
    iterations. On a `grid` over several ranks it takes and returns rank
    blocks (:func:`poisson_solve_fft_dist`)."""
    deltas = tuple(float(d) for d in deltas)
    dist = grid is not None and grid.distributed

    def M(r: Tensor) -> Tensor:
        with span("PCApply", r):
            return poisson_solve_fft_dist(r, grid) if dist else poisson_solve_fft(r, deltas)
    return M


def fft_solver_result(A, b: Tensor, deltas: Sequence[float],
                      grid=None) -> SolveResult:
    """Run the direct solve (the operator's own spectral solve where it
    has one, 7-point or compact) and wrap it as a SolveResult: one
    iteration, the residual measured, reason CONVERGED_ATOL. On rank
    blocks (an operator with `allreduce`) the two sums are all-reduced in
    one call."""
    if getattr(A, "direct_solve", None) is not None:
        x = A.direct_solve(b)
    elif grid is not None and grid.distributed:
        x = poisson_solve_fft_dist(b, grid)
    else:
        x = poisson_solve_fft(b, deltas)
    with span("MatMult"):
        r = A.project(b) - A(x)
    sums = torch.stack([torch.sum(r * r), torch.sum(b * b)])
    if getattr(A, "allreduce", None) is not None:
        sums = A.allreduce(sums)
    resnorm, bnorm = torch.sqrt(sums).unbind()
    hist = torch.stack([bnorm, resnorm])
    dev = b.device
    return SolveResult(
        x=x,
        iterations=torch.tensor(1, dtype=torch.int32, device=dev),
        residual_norm=resnorm,
        history=hist,
        reason=torch.tensor(int(ConvergedReason.CONVERGED_ATOL),
                            dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# 6th-order compact Laplacian — spectral symbol and direct solve
# ---------------------------------------------------------------------------
#
# Each 1-D compact operator has the symbol T(theta) = R(theta)/L(theta),
# L = 1 + 2 alpha cos(theta), R = a (e^{i sh th} + s e^{i(sh-1)th}) +
# b (e^{i(sh+1)th} + s e^{i(sh-2)th}), and the 3-D div(grad) symbol is
# S = sum_d D_d G_d prod_{e != d} I_e I'_e. The staggered interpolation
# annihilates Nyquist modes (I(pi) = 0), so the inverse is the
# minimal-norm pseudo-inverse, zero on every kernel mode.

def _op_symbol(theta: Tensor, a: float, b: float, opsign: int, shift: int,
               alpha: float) -> Tensor:
    s = float(opsign)
    e = lambda m: torch.exp(1j * m * theta)
    R = (a * (e(shift) + s * e(shift - 1))
         + b * (e(shift + 1) + s * e(shift - 2)))
    return R / (1.0 + 2.0 * alpha * torch.cos(theta))


def _axis_parts(k: Tensor, n: int, d: float, dtype) -> tuple[Tensor, Tensor]:
    """One axis's D*G and I*I' on the modes `k`, complex, computed in
    `dtype`'s precision."""
    cplx = _COMPLEX[dtype]
    ci = compact_interp_coeffs()
    theta = (2.0 * math.pi / n) * k.to(dtype)
    cg = compact_grad_coeffs(d)
    G = _op_symbol(theta, cg.a, cg.b, -1, 0, cg.alpha)   # grad, cell->vtx
    D = _op_symbol(theta, cg.a, cg.b, -1, 1, cg.alpha)   # div', vtx->cell
    I = _op_symbol(theta, ci.a, ci.b, +1, 0, ci.alpha)   # interp
    Ip = _op_symbol(theta, ci.a, ci.b, +1, 1, ci.alpha)  # interp'
    return (D * G).to(cplx), (I * Ip).to(cplx)


def _compact_symbol(shape, deltas, dtype, device=None, idx=None) -> Tensor:
    """The compact Laplacian's symbol S on the modes `idx` (one index
    tensor an axis; all modes by default), complex as the JAX package
    computes it."""
    idx = _ranges(shape, None, device) if idx is None else idx
    (DGx, IIx), (DGy, IIy), (DGz, IIz) = (
        _axis_parts(k, n, float(d), dtype) for k, n, d in zip(idx, shape, deltas))
    return (DGx[:, None, None] * IIy[None, :, None] * IIz[None, None, :]
            + IIx[:, None, None] * DGy[None, :, None] * IIz[None, None, :]
            + IIx[:, None, None] * IIy[None, :, None] * DGz[None, None, :])


def _compact_inv(S: Tensor, peak: Tensor) -> Tensor:
    """1/S, zero on the kernel modes: those below a tolerance of the
    symbol's largest magnitude over the whole spectrum (`peak`)."""
    cplx = S.dtype
    tol = (1e-6 if cplx == torch.complex64 else 1e-12) * peak
    keep = torch.abs(S) > tol
    one = torch.ones((), dtype=cplx, device=S.device)
    zero = torch.zeros((), dtype=cplx, device=S.device)
    return torch.where(keep, 1.0 / torch.where(keep, S, one), zero)


def compact_inv_eigenvalues(shape, deltas, dtype, device=None) -> Tensor:
    """Pseudo-inverse eigenvalues of the 6th-order compact Laplacian, in
    full-fft layout (complex, as the JAX package returns them)."""
    S = _compact_symbol(shape, deltas, dtype, device)
    return _compact_inv(S, torch.max(torch.abs(S)))


def compact_poisson_solve_fft(b: Tensor, deltas: Sequence[float]) -> Tensor:
    """x = A^+ b for the 6th-order compact Laplacian: the symbol is real
    (the staggered half-shift phases cancel in each D*G and I*I'
    product), so the real-input transforms and the half spectrum
    serve."""
    return _spectral_solve(b, deltas, "compact")


# ---------------------------------------------------------------------------
# Across ranks: the pencil-decomposed 3-D FFT
# ---------------------------------------------------------------------------

def fft_route(shape: Sequence[int], pgrid: Sequence[int]) -> str:
    """The distributed solve's route for a grid of `shape` over `pgrid`:
    "packed", "complex" or "gather" (see the module docstring)."""
    nx, ny, nz = shape
    if (nz % 2 == 0 and pencil.pencil_ok(shape, pgrid, (None, 2))
            and pencil.pencil_ok((nx, ny, nz // 2), pgrid, (2, 1, 0))):
        return "packed"
    if pencil.pencil_ok(shape, pgrid):
        return "complex"
    return "gather"


def _box(shape, grid, local_dim):
    return pencil.block_of(shape, grid.pgrid, pencil.pencil_spec(grid, local_dim),
                           grid.mesh.rank)


def _spectral_solve_pencil(b: Tensor, grid, inv: Tensor) -> Tensor:
    """x = F^-1 (inv * F b) through the Z, Y and X pencils, complex; `inv`
    is this rank's X-pencil block of the inverse eigenvalues."""
    cplx = _COMPLEX[b.dtype]
    f = pencil.to_pencil(b, grid, 2).to(cplx)
    f = torch.fft.fft(f, dim=2)
    prev = 2
    for axis in (1, 0):
        f = torch.fft.fft(pencil.to_pencil(f, grid, axis, prev), dim=axis)
        prev = axis
    f = f * inv
    for axis in (0, 1, 2):
        f = torch.fft.ifft(pencil.to_pencil(f, grid, axis, prev), dim=axis)
        prev = axis
    return pencil.from_pencil(f.real.to(b.dtype).contiguous(), grid, 2)


def _spectral_solve_pencil_packed(b: Tensor, grid, inv_body: Tensor,
                                  inv_nyq: Tensor) -> Tensor:
    """The packed-real pencil solve: ``rfft`` along z on Z-pencils; the
    body of the half spectrum (modes 0 .. nz/2 - 1) through the Y and X
    pencils, times `inv_body` (this rank's X-pencil block of it); the
    Nyquist plane gathered once, transformed whole on every rank and
    multiplied by `inv_nyq` (nx, ny, 1); then back and ``irfft``."""
    nx, ny, nz = grid.n
    n2 = nz // 2
    body_shape = (nx, ny, n2)
    U = torch.fft.rfft(pencil.to_pencil(b, grid, 2), dim=2)
    body = U[..., :n2].contiguous()
    nyq = pencil.allgather_blocks(U[..., n2:].contiguous(), grid,
                                  pencil.pencil_spec(grid, 2), (nx, ny, 1))
    prev = 2
    for axis in (1, 0):
        body = torch.fft.fft(pencil.to_pencil(body, grid, axis, prev, body_shape), dim=axis)
        nyq = torch.fft.fft(nyq, dim=axis)
        prev = axis
    body = body * inv_body
    nyq = nyq * inv_nyq
    for axis in (0, 1):
        body = torch.fft.ifft(pencil.to_pencil(body, grid, axis, prev, body_shape), dim=axis)
        nyq = torch.fft.ifft(nyq, dim=axis)
        prev = axis
    body = pencil.to_pencil(body, grid, 2, prev, body_shape)
    (sx, sy, _), (cx, cy, _) = _box(grid.n, grid, 2)
    half = torch.cat([body, nyq[sx:sx + cx, sy:sy + cy]], dim=2)
    # the kz = 0 and kz = nz/2 planes of a real field are real: irfft drops
    # their imaginary rounding on the CPU, cuFFT's C2R does not (at 256^3
    # f32 on an H100 that tripled the order-6 residual, 8.86e-4 against
    # 3.21e-4 with these zeroed, PERF.md)
    half[..., 0].imag.zero_()
    half[..., n2].imag.zero_()
    x = torch.fft.irfft(half, n=nz, dim=2).to(b.dtype).contiguous()
    return pencil.from_pencil(x, grid, 2)


def _gathered_solve(solve, b: Tensor, grid) -> Tensor:
    """The one-rank `solve` on the gathered b; this rank's box of x."""
    return grid.shard(solve(allgather_field(b, grid), grid.deltas))


def poisson_solve_fft_dist(b: Tensor, grid) -> Tensor:
    """x = A^+ b for the periodic 7-point Laplacian on this rank's block
    of a grid over several ranks (the one-rank solve on one rank)."""
    if not grid.distributed:
        return poisson_solve_fft(b, grid.deltas)
    route = fft_route(grid.n, grid.pgrid)
    if route == "gather":
        return _gathered_solve(poisson_solve_fft, b, grid)
    deltas = tuple(float(d) for d in grid.deltas)
    if route == "complex":
        inv = _inv_eigenvalues(grid.n, deltas, b.dtype, rfft=False, device=b.device,
                               box=_box(grid.n, grid, 0))
        return _spectral_solve_pencil(b, grid, inv)
    nx, ny, nz = grid.n
    inv_body = _inv_eigenvalues(grid.n, deltas, b.dtype, rfft=True, device=b.device,
                                box=_box((nx, ny, nz // 2), grid, 0))
    inv_nyq = _inv_eigenvalues(grid.n, deltas, b.dtype, rfft=True, device=b.device,
                               box=((0, 0, nz // 2), (nx, ny, 1)))
    return _spectral_solve_pencil_packed(b, grid, inv_body, inv_nyq)


def compact_poisson_solve_fft_dist(b: Tensor, grid) -> Tensor:
    """x = A^+ b for the 6th-order compact Laplacian on this rank's block
    (the one-rank solve on one rank). The symbol's kernel-mode tolerance
    is relative to its largest magnitude over the whole spectrum: each
    rank takes the maximum over its blocks, which together cover every
    mode (the packed route's blocks with their mirror images kz -> nz -
    kz, since the symbol is even), and one all-reduce takes the maximum
    over ranks."""
    if not grid.distributed:
        return compact_poisson_solve_fft(b, grid.deltas)
    route = fft_route(grid.n, grid.pgrid)
    if route == "gather":
        return _gathered_solve(compact_poisson_solve_fft, b, grid)
    deltas = tuple(float(d) for d in grid.deltas)
    nx, ny, nz = grid.n
    dev = b.device
    sym = lambda idx: _compact_symbol(grid.n, deltas, b.dtype, dev, idx)
    box = _box(grid.n if route == "complex" else (nx, ny, nz // 2), grid, 0)
    idx = _ranges(None, box, dev)
    S = sym(idx)
    peak = torch.max(torch.abs(S))
    if route == "packed":
        kx, ky, kz = idx
        S_nyq = sym([torch.arange(nx, device=dev), torch.arange(ny, device=dev),
                     torch.tensor([nz // 2], device=dev)])
        peak = torch.maximum(peak, torch.max(torch.abs(S_nyq)))
        peak = torch.maximum(peak, torch.max(torch.abs(sym([kx, ky, (nz - kz) % nz]))))
    peak = allreduce_max(peak.reshape(1), grid.mesh)[0]
    if route == "complex":
        return _spectral_solve_pencil(b, grid, _compact_inv(S, peak).real)
    return _spectral_solve_pencil_packed(b, grid, _compact_inv(S, peak).real,
                                         _compact_inv(S_nyq, peak).real)
