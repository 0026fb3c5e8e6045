"""FFT direct Poisson solves — the fully periodic fast path (port of the
single-device part of :mod:`poissbox_tpu.solvers.fft`).

The DFT diagonalizes the periodic 7-point Laplacian: its eigenvalue on
mode (kx, ky, kz) is sum_d -4 sin^2(pi k_d / n_d) / d_d^2, so A^+ is two
FFTs and a pointwise multiply by the pseudo-inverse eigenvalues (the
constant mode's is zero: the same null-space semantics as the projected
Krylov solves). The 6th-order compact Laplacian is diagonalized too, by
its rational trigonometric symbol (:func:`compact_inv_eigenvalues`),
which is real, so both solves take the real-input layout:
``torch.fft.rfftn``, a multiply on the half spectrum, ``irfftn``. The
transforms are library calls, as XLA's are in the JAX package; no Pallas
kernel is involved.

Not ported, on purpose: ``_rfft_last``, ``_rfftn_packed``,
``_spectral_solve_*`` and ``_tangled_solve_core`` (``fft.py:63-196``).
They rebuild the real transform from complex ones because XLA's native
rfft mis-computes large sizes on the TPU (``fft.py:67-69``); cuFFT's real
transforms have no such fault, so this module follows the JAX package's
CPU branch (``fft.py:204-207``, ``:510-511``). The distributed (pencil)
solves come with the multi-device slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from poissbox_tpu_torch.ops.coefficients import (
    compact_grad_coeffs,
    compact_interp_coeffs,
)
from poissbox_tpu_torch.solvers.result import ConvergedReason, SolveResult

Tensor = torch.Tensor

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _inv_eigenvalues(shape, deltas, dtype, rfft: bool, device=None) -> Tensor:
    """Pseudo-inverse eigenvalues of the periodic 7-point Laplacian, in
    rfft layout (last axis halved) or full-fft layout."""
    nx, ny, nz = shape
    dx, dy, dz = deltas

    def lam(n, d):
        # -4 sin^2(theta/2), cancellation-free (2 cos(theta) - 2 loses
        # ~7 digits on the low modes in float32)
        k = torch.arange(n, dtype=dtype, device=device)
        s = torch.sin((math.pi / n) * k)
        return (-4.0 / d**2) * s * s

    lz = lam(nz, dz)
    if rfft:
        lz = lz[: nz // 2 + 1]
    eig = (lam(nx, dx)[:, None, None] + lam(ny, dy)[None, :, None]
           + lz[None, None, :])
    nz_mask = eig != 0.0
    return torch.where(nz_mask, 1.0 / torch.where(nz_mask, eig, 1.0), 0.0)


def poisson_solve_fft(b: Tensor, deltas: Sequence[float]) -> Tensor:
    """x = A^+ b for the periodic 7-point Laplacian: exact to rounding for
    any RHS; the null-space component of b is annihilated, so x is the
    minimal-norm solution."""
    shape = tuple(b.shape)
    inv = _inv_eigenvalues(shape, tuple(float(d) for d in deltas), b.dtype,
                           rfft=True, device=b.device)
    xhat = torch.fft.rfftn(b) * inv
    return torch.fft.irfftn(xhat, s=shape).to(b.dtype)


def make_fft_preconditioner(deltas: Sequence[float], grid=None):
    """The exact periodic 7-point inverse as a preconditioner
    (`-pc_type fft`): spectrally equivalent to the 6th-order compact
    operator, so FCG on that system converges in a handful of
    iterations. (`grid` is accepted for the JAX package's signature; a
    single-device grid adds nothing.)"""
    deltas = tuple(float(d) for d in deltas)
    return lambda r: poisson_solve_fft(r, deltas)


def fft_solver_result(A, b: Tensor, deltas: Sequence[float],
                      grid=None) -> SolveResult:
    """Run the direct solve (the operator's own spectral solve where it
    has one, 7-point or compact) and wrap it as a SolveResult: one
    iteration, the residual measured, reason CONVERGED_ATOL."""
    if getattr(A, "direct_solve", None) is not None:
        x = A.direct_solve(b)
    else:
        x = poisson_solve_fft(b, deltas)
    r = A.project(b) - A(x)
    resnorm = torch.sqrt(torch.sum(r * r))
    hist = torch.stack([torch.sqrt(torch.sum(b * b)), resnorm])
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


def compact_inv_eigenvalues(shape, deltas, dtype, device=None) -> Tensor:
    """Pseudo-inverse eigenvalues of the 6th-order compact Laplacian, in
    full-fft layout (complex, as the JAX package returns them)."""
    cplx = _COMPLEX[dtype]
    real = dtype
    ci = compact_interp_coeffs()

    def axis_parts(n, d):
        theta = (2.0 * math.pi / n) * torch.arange(n, dtype=real, device=device)
        cg = compact_grad_coeffs(d)
        G = _op_symbol(theta, cg.a, cg.b, -1, 0, cg.alpha)   # grad, cell->vtx
        D = _op_symbol(theta, cg.a, cg.b, -1, 1, cg.alpha)   # div', vtx->cell
        I = _op_symbol(theta, ci.a, ci.b, +1, 0, ci.alpha)   # interp
        Ip = _op_symbol(theta, ci.a, ci.b, +1, 1, ci.alpha)  # interp'
        return (D * G).to(cplx), (I * Ip).to(cplx)

    nx, ny, nz = shape
    dx, dy, dz = deltas
    DGx, IIx = axis_parts(nx, dx)
    DGy, IIy = axis_parts(ny, dy)
    DGz, IIz = axis_parts(nz, dz)
    S = (DGx[:, None, None] * IIy[None, :, None] * IIz[None, None, :]
         + IIx[:, None, None] * DGy[None, :, None] * IIz[None, None, :]
         + IIx[:, None, None] * IIy[None, :, None] * DGz[None, None, :])
    mag = torch.abs(S)
    tol = (1e-6 if cplx == torch.complex64 else 1e-12) * torch.max(mag)
    keep = mag > tol
    one = torch.ones((), dtype=cplx, device=device)
    zero = torch.zeros((), dtype=cplx, device=device)
    return torch.where(keep, 1.0 / torch.where(keep, S, one), zero)


def compact_poisson_solve_fft(b: Tensor, deltas: Sequence[float]) -> Tensor:
    """x = A^+ b for the 6th-order compact Laplacian: the symbol is real
    (the staggered half-shift phases cancel in each D*G and I*I'
    product), so the real-input transforms and the half spectrum
    serve."""
    shape = tuple(b.shape)
    inv = compact_inv_eigenvalues(shape, tuple(float(d) for d in deltas),
                                  b.dtype, device=b.device)
    xhat = torch.fft.rfftn(b) * inv.real[..., : shape[-1] // 2 + 1]
    return torch.fft.irfftn(xhat, s=shape).to(b.dtype)
