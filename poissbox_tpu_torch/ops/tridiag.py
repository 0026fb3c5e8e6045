"""Batched tridiagonal solvers — Thomas, a log-depth scan, and the periodic
(Sherman–Morrison) form (port of :mod:`poissbox_tpu.ops.tridiag`).

The plain, kernel-free stack. Argument convention: ``(a=sub-diagonal,
b=diagonal, c=super-diagonal, d=rhs)``; coefficient vectors are (n,) and
shared across the batch, the RHS carries the line along `axis` and any
batch dims elsewhere.

  * ``method='seq'``: a Python loop along the line, each step one vector
    operation over the batch;
  * ``method='pscan'``: both Thomas sweeps as first-order linear
    recurrences y_i = A_i*y_{i-1} + B_i, evaluated by recursive doubling
    in log2(n) vector steps (the JAX package uses
    ``lax.associative_scan``; the sums group differently, so the two
    agree to rounding, not bit for bit).

The factorization (`_factor_1d`) is RHS-independent and computed once per
coefficient set, in the coefficients' dtype, in the JAX package's order.
Periodic systems use Sherman–Morrison with gamma = -b[0].
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# first-order linear recurrence y_i = A_i * y_{i-1} + B_i
# ---------------------------------------------------------------------------

def _linrec(A: Tensor, B: Tensor, method: str, axis: int = 0,
            reverse: bool = False) -> Tensor:
    """Solve y_i = A_i*y_{i-1} + B_i along `axis` (y_{-1} = 0); with
    `reverse` from the far end (y_i = A_i*y_{i+1} + B_i)."""
    if method not in ("pscan", "seq"):
        raise ValueError(f"unknown method {method!r} (expected 'seq' or 'pscan')")
    if reverse:
        A, B = A.flip(axis), B.flip(axis)
    n = B.shape[axis]
    if method == "pscan":
        # recursive doubling: after the step with offset o, (A_i, B_i) is
        # the composition of the recurrence over rows i-2o+1 .. i
        off = 1
        while off < n:
            a_lo, b_lo = A.narrow(axis, 0, n - off), B.narrow(axis, 0, n - off)
            a_hi, b_hi = A.narrow(axis, off, n - off), B.narrow(axis, off, n - off)
            A = torch.cat([A.narrow(axis, 0, off), a_hi * a_lo], axis)
            B = torch.cat([B.narrow(axis, 0, off), a_hi * b_lo + b_hi], axis)
            off *= 2
        y = B
    else:
        rows = []
        prev = torch.zeros_like(B.select(axis, 0))
        for i in range(n):
            prev = A.select(axis, i) * prev + B.select(axis, i)
            rows.append(prev)
        y = torch.stack(rows, axis)
    return y.flip(axis) if reverse else y


# ---------------------------------------------------------------------------
# factorization (RHS-independent part of the forward elimination)
# ---------------------------------------------------------------------------

def _factor_1d(a: Tensor, b: Tensor, c: Tensor):
    """LU-factor 1-D coefficient vectors (n,) -> (w, bmod), both (n,):
    bmod_0 = b_0; w_i = a_i / bmod_{i-1}; bmod_i = b_i - w_i * c_{i-1}.
    A continued fraction, so sequential; run once per coefficient set on
    the host in the coefficients' dtype (numpy scalars round as the
    dtype does)."""
    an, bn, cn = (v.detach().cpu().numpy() for v in (a, b, c))
    n = bn.shape[0]
    w = np.zeros_like(bn)
    bmod = np.empty_like(bn)
    bmod[0] = bn[0]
    for i in range(1, n):
        w[i] = an[i] / bmod[i - 1]
        bmod[i] = bn[i] - w[i] * cn[i - 1]
    return (torch.as_tensor(w, device=b.device),
            torch.as_tensor(bmod, device=b.device))


def _coef_shape(v: Tensor, d: Tensor, axis: int) -> Tensor:
    """Broadcast a (n,) coefficient vector against the RHS along `axis`."""
    axis = axis % d.dim()
    shape = [1] * d.dim()
    shape[axis] = v.shape[0]
    return v.to(d.device).reshape(shape)


def _apply_fwd(w: Tensor, d: Tensor, axis: int, method: str) -> Tensor:
    """dmod_i = d_i - w_i * dmod_{i-1}."""
    A = (-_coef_shape(w, d, axis)).expand(d.shape)
    return _linrec(A, d, method, axis=axis % d.dim())


def _apply_bwd(bmod: Tensor, c: Tensor, d: Tensor, axis: int,
               method: str) -> Tensor:
    """x_i = d_i/bmod_i - (c_i/bmod_i) * x_{i+1}."""
    axis = axis % d.dim()
    binv = 1.0 / bmod
    B = d * _coef_shape(binv, d, axis)
    cb = c * binv
    cb[-1] = 0.0
    A = (-_coef_shape(cb, d, axis)).expand(d.shape)
    return _linrec(A, B, method, axis=axis, reverse=True)


def _vectors(a, b, c):
    a, b, c = (torch.as_tensor(v) for v in (a, b, c))
    return torch.broadcast_tensors(a, b, c)


def fwd_sweep(a, b, c, d: Tensor, axis: int = -1, method: str = "seq"):
    """Forward elimination; returns (bmod, dmod)."""
    a1, b1, c1 = _vectors(a, b, c)
    if a1.dim() != 1:
        raise ValueError("fwd_sweep expects 1-D coefficient vectors")
    w, bmod = _factor_1d(a1, b1, c1)
    return bmod, _apply_fwd(w, d, axis, method)


def bwd_sweep(b, c, d: Tensor, axis: int = -1, method: str = "seq") -> Tensor:
    """Back substitution: x_n = d_n/b_n; x_i = (d_i - c_i x_{i+1}) / b_i."""
    b1, c1 = torch.broadcast_tensors(torch.as_tensor(b), torch.as_tensor(c))
    return _apply_bwd(b1, c1, d, axis, method)


# ---------------------------------------------------------------------------
# public solvers
# ---------------------------------------------------------------------------

def tdma(a, b, c, d: Tensor, axis: int = -1, method: str = "seq") -> Tensor:
    """Solve the (non-periodic) tridiagonal system along `axis` of d
    (a[0] and c[n-1] are ignored)."""
    a1, b1, c1 = _vectors(a, b, c)
    w, bmod = _factor_1d(a1, b1, c1)
    return _apply_bwd(bmod, c1, _apply_fwd(w, d, axis, method), axis, method)


class TridiagFactor:
    """Precomputed factorization of a fixed tridiagonal (or periodic
    tridiagonal) system, applied to many RHS batches; the periodic
    correction vector is computed once here too."""

    def __init__(self, a, b, c, periodic: bool, method: str = "pscan"):
        a, b, c = _vectors(a, b, c)
        self.method = method
        self.periodic = periodic
        self.c = c
        if not periodic:
            self.w, self.bmod = _factor_1d(a, b, c)
            return
        n = b.shape[0]
        gamma = -b[0]
        bmod = b.clone()
        bmod[0] -= gamma
        bmod[n - 1] -= c[n - 1] * a[0] / gamma
        self.w, self.bmod = _factor_1d(a, bmod, c)
        u = torch.zeros_like(b)
        u[0] = gamma
        u[n - 1] = c[n - 1]
        self.usol = self._solve_core(u, axis=0)
        self.alpha_ratio = a[0] / gamma
        self.denom = 1.0 + self.usol[0] + self.alpha_ratio * self.usol[n - 1]

    def _solve_core(self, d: Tensor, axis: int) -> Tensor:
        dmod = _apply_fwd(self.w, d, axis, self.method)
        return _apply_bwd(self.bmod, self.c, dmod, axis, self.method)

    def solve(self, d: Tensor, axis: int = -1) -> Tensor:
        """Solve along `axis` of the (arbitrarily batched) RHS d."""
        axis = axis % d.dim()
        y = self._solve_core(d, axis)
        if not self.periodic:
            return y
        y0 = y.narrow(axis, 0, 1)
        yn = y.narrow(axis, y.shape[axis] - 1, 1)
        ar, den = (v.to(d.device) for v in (self.alpha_ratio, self.denom))
        factor = (y0 + ar * yn) / den
        return y - _coef_shape(self.usol, d, axis) * factor


def tdma_periodic(a, b, c, d: Tensor, axis: int = -1,
                  method: str = "seq") -> Tensor:
    """Solve the periodic tridiagonal system (a[0] couples row 0 to row
    n-1, c[n-1] row n-1 to row 0) along `axis`: Sherman–Morrison with
    gamma = -b[0], two Thomas solves sharing one factorization."""
    return TridiagFactor(a, b, c, periodic=True, method=method).solve(d, axis=axis)
