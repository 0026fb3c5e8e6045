"""Hopper kernel of the one-rank spectral solves' symbol multiply.

``symbol_scale`` scales the ``rfftn`` half spectrum of a field, in place,
by the pseudo-inverse of the operator's symbol (``csrc/spectral.cu``). It
replaces no TPU kernel: the JAX package builds the symbol with jnp over
the whole spectrum and multiplies by it. Here each mode's symbol S is
formed from per-axis 1-D tables (built and cached by
:func:`poissbox_tpu_torch.solvers.fft.symbol_tables`), in one of two forms:

  * ``"compact"`` (the 6th-order compact Laplacian), table rows DG and II:
    S = (DGx IIy) IIz + (IIx DGy) IIz + (IIx IIy) DGz;
  * ``"sum"`` (the 7-point Laplacian), one row L: S = (Lx + Ly) + Lz;

then inv = 1/S where |S| > rel * peak and 0 elsewhere (the minimal-norm
pseudo-inverse; ``rel`` is 0 in the 7-point form, so only S = 0 drops),
and both halves of each complex value are multiplied by inv.

A table row holds the x, y and z tables back to back (nx + ny + nz
values); ``peak`` is a 0-d tensor on the field's device, so the host never
waits for it. The half spectrum may lie in memory in any axis order, as
long as it is dense: cuFFT's ``rfftn`` leaves the half axis outermost.
The plain version below is the kernel's arithmetic and grouping. A CPU
tensor takes it; a CUDA tensor launches the kernel or raises. Launches
count in :data:`poissbox_tpu_torch.ops._build.LAUNCHES` (``spectral.compact``,
``spectral.sum``).
"""

from __future__ import annotations

import torch

from poissbox_tpu_torch.ops import _build

Tensor = torch.Tensor

FORMS = {"compact": 0, "sum": 1}   # csrc/spectral.cu SymbolForm
ROWS = {"compact": 2, "sum": 1}
# the half spectra the kernel takes, and the real dtype of their tables
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def axis_tables(row: Tensor, shape) -> tuple[Tensor, Tensor, Tensor]:
    """The x, y and z tables of one table row."""
    nx, ny, _ = shape
    return row[:nx], row[nx:nx + ny], row[nx + ny:]


def symbol_plain(tables: Tensor, shape, form: str) -> Tensor:
    """S on the half spectrum, (nx, ny, nz//2 + 1), in the tables' dtype."""
    nh = shape[2] // 2 + 1
    if form == "sum":
        lx, ly, lz = axis_tables(tables[0], shape)
        return (lx[:, None] + ly[None, :])[..., None] + lz[:nh]
    dgx, dgy, dgz = axis_tables(tables[0], shape)
    iix, iiy, iiz = axis_tables(tables[1], shape)
    a = (dgx[:, None] * iiy[None, :])[..., None]
    b = (iix[:, None] * dgy[None, :])[..., None]
    c = (iix[:, None] * iiy[None, :])[..., None]
    iiz, dgz = iiz[:nh], dgz[:nh]
    return a * iiz + b * iiz + c * dgz


def pinv_plain(S: Tensor, peak: Tensor, rel: float) -> Tensor:
    """1/S where |S| > rel * peak, else 0."""
    keep = torch.abs(S) > rel * peak
    return torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                       torch.zeros_like(S))


def symbol_scale_plain(xhat: Tensor, tables: Tensor, peak: Tensor, rel: float,
                       form: str) -> Tensor:
    """The kernel's plain version: `xhat` scaled in place; returns it."""
    shape = (xhat.shape[0], xhat.shape[1], tables.shape[1] - xhat.shape[0] - xhat.shape[1])
    inv = pinv_plain(symbol_plain(tables, shape, form), peak, rel)
    torch.view_as_real(xhat).mul_(inv[..., None])
    return xhat


def memory_order(t: Tensor) -> tuple[int, ...]:
    """The axes of a dense tensor, outermost in memory first; raises
    unless its elements fill its storage span without gaps or overlap."""
    order = tuple(sorted(range(t.dim()), key=lambda a: -t.stride(a)))
    expect = 1
    for a in reversed(order):
        if t.shape[a] > 1 and t.stride(a) != expect:
            raise ValueError(f"the kernel takes a dense half spectrum, not strides "
                             f"{t.stride()} of shape {tuple(t.shape)}")
        expect *= t.shape[a]
    return order


def _check(xhat: Tensor, tables: Tensor, peak: Tensor, form: str) -> tuple[int, ...]:
    """(nx, ny, nz) of the field `xhat` is the half spectrum of, and its
    axes in memory order; raises on anything the kernel does not take."""
    if form not in FORMS:
        raise ValueError(f"symbol form {form!r}, not one of {sorted(FORMS)}")
    if xhat.dtype not in _REAL:
        raise TypeError(f"expected a complex64 or complex128 half spectrum, got {xhat.dtype}")
    real = _REAL[xhat.dtype]
    for t in (xhat, tables, peak):
        if t.device != xhat.device:
            raise ValueError(f"tensors on {xhat.device} and {t.device}")
    if xhat.dim() != 3 or xhat.data_ptr() % 16:
        raise ValueError("the kernel takes a 16-byte aligned 3-D half spectrum")
    order = memory_order(xhat)
    nx, ny, nh = xhat.shape
    nz = tables.shape[-1] - nx - ny if tables.dim() == 2 else -1
    if (tables.dtype != real or peak.dtype != real or peak.dim() != 0
            or tables.shape[0] != ROWS[form] or not tables.is_contiguous()
            or nz < 1 or nz // 2 + 1 != nh):
        raise ValueError(f"tables {tables.dtype} {tuple(tables.shape)} and peak "
                         f"{peak.dtype} {tuple(peak.shape)} do not fit a {form} symbol "
                         f"of the {real} half spectrum {tuple(xhat.shape)}")
    return (nx, ny, nz) + order


def symbol_scale(xhat: Tensor, tables: Tensor, peak: Tensor, rel: float,
                 form: str) -> Tensor:
    """`xhat`, the rfftn half spectrum (nx, ny, nz//2 + 1) in any dense
    layout, times the pseudo-inverse of the `form` symbol of `tables`, in
    place; returns it."""
    if xhat.device.type == "cpu":
        return symbol_scale_plain(xhat, tables, peak, rel, form)
    dims = _check(xhat, tables, peak, form)
    ptr = _build.ptr
    _build.launch("poissbox_symbol_scale", f"spectral.{form}",
                  _build.DTYPE_CODE[_REAL[xhat.dtype]], FORMS[form], xhat.device.index or 0,
                  _build.stream(xhat), ptr(xhat), ptr(tables), ptr(peak), float(rel), *dims)
    return xhat
