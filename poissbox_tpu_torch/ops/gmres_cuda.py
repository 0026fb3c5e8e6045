"""Hopper kernels of GMRES's classical Gram-Schmidt step, over the basis
rows built so far (``csrc/gmres.cu``).

A Krylov basis is one stacked tensor ``V`` of shape (k, *field); step j
of a cycle has built rows 0..j and orthogonalises the new vector w
against them:

  * :func:`gs_dots` — h_i = <V_i, w> for i < ``rows``;
  * :func:`gs_update_norm` — out = w - sum_{i < rows} h_i V_i, row by row
    in order, and ||out||^2.

Neither reads a row at or past ``rows``, so the basis need not be
zero-filled. The same update forms a cycle's solution, x - sum (-y_i) Z_i.
They replace no TPU kernel: the JAX package's GMRES orthogonalises with two
``jnp.tensordot`` products over the whole zero-padded basis.

The plain versions below are the kernels' arithmetic and grouping (a dot
a row; the update row by row in order), with a rounded multiply and add
where the kernel fuses them (fma), and sums in torch's order where the
kernel sums by thread, block and ``torch.sum`` over blocks. A CPU tensor
takes them; a CUDA tensor launches the kernel or raises. Both return
sums local to the tensors given (over a process grid the caller
all-reduces them). ``h`` and the partials stay on the device, so the
host never waits. Launches count in
:data:`poissbox_tpu_torch.ops._build.LAUNCHES` (``gmres.dots``,
``gmres.update``).
"""

from __future__ import annotations

import torch

from poissbox_tpu_torch.ops import _build
from poissbox_tpu_torch.ops.stencil_cuda import check_dtype

Tensor = torch.Tensor

_KIND = {"gmres.dots": 0, "gmres.update": 1}   # csrc/gmres.cu GsKind
DTYPES = dict.fromkeys(_KIND, (torch.float32, torch.float64))


def gs_dots_plain(V: Tensor, rows: int, w: Tensor) -> Tensor:
    """(rows,) tensor of <V_i, w>, i < rows."""
    Vf, wf = V.reshape(V.shape[0], -1), w.reshape(-1)
    return torch.stack([torch.dot(Vf[i], wf) for i in range(rows)])


def gs_update_norm_plain(V: Tensor, rows: int, h: Tensor, w: Tensor,
                         out: Tensor) -> Tensor:
    """out = w - sum_{i < rows} h_i V_i, subtracted in order of i; returns
    ||out||^2 as a 0-d tensor."""
    acc = w
    for i in range(rows):
        acc = acc - h[i] * V[i]
    out.copy_(acc)
    return torch.sum(out * out)


def _check(mode: str, V: Tensor, rows: int, w: Tensor, *more: Tensor) -> None:
    """Raise on anything the kernel does not take."""
    check_dtype(mode, V.dtype, DTYPES)
    for t in (V, w, *more):
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if t.device != V.device or t.dtype != V.dtype:
            raise ValueError(f"tensors {V.dtype} on {V.device} and {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the GMRES kernels take contiguous tensors")
    if V.dim() < 2 or tuple(V.shape[1:]) != tuple(w.shape):
        raise ValueError(f"a basis {tuple(V.shape)} does not stack fields {tuple(w.shape)}")
    if not 1 <= rows <= V.shape[0]:
        raise ValueError(f"rows {rows} of a basis of {V.shape[0]}")


def _pack(*fields: Tensor) -> int:
    """Values a load: 16 bytes where every field allows it, else one."""
    vec = 16 // fields[0].element_size()
    if fields[0].numel() % vec or any(t.data_ptr() % 16 for t in fields):
        return 1
    return vec


def _blocks(mode: str, V: Tensor, vec: int, rows: int) -> int:
    nblk = _build.load().poissbox_gmres_blocks(_KIND[mode], _build.DTYPE_CODE[V.dtype], vec,
                                               rows, V[0].numel(), V.device.index or 0)
    if nblk < 1:
        _build.raise_on(-nblk, mode)
    return nblk


def gs_dots(V: Tensor, rows: int, w: Tensor) -> Tensor:
    """(rows,) tensor of <V_i, w> for the first `rows` rows of the stacked
    basis `V` (k, *w.shape); one pass over w for every 8 rows."""
    if V.device.type == "cpu":
        return gs_dots_plain(V, rows, w)
    _check("gmres.dots", V, rows, w)
    vec = _pack(w, V)
    nblk = _blocks("gmres.dots", V, vec, rows)
    part = torch.empty((nblk, rows), dtype=V.dtype, device=V.device)
    ptr = _build.ptr
    _build.launch("poissbox_gmres_dots", "gmres.dots", _build.DTYPE_CODE[V.dtype], vec,
                  V.device.index or 0, _build.stream(V), ptr(V), ptr(w), ptr(part), rows,
                  w.numel(), nblk)
    return torch.sum(part, 0)


def gs_update_norm(V: Tensor, rows: int, h: Tensor, w: Tensor, out: Tensor) -> Tensor:
    """out = w - sum_{i < rows} h_i V_i in one pass (h a (rows,) tensor on
    V's device; `out` a field apart from the rows read, e.g. the next row
    of V); returns ||out||^2 as a 0-d tensor."""
    if V.device.type == "cpu":
        return gs_update_norm_plain(V, rows, h, w, out)
    _check("gmres.update", V, rows, w, h, out)
    if h.shape != (rows,) or out.shape != w.shape:
        raise ValueError(f"h {tuple(h.shape)} and out {tuple(out.shape)} for {rows} rows "
                         f"of fields {tuple(w.shape)}")
    read = (V.data_ptr(), V.data_ptr() + rows * w.numel() * V.element_size())
    if out.data_ptr() < read[1] and read[0] < out.data_ptr() + out.nbytes:
        raise ValueError("out overlaps the basis rows the update reads")
    vec = _pack(w, V, out)
    nblk = _blocks("gmres.update", V, vec, rows)
    part = torch.empty(nblk, dtype=V.dtype, device=V.device)
    ptr = _build.ptr
    _build.launch("poissbox_gmres_update", "gmres.update", _build.DTYPE_CODE[V.dtype], vec,
                  V.device.index or 0, _build.stream(V), ptr(V), ptr(h), ptr(w), ptr(out),
                  ptr(part), rows, w.numel(), nblk)
    return torch.sum(part)
