"""Distributed stencil operators in correction form (port of
:mod:`poissbox_tpu.parallel.dist_stencil`).

Every operation runs the ported single-device kernel on this rank's block
with a LOCAL periodic wrap, while the face exchange brings the true
neighbour planes; each split face is then patched with the linear
correction ``coeff * (halo - wrapped)``. The 7-point star, and every
smoother built from it, is linear in its input, so the patch is exact;
and the kernel does not depend on the exchange, so the messages travel
while it runs (the exchange is posted before the launch and waited for
after it). The patches are plain torch slicing on the face planes.

  ============================  ====================  =====
  operation                     kernel on the block   TPU
  ============================  ====================  =====
  apply_laplacian_sharded       apply_laplacian_cuda  K1
  apply_laplacian_dot_sharded   apply_laplacian_dot_  K2
                                cuda
  cg_fused_update_sharded       cg_fused_update_cuda  K8
  residual_sharded              residual_cuda         K9
  jacobi_sweep_sharded          jacobi_sweep_cuda     K10
  sor_sweep_sharded             sor_sweep_cuda        K11
  ============================  ====================  =====

A CPU tensor takes each kernel's plain version, as on one device
(``local_impl="cuda"``), or the roll formulation (``"roll"``, the default
on the CPU, as the JAX package's ``pick_local_impl`` picks it off the TPU).

Red-black parity is global: K11 colours a cell by its LOCAL (i + j + k),
so a rank whose box starts at an odd i0 + j0 + k0 passes the colour XOR
that offset parity (and the face masks do the same). Unlike the JAX
package's ``sor_sweep_sharded``, which needs even offsets
(``sor_parity_local_ok``), this holds on any decomposition, the uneven
ones included.

Every operation takes `faces`, the exchange's result, for tests that cut
the halos from a global field without a process group
(``halo.faces_from_global``); by default it exchanges them.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from poissbox_tpu_torch.ops.stencil import apply_laplacian, laplacian_local
from poissbox_tpu_torch.ops.stencil_cuda import (
    apply_laplacian_cuda,
    apply_laplacian_dot_cuda,
    cg_fused_update_cuda,
    colour_mask,
    jacobi_sweep_cuda,
    residual_cuda,
    sor_sweep_cuda,
)
from poissbox_tpu_torch.parallel import halo
from poissbox_tpu_torch.parallel.halo import allreduce_sum, sharded_dims

Tensor = torch.Tensor


def local_shape(grid) -> tuple[int, int, int]:
    """This rank's block shape under the grid's decomposition."""
    return grid.local_shape


def pick_local_impl(grid, impl: str = "auto") -> str:
    """The kernel choice for the block: "cuda" (the hand-written kernels,
    their plain versions for CPU tensors) on a CUDA device, "roll" on the
    CPU; an explicit "cuda" or "roll" passes through."""
    if impl == "pallas":
        impl = "cuda"
    if impl == "auto":
        return "cuda" if grid.device.type == "cuda" else "roll"
    if impl not in ("cuda", "roll"):
        raise ValueError(f"unknown local impl {impl!r} (expected auto|cuda|roll)")
    return impl


def sor_parity_local_ok(grid) -> bool:
    """True iff red-black parity is locally computable in the JAX
    package's sense: every split dim has an even local extent (so every
    offset is even). The port's SOR does not need it; the multigrid
    hierarchy keeps a level distributed by the same rule, so that the
    level stacks of the two packages match."""
    if grid.mesh is None:
        return True
    return all((n // p) % 2 == 0 for n, p in zip(grid.n, grid.pgrid) if p > 1)


def offset_parity(grid) -> int:
    """(i0 + j0 + k0) & 1 of this rank's box."""
    return sum(grid.offset) & 1


# ---------------------------------------------------------------------------
# correction-form machinery
# ---------------------------------------------------------------------------

def _exchange(block: Tensor, grid, faces: Optional[dict]):
    """Post the face exchange (or take the given faces); returns the wait."""
    if faces is not None:
        return lambda: faces
    return halo.start_face_exchange(block, grid.mesh).wait


def _diffs(block: Tensor, faces: dict) -> dict:
    """Per split dim d: (left halo - wrapped last plane, right halo -
    wrapped first plane), the planes the local wrap read in their stead."""
    out = {}
    for d, (left, right) in faces.items():
        n = block.shape[d]
        out[d] = (left - block.narrow(d, n - 1, 1), right - block.narrow(d, 0, 1))
    return out


def _apply_corrections(out: Tensor, diffs: dict, invs, scale: float = 1.0,
                       masks: Optional[dict] = None) -> Tensor:
    """out += scale * inv_d^2 * (halo - wrapped) on each split face, in
    place on `out`; `masks[d]` gates the correction (red-black faces)."""
    for d, (dlo, dhi) in diffs.items():
        n = out.shape[d]
        c_lo = (scale * invs[d]) * dlo
        c_hi = (scale * invs[d]) * dhi
        if masks is not None:
            m_lo, m_hi = masks[d]
            c_lo = c_lo * m_lo
            c_hi = c_hi * m_hi
        out.narrow(d, 0, 1).add_(c_lo)
        out.narrow(d, n - 1, 1).add_(c_hi)
    return out


def _invs(grid) -> list[float]:
    return [1.0 / float(d) ** 2 for d in grid.deltas]


def _winv(grid, weight: float) -> float:
    return float(weight) / (-2.0 * sum(_invs(grid)))


def _sharded(grid) -> bool:
    return bool(sharded_dims(grid.mesh))


@functools.lru_cache(maxsize=64)
def _face_color_masks(shape: tuple, dims: tuple, color_local: int, dtype,
                      device) -> dict:
    """Red-black masks of the split face planes, from local indices: 1
    where the LOCAL parity is `color_local` (the global colour XOR the
    box's offset parity). Each face's mask comes from its own indices: the
    low face's parity along d is that of its two in-plane indices, the high
    face's that XOR (n - 1) & 1. Cached by level shape (the callers only
    read them), so a V-cycle builds each once."""
    masks = {}
    for d in dims:
        face = list(shape)
        face[d] = 1
        hi_colour = color_local ^ ((shape[d] - 1) & 1)
        masks[d] = (colour_mask(face, color_local, device).to(dtype),
                    colour_mask(face, hi_colour, device).to(dtype))
    return masks


# ---------------------------------------------------------------------------
# operator application
# ---------------------------------------------------------------------------

def _local_lapl(u: Tensor, grid, impl: str) -> Tensor:
    if impl == "cuda":
        return apply_laplacian_cuda(u, grid.deltas)
    return apply_laplacian(u, grid.deltas)


def apply_laplacian_sharded(u: Tensor, grid, overlap: bool = True,
                            local_impl: str = "auto",
                            faces: Optional[dict] = None) -> Tensor:
    """The periodic 7-point Laplacian of this rank's block.

    overlap=True (default) is the correction form: K1 on the block while
    the faces travel. overlap=False pads the block with
    :func:`halo.halo_pad_local` and applies the star to the padded block
    (the literal DMGlobalToLocal form, an independent cross-check)."""
    impl = pick_local_impl(grid, local_impl)
    if not _sharded(grid):
        return _local_lapl(u, grid, impl)
    if not overlap:
        return laplacian_local(halo.halo_pad_local(u, grid.mesh, 1), grid.deltas)
    wait = _exchange(u, grid, faces)              # messages first
    out = _local_lapl(u, grid, impl)              # the kernel meanwhile
    return _apply_corrections(out, _diffs(u, wait()), _invs(grid))


def apply_laplacian_dot_sharded(u: Tensor, grid, local_impl: str = "auto",
                                reduce: bool = True,
                                faces: Optional[dict] = None):
    """(A u, <u, A u>) in one pass: K2 on the block, its dot corrected by
    the faces' terms. `reduce=False` returns this rank's partial dot (CG
    reduces it with its other partials in one all-reduce)."""
    impl = pick_local_impl(grid, local_impl)
    wait = _exchange(u, grid, faces) if _sharded(grid) else (lambda: {})
    if impl == "cuda":
        out, dot = apply_laplacian_dot_cuda(u, grid.deltas)
    else:
        out = apply_laplacian(u, grid.deltas)
        dot = torch.sum(u * out)
    diffs = _diffs(u, wait())
    invs = _invs(grid)
    # <u, A_true u> = <u, A_loc u> + sum over faces of u * correction
    for d, (dlo, dhi) in diffs.items():
        n = u.shape[d]
        dot = dot + invs[d] * (torch.sum(u.narrow(d, 0, 1) * dlo)
                               + torch.sum(u.narrow(d, n - 1, 1) * dhi))
    out = _apply_corrections(out, diffs, invs)
    return out, (allreduce_sum(dot, grid.mesh) if reduce else dot)


def cg_fused_update_sharded(alpha, x: Tensor, p: Tensor, r: Tensor, ap: Tensor,
                            grid, local_impl: str = "auto", reduce: bool = True):
    """CG's fused update on the blocks: K8 gives (x + alpha p, r - alpha Ap)
    and this rank's ||r'||^2 and sum(r') partials, all-reduced together
    (`reduce=False` returns the partials)."""
    impl = pick_local_impl(grid, local_impl)
    if impl == "cuda":
        xo, ro, rr, sr = cg_fused_update_cuda(alpha, x, p, r, ap)
    else:
        a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        xo = x + a * p
        ro = r - a * ap
        rr, sr = torch.sum(ro * ro), torch.sum(ro)
    if reduce and grid.distributed:
        rr, sr = allreduce_sum(torch.stack([rr, sr]), grid.mesh).unbind()
    return xo, ro, rr, sr


def residual_sharded(x: Tensor, b: Tensor, grid, local_impl: str = "auto",
                     faces: Optional[dict] = None) -> Tensor:
    """r = b - A x: K9 on the block, then r_true = r_loc - correction."""
    impl = pick_local_impl(grid, local_impl)
    wait = _exchange(x, grid, faces) if _sharded(grid) else (lambda: {})
    if impl == "cuda":
        r = residual_cuda(x, b, grid.deltas)
    else:
        r = b - apply_laplacian(x, grid.deltas)
    return _apply_corrections(r, _diffs(x, wait()), _invs(grid), scale=-1.0)


# ---------------------------------------------------------------------------
# smoother sweeps
# ---------------------------------------------------------------------------

def jacobi_sweep_sharded(x: Tensor, b: Tensor, grid, weight: float,
                         local_impl: str = "auto",
                         faces: Optional[dict] = None) -> Tensor:
    """Damped Jacobi x + (w/diag)(b - A x): K10 on the block, then
    x'_true = x'_loc - winv * correction."""
    impl = pick_local_impl(grid, local_impl)
    winv = _winv(grid, weight)
    wait = _exchange(x, grid, faces) if _sharded(grid) else (lambda: {})
    if impl == "cuda":
        out = jacobi_sweep_cuda(x, b, grid.deltas, weight)
    else:
        out = x + winv * (b - apply_laplacian(x, grid.deltas))
    return _apply_corrections(out, _diffs(x, wait()), _invs(grid), scale=-winv)


def sor_sweep_sharded(x: Tensor, b: Tensor, grid, weight: float, color: int,
                      local_impl: str = "auto",
                      faces: Optional[dict] = None) -> Tensor:
    """One red-black colour update (colour 0 = red, GLOBAL (i+j+k) even)
    of the block: K11 with the colour XOR the box's offset parity, then
    x'_true = x'_loc - winv * mask * correction on the split faces."""
    impl = pick_local_impl(grid, local_impl)
    winv = _winv(grid, weight)
    local_color = int(color) ^ (offset_parity(grid) if grid.mesh is not None else 0)
    wait = _exchange(x, grid, faces) if _sharded(grid) else (lambda: {})
    if impl == "cuda":
        out = sor_sweep_cuda(x, b, grid.deltas, weight, local_color)
    else:
        mask = colour_mask(x.shape, local_color, x.device).to(x.dtype)
        out = x + (winv * mask) * (b - apply_laplacian(x, grid.deltas))
    diffs = _diffs(x, wait())
    masks = _face_color_masks(tuple(x.shape), tuple(diffs), local_color, x.dtype,
                              x.device)
    return _apply_corrections(out, diffs, _invs(grid), scale=-winv, masks=masks)
