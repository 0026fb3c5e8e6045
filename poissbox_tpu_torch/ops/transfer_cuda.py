"""Hopper kernels of the multigrid transfer legs, each leg whole in one
launch.

The port of the two transfer kernels of :mod:`poissbox_tpu.ops.stencil_pallas`
together with the y/z transfers that follow and precede them in the JAX
package (``restrict_mm`` / ``prolong_mm`` over axes (1, 2)); ``csrc/xfer.cu``,
two modes:

  ======================  ======================================  ===
  wrapper                 JAX counterpart                         TPU
  ======================  ======================================  ===
  residual_restrict_cuda  restrict_mm(residual_xrestrict_pallas,  K6
                          axes=(1, 2))
  prolong_add_cuda        xprolong_add_pallas(u, prolong_mm(e,    K7
                          axes=(1, 2)))
  ======================  ======================================  ===

With ``transfers="matmul"`` every kernel level of the V-cycle goes down
through K6, from (u, b) straight to the coarse residual, and up through K7,
from the coarse correction straight to u + P e
(:mod:`poissbox_tpu_torch.solvers.mg`): neither the full-size residual, nor
the prolonged correction, nor a half-size intermediate is stored. The
iterate u may be bf16 (the 512^3-class bf16 pre-smooth): both legs upcast
it before any arithmetic and return b's (e's) dtype.

The plain versions compose the roll formulation one axis at a time: K6's
star is ``_star_ext``'s, then full weighting along x, y and z; K7 prolongs
along y, z and then x and adds u. The kernels round every sum as they do.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Launches count in :data:`poissbox_tpu_torch.ops._build.LAUNCHES`
(``xfer.restrict``, ``xfer.prolong_add``, with ``.bf16u`` for a bf16
iterate).
"""

from __future__ import annotations

import torch

from poissbox_tpu_torch.ops import _build
from poissbox_tpu_torch.ops.stencil_cuda import check_dtype, inv_squares, star_ext

_XMODE = {"xfer.restrict": 0, "xfer.prolong_add": 1}
# the dtypes of the iterate u each mode takes (b, e and the output are
# float32 or float64)
DTYPES = dict.fromkeys(_XMODE, (torch.float32, torch.float64, torch.bfloat16))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def restrict_axis(f: torch.Tensor, ax: int) -> torch.Tensor:
    """Full weighting along one axis, periodic:
    c_I = (3 f_{2I} + 3 f_{2I+1} + f_{2I+2} + f_{2I-1}) / 8."""
    n = f.shape[ax]
    pairs = f.reshape(f.shape[:ax] + (n // 2, 2) + f.shape[ax + 1:])
    even = pairs.select(ax + 1, 0)           # f_{2I}
    odd = pairs.select(ax + 1, 1)            # f_{2I+1}
    up = torch.roll(even, -1, ax)            # f_{2I+2}
    dn = torch.roll(odd, 1, ax)              # f_{2I-1}
    return (3.0 * (even + odd) + up + dn) * 0.125


def prolong_axis(c: torch.Tensor, ax: int) -> torch.Tensor:
    """Linear prolongation along one axis: the fine cell 2I + s takes 3/4
    of c_I and 1/4 of its periodic neighbour on side s."""
    even = 0.75 * c + 0.25 * torch.roll(c, 1, ax)    # fine i = 2I
    odd = 0.75 * c + 0.25 * torch.roll(c, -1, ax)    # fine i = 2I + 1
    c = torch.stack([even, odd], dim=ax + 1)
    return c.reshape(c.shape[:ax] + (c.shape[ax] * 2,) + c.shape[ax + 2:])


def residual_xrestrict_plain(u, b, deltas):
    """(b - A u) restricted along x to (nx/2, ny, nz); u upcast to b's
    dtype first (the Pallas K6, residual_xrestrict_pallas)."""
    return restrict_axis(b - star_ext(u.to(b.dtype), inv_squares(deltas)), 0)


def xprolong_add_plain(u, e_yz):
    """u + P_x(e_yz), in e_yz's dtype; e_yz is (nx/2, ny, nz) (the Pallas
    K7, xprolong_add_pallas)."""
    return u.to(e_yz.dtype) + prolong_axis(e_yz, 0)


def residual_restrict_plain(u, b, deltas):
    """K6: (b - A u) restricted along x, then y, then z, to
    (nx/2, ny/2, nz/2) in b's dtype."""
    return restrict_axis(restrict_axis(residual_xrestrict_plain(u, b, deltas), 1), 2)


def prolong_add_plain(u, e):
    """K7: u + P e, e at (nx/2, ny/2, nz/2) prolonged along y, then z,
    then x; in e's dtype."""
    return xprolong_add_plain(u, prolong_axis(prolong_axis(e, 1), 2))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(mode: str, u: torch.Tensor, be: torch.Tensor) -> None:
    """u: the fine iterate, (nx, ny, nz) with every extent even; be: b
    (fine shape) or e (nx/2, ny/2, nz/2), float32 or float64; all
    contiguous on one CUDA device."""
    for t in (u, be):
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous fields")
    if u.device != be.device:
        raise ValueError(f"tensors on {u.device} and {be.device}")
    if u.dim() != 3 or any(n % 2 for n in u.shape):
        raise ValueError(f"{mode}: u must be 3-D with even extents, got "
                         f"{tuple(u.shape)}")
    want = tuple(u.shape) if mode == "xfer.restrict" else tuple(n // 2 for n in u.shape)
    if tuple(be.shape) != want:
        raise ValueError(f"{mode}: u {tuple(u.shape)} needs a field of "
                         f"shape {want}, got {tuple(be.shape)}")
    check_dtype(mode, u.dtype, DTYPES)
    if be.dtype not in (torch.float32, torch.float64) or (
            u.dtype != be.dtype and u.dtype != torch.bfloat16):
        raise TypeError(f"{mode}: u {u.dtype} with {be.dtype}; the second "
                        "field is float32 or float64, and u is of its dtype "
                        "or bfloat16")


def _xfer(mode: str, u, be, out, deltas=(1.0, 1.0, 1.0)) -> None:
    """One launch; the spacing is read by the restriction only."""
    ivx, ivy, ivz = inv_squares(deltas)
    key = mode + (".bf16u" if u.dtype != be.dtype else "")
    code, ptr = _build.DTYPE_CODE, _build.ptr
    _build.launch(
        "poissbox_xfer", key, code[u.dtype], code[be.dtype], _XMODE[mode],
        int(ivx == ivy == ivz), u.device.index or 0, _build.stream(u), ptr(u), ptr(be),
        ptr(out), *u.shape, ivx, ivy, ivz, 2.0 * (ivx + ivy + ivz), 6.0 * ivx)


def residual_restrict_cuda(u: torch.Tensor, b: torch.Tensor,
                           deltas) -> torch.Tensor:
    """(b - A u) restricted along x, y and z, (nx/2, ny/2, nz/2) in b's
    dtype (K6)."""
    if u.device.type == "cpu":
        return residual_restrict_plain(u, b, deltas)
    _check("xfer.restrict", u, b)
    out = torch.empty(tuple(n // 2 for n in u.shape), dtype=b.dtype, device=b.device)
    _xfer("xfer.restrict", u, b, out, deltas)
    return out


def prolong_add_cuda(u: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """u + P e at u's shape, in e's dtype (K7), e at (nx/2, ny/2, nz/2).
    The output is a new tensor: u is not written."""
    if u.device.type == "cpu":
        return prolong_add_plain(u, e)
    _check("xfer.prolong_add", u, e)
    out = torch.empty(u.shape, dtype=e.dtype, device=e.device)
    _xfer("xfer.prolong_add", u, e, out)
    return out
