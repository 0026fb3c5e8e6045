"""Hopper kernels of the multigrid transfer legs fused along x.

The port of the two transfer kernels of :mod:`poissbox_tpu.ops.stencil_pallas`
(``csrc/xfer.cu``, two modes):

  =========================  ===========================  ===
  wrapper                    Pallas counterpart           TPU
  =========================  ===========================  ===
  residual_xrestrict_cuda    residual_xrestrict_pallas    K6
  xprolong_add_cuda          xprolong_add_pallas          K7
  =========================  ===========================  ===

With ``transfers="matmul"`` every kernel level of the V-cycle goes down
through K6 and the y/z restriction ``restrict_mm(axes=(1, 2))``, and up
through ``prolong_mm(axes=(1, 2))`` and K7 (:mod:`poissbox_tpu_torch.solvers.mg`),
so the full-size residual and the full-size prolonged correction are never
stored. The iterate u may be bf16 (the 512^3-class bf16 pre-smooth): both
legs upcast it before any arithmetic and return b's (e's) dtype.

The plain versions follow the Pallas grouping: K6's star is
``_star_ext``'s, and the x-transfers are the roll formulation's along
axis 0. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Launches count in
:data:`poissbox_tpu_torch.ops._build.LAUNCHES` (``xfer.restrict``,
``xfer.prolong_add``, with ``.bf16u`` for a bf16 iterate).
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
    dtype first."""
    return restrict_axis(b - star_ext(u.to(b.dtype), inv_squares(deltas)), 0)


def xprolong_add_plain(u, e_yz):
    """u + P_x(e_yz), in e_yz's dtype; e_yz is (nx/2, ny, nz)."""
    return u.to(e_yz.dtype) + prolong_axis(e_yz, 0)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(mode: str, u: torch.Tensor, be: torch.Tensor) -> None:
    """u: the fine iterate, (nx, ny, nz) with nx even; be: b (fine shape)
    or e (nx/2, ny, nz), float32 or float64; all contiguous on one CUDA
    device."""
    for t in (u, be):
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous fields")
    if u.device != be.device:
        raise ValueError(f"tensors on {u.device} and {be.device}")
    if u.dim() != 3 or u.shape[0] % 2:
        raise ValueError(f"{mode}: u must be 3-D with an even nx, got "
                         f"{tuple(u.shape)}")
    nx, ny, nz = u.shape
    want = (nx, ny, nz) if mode == "xfer.restrict" else (nx // 2, ny, nz)
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


def residual_xrestrict_cuda(u: torch.Tensor, b: torch.Tensor,
                            deltas) -> torch.Tensor:
    """(b - A u) restricted along x, (nx/2, ny, nz) in b's dtype (K6)."""
    if u.device.type == "cpu":
        return residual_xrestrict_plain(u, b, deltas)
    _check("xfer.restrict", u, b)
    nx, ny, nz = u.shape
    out = torch.empty((nx // 2, ny, nz), dtype=b.dtype, device=b.device)
    _xfer("xfer.restrict", u, b, out, deltas)
    return out


def xprolong_add_cuda(u: torch.Tensor, e_yz: torch.Tensor) -> torch.Tensor:
    """u + P_x(e_yz) at u's shape, in e_yz's dtype (K7). The output is a
    new tensor: u is not written."""
    if u.device.type == "cpu":
        return xprolong_add_plain(u, e_yz)
    _check("xfer.prolong_add", u, e_yz)
    out = torch.empty(u.shape, dtype=e_yz.dtype, device=e_yz.device)
    _xfer("xfer.prolong_add", u, e_yz, out)
    return out
