"""Hopper kernels of the 7-point stencil and the red-black SOR smoother.

The port of :mod:`poissbox_tpu.ops.stencil_pallas` for the kernels on the
solver of record's path. Two CUDA kernels (``csrc/stencil7.cu``,
``csrc/rbsor.cu``) cover six TPU kernels:

  ==========================  ======================================  ===
  wrapper                     Pallas counterpart                      TPU
  ==========================  ======================================  ===
  apply_laplacian_cuda        apply_laplacian_pallas                  K1
  apply_laplacian_dot_cuda    apply_laplacian_dot_pallas              K2
  residual_cuda               residual_pallas                         K9
  sor_rb_zero_sweep_cuda      sor_rb_zero_sweep_pallas                K3
  sor_rb_zero_update_cuda     sor_rb_zero_update_pallas               K5
  sor_rb_sweep_cuda           sor_rb_sweep_pallas (with ``dots``)     K4
  sor_rb_multisweep_cuda      sor_rb_multisweep_pallas                K4
  ==========================  ======================================  ===

Each wrapper has a plain PyTorch version here, ``*_plain``, which follows
the Pallas formula and its grouping (not the roll path's). A tensor on the
CPU takes the plain version; a CUDA tensor launches the kernel or raises.
There is no fallback from a failed build or launch to the plain version.

:data:`LAUNCHES` counts kernel launches by kernel and mode (``stencil7.*``
for the star's epilogues, ``rbsor.*`` for the colour update's modes); a
wrapper adds one where it launches, so a run can show which kernels its
path went through. Reductions come back as per-block partials that the
wrapper sums with ``torch.sum``, as the JAX wrappers sum theirs.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from poissbox_tpu_torch.ops import _build

LAUNCHES: dict[str, int] = {
    "stencil7.apply": 0,
    "stencil7.apply_dot": 0,
    "stencil7.residual": 0,
    "rbsor.zero": 0,
    "rbsor.general": 0,
    "rbsor.zero_update": 0,
    "rbsor.dots": 0,
}

_EPI = {"stencil7.apply": 0, "stencil7.apply_dot": 1, "stencil7.residual": 2}
_MODE = {"rbsor.zero": 0, "rbsor.general": 1, "rbsor.zero_update": 2,
         "rbsor.dots": 3}
_DTYPE = {torch.float32: 0, torch.float64: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (Pallas grouping)
# ---------------------------------------------------------------------------

def _invs(deltas: Sequence[float]) -> tuple[float, float, float]:
    return tuple(1.0 / float(d) ** 2 for d in deltas)


def _winv(invs, weight: float) -> float:
    """w / diag, diag = -2 sum(1/d^2) (negative), as the Pallas launchers
    compute it."""
    return float(weight) / (-2.0 * sum(invs))


def _pm1(c: torch.Tensor, axis: int) -> torch.Tensor:
    """c[i-1] + c[i+1] along `axis`, periodic (Pallas `_pm1_sum`)."""
    return torch.roll(c, 1, axis) + torch.roll(c, -1, axis)


def _star(u: torch.Tensor, invs) -> torch.Tensor:
    """The 7-point star in `_star_into`'s grouping (also `_star_ext`'s for
    non-cubic cells)."""
    ivx, ivy, ivz = invs
    acc = _pm1(u, 0) * ivx
    acc = acc + _pm1(u, 1) * ivy
    acc = acc + _pm1(u, 2) * ivz
    return acc - (2.0 * (ivx + ivy + ivz)) * u


def _halfstep(x: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
              invs) -> torch.Tensor:
    """One masked SOR half-step, `_rb_halfstep`: c + w*(b - star(x)) with
    the weight field w = winv on the updated colour, 0 elsewhere."""
    ivx, ivy, ivz = invs
    if ivx == ivy == ivz:
        s = (_pm1(x, 0) + _pm1(x, 1)) + _pm1(x, 2)
        return x + w * ((b - ivx * s) + (6.0 * ivx) * x)
    return x + w * (b - _star(x, invs))


def colour_parity(shape, device) -> torch.Tensor:
    """(i + j + k) % 2 of the global index; 0 is red."""
    i = torch.arange(shape[0], device=device).view(-1, 1, 1)
    j = torch.arange(shape[1], device=device).view(1, -1, 1)
    k = torch.arange(shape[2], device=device).view(1, 1, -1)
    return (i + j + k) % 2


def _colour_weights(b: torch.Tensor, winv: float, reverse: bool):
    """(w1, w2): the masked weight fields of the first and second colour
    (`_color_weight`; the second is winv - w1, exactly)."""
    first = 1 if reverse else 0
    par = colour_parity(b.shape, b.device)
    wt = torch.tensor(winv, dtype=b.dtype, device=b.device)
    w1 = torch.where(par == first, wt, torch.zeros((), dtype=b.dtype,
                                                   device=b.device))
    return w1, wt - w1


def apply_laplacian_plain(u, deltas):
    return _star(u, _invs(deltas))


def apply_laplacian_dot_plain(u, deltas):
    y = _star(u, _invs(deltas))
    return y, torch.sum(u * y)


def residual_plain(u, b, deltas):
    return b - _star(u, _invs(deltas))


def sor_rb_zero_sweep_plain(b, deltas, weight, reverse=False):
    invs = _invs(deltas)
    w1, w2 = _colour_weights(b, _winv(invs, weight), reverse)
    return _halfstep(w1 * b, b, w2, invs)


def sor_rb_zero_update_plain(r, ap, alpha, deltas, weight, reverse=False):
    invs = _invs(deltas)
    a = torch.as_tensor(alpha, dtype=r.dtype, device=r.device)
    b = r - a * ap
    w1, w2 = _colour_weights(b, _winv(invs, weight), reverse)
    x = _halfstep(w1 * b, b, w2, invs)
    return b, x, torch.sum(b * b), torch.sum(b)


def sor_rb_sweep_plain(u, b, deltas, weight, reverse=False, dots=False):
    invs = _invs(deltas)
    w1, w2 = _colour_weights(b, _winv(invs, weight), reverse)
    x = _halfstep(_halfstep(u, b, w1, invs), b, w2, invs)
    return (x, torch.sum(x * b), torch.sum(x)) if dots else x


def sor_rb_multisweep_plain(u, b, deltas, weight, nsweeps, reverse=False,
                            dots=False):
    for k in range(nsweeps):
        last = k == nsweeps - 1
        u = sor_rb_sweep_plain(u, b, deltas, weight, reverse, dots and last)
        if dots and last:
            return u
    return (u, torch.sum(u * b), torch.sum(u)) if dots else u


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _check(*ts: torch.Tensor) -> None:
    """What the kernels take: contiguous 3-D f32/f64 fields of one shape
    and dtype on one CUDA device."""
    t0 = ts[0]
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if t.device != t0.device:
            raise ValueError(f"tensors on {t0.device} and {t.device}")
        if t.dtype not in _DTYPE:
            raise TypeError(
                f"the CUDA kernels take float32 or float64, not {t.dtype} "
                "(bf16 variants belong to the 512^3 slice, see ROADMAP.md)")
        if t.dtype != t0.dtype or t.shape != t0.shape or t.dim() != 3:
            raise ValueError(f"expected matching 3-D fields, got {t0.dtype} "
                             f"{tuple(t0.shape)} and {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous fields")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.poissbox_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _partials(u: torch.Tensor) -> torch.Tensor:
    """One slot per block of a launch over u's grid."""
    return torch.empty(_build.load().poissbox_num_blocks(*u.shape),
                       dtype=u.dtype, device=u.device)


def _stencil7(key: str, u, b, y, part, deltas) -> None:
    lib = _build.load()
    ivx, ivy, ivz = _invs(deltas)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.poissbox_stencil7(
        _DTYPE[u.dtype], _EPI[key], u.device.index or 0,
        ctypes.c_void_p(stream), _ptr(u), _ptr(b), _ptr(y), _ptr(part),
        *u.shape, ivx, ivy, ivz, 2.0 * (ivx + ivy + ivz))
    _raise_on(lib, err, key)
    LAUNCHES[key] += 1


def _rbsor(key: str, like, colour: int, deltas, weight, *, x=None, b=None,
           r=None, ap=None, alpha=None, out=None, bout=None, part0=None,
           part1=None) -> None:
    lib = _build.load()
    invs = _invs(deltas)
    ivx, ivy, ivz = invs
    stream = torch.cuda.current_stream(like.device).cuda_stream
    err = lib.poissbox_rbsor(
        _DTYPE[like.dtype], _MODE[key], int(ivx == ivy == ivz),
        like.device.index or 0, ctypes.c_void_p(stream),
        _ptr(x), _ptr(b), _ptr(r), _ptr(ap), _ptr(alpha), _ptr(out),
        _ptr(bout), _ptr(part0), _ptr(part1), *like.shape,
        ivx, ivy, ivz, 2.0 * (ivx + ivy + ivz), 6.0 * ivx,
        _winv(invs, weight), colour)
    _raise_on(lib, err, key)
    LAUNCHES[key] += 1


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def apply_laplacian_cuda(u: torch.Tensor, deltas) -> torch.Tensor:
    """y = A u, the periodic 7-point Laplacian (K1)."""
    if _on_cpu(u):
        return apply_laplacian_plain(u, deltas)
    _check(u)
    y = torch.empty_like(u)
    _stencil7("stencil7.apply", u, None, y, None, deltas)
    return y


def apply_laplacian_dot_cuda(u: torch.Tensor, deltas):
    """(A u, <u, A u>) in one pass (K2)."""
    if _on_cpu(u):
        return apply_laplacian_dot_plain(u, deltas)
    _check(u)
    y = torch.empty_like(u)
    part = _partials(u)
    _stencil7("stencil7.apply_dot", u, None, y, part, deltas)
    return y, torch.sum(part)


def residual_cuda(u: torch.Tensor, b: torch.Tensor, deltas) -> torch.Tensor:
    """r = b - A u (K9)."""
    if _on_cpu(u):
        return residual_plain(u, b, deltas)
    _check(u, b)
    y = torch.empty_like(u)
    _stencil7("stencil7.residual", u, b, y, None, deltas)
    return y


def _colours(reverse: bool) -> tuple[int, int]:
    return (1, 0) if reverse else (0, 1)


def sor_rb_zero_sweep_cuda(b: torch.Tensor, deltas, weight: float,
                           reverse: bool = False) -> torch.Tensor:
    """One red-black sweep from x = 0 (K3): the first colour is
    winv * mask * b, the second a general colour update."""
    if _on_cpu(b):
        return sor_rb_zero_sweep_plain(b, deltas, weight, reverse)
    _check(b)
    c0, c1 = _colours(reverse)
    x1 = torch.empty_like(b)
    _rbsor("rbsor.zero", b, c0, deltas, weight, b=b, out=x1)
    x = torch.empty_like(b)
    _rbsor("rbsor.general", b, c1, deltas, weight, x=x1, b=b, out=x)
    return x


def sor_rb_zero_update_cuda(r: torch.Tensor, ap: torch.Tensor, alpha,
                            deltas, weight: float, reverse: bool = False):
    """(b, x1, ||b||^2, sum(b)) with b = r - alpha*Ap and x1 the zero-guess
    sweep for A x = b (K5): CG's residual update fused into the V-cycle's
    first kernel. r and Ap stay untouched: both are still live in the
    caller (CG keeps r until the iteration ends)."""
    if _on_cpu(r):
        return sor_rb_zero_update_plain(r, ap, alpha, deltas, weight, reverse)
    _check(r, ap)
    a = torch.as_tensor(alpha, dtype=r.dtype, device=r.device).reshape(1)
    c0, c1 = _colours(reverse)
    b = torch.empty_like(r)
    x1 = torch.empty_like(r)
    rr, sr = _partials(r), _partials(r)
    _rbsor("rbsor.zero_update", r, c0, deltas, weight, r=r, ap=ap, alpha=a,
           out=x1, bout=b, part0=rr, part1=sr)
    x = torch.empty_like(r)
    _rbsor("rbsor.general", r, c1, deltas, weight, x=x1, b=b, out=x)
    return b, x, torch.sum(rr), torch.sum(sr)


def sor_rb_sweep_cuda(u: torch.Tensor, b: torch.Tensor, deltas,
                      weight: float, reverse: bool = False,
                      dots: bool = False):
    """One red-black sweep, both colours (K4). `dots=True` also returns
    (<x_out, b>, sum(x_out)) from the second colour's pass."""
    if _on_cpu(u):
        return sor_rb_sweep_plain(u, b, deltas, weight, reverse, dots)
    _check(u, b)
    c0, c1 = _colours(reverse)
    x1 = torch.empty_like(u)
    _rbsor("rbsor.general", u, c0, deltas, weight, x=u, b=b, out=x1)
    x = torch.empty_like(u)
    if not dots:
        _rbsor("rbsor.general", u, c1, deltas, weight, x=x1, b=b, out=x)
        return x
    rv, sv = _partials(u), _partials(u)
    _rbsor("rbsor.dots", u, c1, deltas, weight, x=x1, b=b, out=x, part0=rv,
           part1=sv)
    return x, torch.sum(rv), torch.sum(sv)


def sor_rb_multisweep_cuda(u: torch.Tensor, b: torch.Tensor, deltas,
                           weight: float, nsweeps: int,
                           reverse: bool = False, dots: bool = False):
    """`nsweeps` red-black sweeps; `dots` as in :func:`sor_rb_sweep_cuda`,
    taken in the last sweep."""
    for k in range(nsweeps):
        last = k == nsweeps - 1
        u = sor_rb_sweep_cuda(u, b, deltas, weight, reverse, dots and last)
        if dots and last:
            return u
    if dots:
        # nsweeps == 0 only
        return u, torch.sum(u * b), torch.sum(u)
    return u
