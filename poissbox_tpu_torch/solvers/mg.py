"""Geometric multigrid V/W-cycle preconditioner (port of the single-device
part of :mod:`poissbox_tpu.solvers.mg`).

  * hierarchy: each level halves (nx, ny, nz) while every extent is even
    and above `coarse_size`; operators are re-discretised 7-point
    Laplacians;
  * smoothers: red-black SOR (the post-smoother runs the colours in
    reverse, so one cycle is symmetric), damped Jacobi, or Chebyshev;
  * transfers: cell-centred full weighting and trilinear prolongation
    (P = 2 R^T) in the roll formulation;
  * coarse solve: the SVD pseudo-inverse of the assembled coarse
    Laplacian, computed once with the JAX package's numpy code.

On a CUDA device every level runs the hand-written kernels of
:mod:`poissbox_tpu_torch.ops.stencil_cuda` (impl ``"cuda"``); the JAX
package's ``min(shape) >= 16`` Pallas gate is a TPU tiling rule and has no
counterpart. ``impl="cuda"`` on CPU tensors runs the kernels' plain
versions on every level, the same call graph. ``impl="roll"`` is the
plain formulation on any device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from poissbox_tpu_torch.ops.stencil import apply_laplacian, default_impl
from poissbox_tpu_torch.ops.stencil_cuda import (
    apply_laplacian_cuda,
    colour_parity,
    residual_cuda,
    sor_rb_multisweep_cuda,
    sor_rb_zero_sweep_cuda,
    sor_rb_zero_update_cuda,
)

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


def _dtype(name: str) -> Optional[torch.dtype]:
    if not name:
        return None
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r} (expected one of {sorted(_DTYPES)})")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Multigrid knobs, mirroring :class:`poissbox_tpu.solvers.mg.MGConfig`.

    `impl`: auto | roll | cuda (level operators). `transfers`: auto | roll;
    'matmul' (the TPU's banded-matrix form and its fused K6/K7 legs) is
    not ported yet. `dtype`/`pre_dtype`: "" (the field dtype), "float32",
    "float64" or "bfloat16" — the CUDA kernels take float32 and float64
    only, so a bf16 cycle runs on the CPU or with impl='roll'.
    """

    levels: int = 0               # 0 = auto (coarsen while divisible, > coarse_size)
    smoother: str = "sor"         # "sor" (red-black) | "jacobi" | "chebyshev"
    pre_smooth: int = -1          # -1 = auto, see _resolve_sweeps
    post_smooth: int = -1
    damping: Optional[float] = None  # None = per-smoother default (sor 1.0, jacobi 8/9)
    coarse: str = "svd"           # "svd" | "direct" (both dense; svd truncates nullspace)
    coarse_size: int = 4          # stop coarsening at min(n) <= coarse_size
    cycles: int = 1               # cycles per preconditioner application
    cycle: str = "v"              # "v" | "w"
    w_depth: int = 2              # W doubling only down to this level
    impl: str = "auto"            # auto | roll | cuda
    transfers: str = "auto"       # auto | roll
    dtype: str = ""               # cycle compute dtype ("" = field dtype)
    pre_dtype: str = ""           # pre-smoother dtype ("" = cycle dtype)


# High-frequency contraction factor per sweep (see the JAX package):
# RB-SOR(w=1) ~0.25, damped Jacobi ~5/7, Chebyshev ~0.27 per 2 degrees.
_SMOOTHING_FACTOR = {"sor": 0.25, "jacobi": 5.0 / 7.0, "chebyshev": 0.27}


def sweeps_for_level_rtol(smoother: str, rtol: float, max_it: int) -> int:
    """Static sweep count equivalent to a level solve run to `rtol` capped
    at `max_it` iterations (PETSc stops at whichever binds first)."""
    mu = _SMOOTHING_FACTOR.get(smoother)
    if mu is None:
        raise ValueError(f"unknown smoother {smoother!r}")
    if not (0.0 < rtol < 1.0):
        return max_it
    need = math.ceil(math.log(rtol) / math.log(mu))
    return max(1, min(int(max_it), need))


@dataclasses.dataclass(frozen=True)
class _Level:
    shape: tuple[int, int, int]
    deltas: tuple[float, float, float]
    diag: float                   # constant stencil diagonal -2*sum(1/d^2)


def _kernels(cfg: MGConfig, device) -> bool:
    """True when the levels run the CUDA kernels (or, for CPU tensors,
    their plain versions)."""
    impl = cfg.impl if cfg.impl != "auto" else default_impl(device)
    if impl not in ("roll", "cuda"):
        raise ValueError(f"unknown MG impl {cfg.impl!r} (expected auto|roll|cuda)")
    return impl == "cuda"


def _check_transfers(cfg: MGConfig) -> None:
    """The port's transfers are the roll formulation ('auto' resolves to it
    on every device)."""
    if cfg.transfers in ("auto", "roll"):
        return
    if cfg.transfers == "matmul":
        raise NotImplementedError(
            "transfers='matmul' (and its fused legs K6/K7) is not ported "
            "yet; see ROADMAP.md queue 2")
    raise ValueError(f"unknown transfers {cfg.transfers!r} (expected auto|roll)")


def _lapl(x: Tensor, lvl: _Level, cfg: MGConfig) -> Tensor:
    if _kernels(cfg, x.device):
        return apply_laplacian_cuda(x, lvl.deltas)
    return apply_laplacian(x, lvl.deltas)


def _residual(x: Tensor, b: Tensor, lvl: _Level, cfg: MGConfig) -> Tensor:
    if _kernels(cfg, b.device):
        return residual_cuda(x, b, lvl.deltas)
    return b - apply_laplacian(x, lvl.deltas)


def _build_levels(shape, deltas, cfg: MGConfig) -> list[_Level]:
    levels = []
    n = tuple(int(v) for v in shape)
    d = tuple(float(x) for x in deltas)
    while True:
        diag = -2.0 * sum(1.0 / dd**2 for dd in d)
        levels.append(_Level(n, d, diag))
        stop_size = min(n) <= cfg.coarse_size
        stop_div = any(x % 2 for x in n)
        stop_count = cfg.levels > 0 and len(levels) >= cfg.levels
        if stop_size or stop_div or stop_count:
            return levels
        n = tuple(x // 2 for x in n)
        d = tuple(2.0 * dd for dd in d)


# ---------------------------------------------------------------------------
# transfers (cell-centred, periodic)
# ---------------------------------------------------------------------------

def restrict(f: Tensor) -> Tensor:
    """Full-weighting restriction, R = P^T / 8. Along each axis:
    c_I = (3 f_{2I} + 3 f_{2I+1} + f_{2I+2} + f_{2I-1}) / 8, periodic."""
    for ax in range(f.dim()):
        n = f.shape[ax]
        pairs = f.reshape(f.shape[:ax] + (n // 2, 2) + f.shape[ax + 1:])
        even = pairs.select(ax + 1, 0)           # f_{2I}
        odd = pairs.select(ax + 1, 1)            # f_{2I+1}
        up = torch.roll(even, -1, ax)            # f_{2I+2}
        dn = torch.roll(odd, 1, ax)              # f_{2I-1}
        f = (3.0 * (even + odd) + up + dn) * 0.125
    return f


def prolong(c: Tensor) -> Tensor:
    """Trilinear prolongation: a fine cell at i = 2I + s takes 3/4 of its
    parent and 1/4 of the parent's periodic neighbour on side s."""
    for ax in range(c.dim()):
        even = 0.75 * c + 0.25 * torch.roll(c, 1, ax)    # fine i = 2I
        odd = 0.75 * c + 0.25 * torch.roll(c, -1, ax)    # fine i = 2I + 1
        c = torch.stack([even, odd], dim=ax + 1)
        c = c.reshape(c.shape[:ax] + (c.shape[ax] * 2,) + c.shape[ax + 2:])
    return c


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------

def _smooth(x: Optional[Tensor], b: Tensor, lvl: _Level, cfg: MGConfig,
            sweeps: int, reverse: bool, dots: bool = False):
    """`sweeps` smoothing iterations; `dots=True` also returns
    (<x_out, b>, sum(x_out)), from the last SOR kernel where it can."""
    out = _smooth_impl(x, b, lvl, cfg, sweeps, reverse, dots)
    if not dots or isinstance(out, tuple):
        return out
    return out, torch.sum(out * b), torch.sum(out)


def _smooth_impl(x: Optional[Tensor], b: Tensor, lvl: _Level, cfg: MGConfig,
                 sweeps: int, reverse: bool, dots: bool = False):
    """_smooth's body. `x=None` is a zero initial guess: the first partial
    update is evaluated in closed form (A 0 = 0)."""
    if sweeps < 0:
        raise ValueError(
            "pre/post_smooth=-1 (auto) is resolved by make_mg_preconditioner;"
            " pass explicit sweep counts when calling v_cycle directly")
    if sweeps == 0:
        # pre_smooth=0 / post_smooth=0 are exact no-ops (zero guess
        # included), or the cycle loses its transpose pairing
        return torch.zeros_like(b) if x is None else x
    inv_diag = 1.0 / lvl.diag
    kernels = _kernels(cfg, b.device)
    if cfg.smoother == "jacobi":
        if kernels:
            raise NotImplementedError(
                "the Jacobi smoother's kernel (K10) is not ported yet; run "
                "it with impl='roll' (ROADMAP.md queue 2)")
        w = 8.0 / 9.0 if cfg.damping is None else cfg.damping
        if x is None:
            x = (w * inv_diag) * b      # first sweep from zero, closed form
            sweeps -= 1
        for _ in range(sweeps):
            x = x + w * inv_diag * (b - apply_laplacian(x, lvl.deltas))
        return x
    if cfg.smoother == "chebyshev":
        # Chebyshev on the known spectrum [-4 sum(1/d^2), 0], smoothing
        # its upper 90% (GAMG's convention); symmetric by construction
        m = 4.0 * sum(1.0 / dd**2 for dd in lvl.deltas)
        a_lo, b_hi = -m, -0.1 * m
        theta = 0.5 * (a_lo + b_hi)
        delta = 0.5 * (b_hi - a_lo)
        sigma1 = theta / delta
        degree = max(2 * sweeps, 2)
        if x is None:
            d = b / theta
            x = d
        else:
            r = _residual(x, b, lvl, cfg)
            d = r / theta
            x = x + d
        rho = 1.0 / sigma1
        for _ in range(degree - 1):
            r = _residual(x, b, lvl, cfg)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x
    if cfg.smoother == "sor":
        w = 1.0 if cfg.damping is None else cfg.damping
        if kernels:
            if x is None:
                x = sor_rb_zero_sweep_cuda(b, lvl.deltas, w, reverse=reverse)
                if sweeps > 1:
                    x = sor_rb_multisweep_cuda(x, b, lvl.deltas, w, sweeps - 1,
                                               reverse=reverse)
                return x
            return sor_rb_multisweep_cuda(x, b, lvl.deltas, w, sweeps,
                                          reverse=reverse, dots=dots)
        order = [1, 0] if reverse else [0, 1]  # color 0 = red, (i+j+k) even
        red = (colour_parity(lvl.shape, b.device) == 0).to(b.dtype)
        masks = {0: red, 1: 1.0 - red}
        if x is None:
            # first colour from zero in closed form, then the second
            x = (w * inv_diag) * masks[order[0]] * b
            r = b - apply_laplacian(x, lvl.deltas)
            x = x + (w * inv_diag) * masks[order[1]] * r
            sweeps -= 1
        for _ in range(sweeps):
            for color in order:
                r = b - apply_laplacian(x, lvl.deltas)
                x = x + (w * inv_diag) * masks[color] * r
        return x
    raise ValueError(f"unknown smoother {cfg.smoother!r} (expected sor|jacobi|chebyshev)")


# ---------------------------------------------------------------------------
# coarse solve
# ---------------------------------------------------------------------------

def _dense_periodic_laplacian(shape, deltas) -> np.ndarray:
    """The coarse 7-point periodic Laplacian, assembled densely (numpy):
    A = Lx (x) Iy (x) Iz + ... ."""
    def l1d(n, d):
        L = np.zeros((n, n))
        idx = np.arange(n)
        L[idx, idx] = -2.0
        L[idx, (idx + 1) % n] = 1.0
        L[idx, (idx - 1) % n] = 1.0
        return L / d**2

    nx, ny, nz = shape
    dx, dy, dz = deltas
    Ix, Iy, Iz = np.eye(nx), np.eye(ny), np.eye(nz)
    return (np.kron(np.kron(l1d(nx, dx), Iy), Iz)
            + np.kron(np.kron(Ix, l1d(ny, dy)), Iz)
            + np.kron(np.kron(Ix, Iy), l1d(nz, dz)))


def _coarse_pinv(lvl: _Level, cfg: MGConfig, dtype=torch.float64,
                 device="cpu") -> Tensor:
    """SVD pseudo-inverse of the coarse operator, null space truncated —
    the same numpy computation as the JAX package's, so the two agree bit
    for bit."""
    A = _dense_periodic_laplacian(lvl.shape, lvl.deltas)
    if cfg.coarse not in ("svd", "direct"):
        raise ValueError(f"unknown coarse solve {cfg.coarse!r}")
    pinv = np.linalg.pinv(A, rcond=1e-10)
    return torch.as_tensor(pinv, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------

def _coarse_correct(levels: Sequence[_Level], coarse_pinv: Tensor,
                    cfg: MGConfig, rc: Tensor, cidx: int) -> Tensor:
    """Child-level correction: one recursive cycle, or two in W mode (the
    second corrects the first, e <- e + C(rc - A e))."""
    ec = v_cycle(levels, coarse_pinv, cfg, rc, cidx)
    if cfg.cycle == "w" and cidx <= cfg.w_depth and cidx < len(levels) - 1:
        r2 = rc - _lapl(ec, levels[cidx], cfg)
        ec = ec + v_cycle(levels, coarse_pinv, cfg, r2, cidx)
    elif cfg.cycle not in ("v", "w"):
        raise ValueError(f"unknown cycle {cfg.cycle!r} (expected v|w)")
    return ec


def v_cycle(levels: Sequence[_Level], coarse_pinv: Tensor, cfg: MGConfig,
            b: Tensor, idx: int = 0, dots: bool = False):
    """One cycle for the level-`idx` system A_idx e = b. `dots=True` (top
    level) returns (x, <x, b>, sum(x)), the reductions taken in the final
    post-smooth kernel."""
    lvl = levels[idx]
    if idx == len(levels) - 1:
        # coarse solve in the pinv's (setup) precision, cast back
        flat = b.reshape(-1).to(coarse_pinv.dtype)
        return (coarse_pinv @ flat).reshape(lvl.shape).to(b.dtype)
    pd = _dtype(cfg.pre_dtype)
    if pd is not None and pd != b.dtype:
        # low-precision pre-smooth; the full-precision residual below
        # absorbs x1's rounding (the fused legs that could take the
        # narrow iterate are not ported, so it widens here)
        x = _smooth(None, b.to(pd), lvl, cfg, cfg.pre_smooth, reverse=False)
        x = x.to(b.dtype)
    else:
        x = _smooth(None, b, lvl, cfg, cfg.pre_smooth, reverse=False)
    return _v_cycle_rest(levels, coarse_pinv, cfg, x, b, idx, dots)


def _v_cycle_rest(levels: Sequence[_Level], coarse_pinv: Tensor,
                  cfg: MGConfig, x: Tensor, b: Tensor, idx: int,
                  dots: bool = False):
    """The cycle after the pre-smooth: residual, restrict, child
    correction, prolong, post-smooth (shared with apply_update_dots)."""
    lvl = levels[idx]
    _check_transfers(cfg)
    r = _residual(x, b, lvl, cfg)
    rc = restrict(r)
    ec = _coarse_correct(levels, coarse_pinv, cfg, rc, idx + 1)
    x = x + prolong(ec)
    return _smooth(x, b, lvl, cfg, cfg.post_smooth, reverse=True, dots=dots)


def _resolve_sweeps(cfg: MGConfig, shape: Sequence[int]) -> MGConfig:
    """Resolve pre/post_smooth = -1 (auto) against the fine-grid size:
    V(1,1) at 512^3-class, V(2,2) at 256^3-class, V(3,3) below. The JAX
    package's rule, kept verbatim so iteration counts compare one to one;
    it was tuned on a TPU, and re-deciding it from H100 runs is ROADMAP
    work. Explicit values pass through."""
    if cfg.pre_smooth >= 0 and cfg.post_smooth >= 0:
        return cfg
    auto = 1 if min(shape) >= 512 else (2 if min(shape) >= 256 else 3)
    return dataclasses.replace(
        cfg,
        pre_smooth=cfg.pre_smooth if cfg.pre_smooth >= 0 else auto,
        post_smooth=cfg.post_smooth if cfg.post_smooth >= 0 else auto)


def make_mg_preconditioner(
    shape: Sequence[int],
    deltas: Sequence[float],
    cfg: MGConfig = MGConfig(),
    dtype=torch.float64,
    device="cpu",
) -> Callable[[Tensor], Tensor]:
    """Build M(r) ~= A^{-1} r, a cycle closure on `device`.

    Setup (hierarchy + dense coarse pseudo-inverse) runs once here. The
    closure is linear and symmetric. Like the JAX package's, it exposes
    `config` (the resolved MGConfig), `apply_dots` (single cycle, field
    dtype) and, for SOR on kernel levels, `apply_update_dots`.
    """
    device = torch.device(device)
    cfg = _resolve_sweeps(cfg, shape)
    if (not cfg.pre_dtype and not cfg.dtype and min(shape) >= 512
            and dtype == torch.float32):
        # the JAX package's 512^3-class default: bf16 pre-smooth
        cfg = dataclasses.replace(cfg, pre_dtype="bfloat16")
    _check_transfers(cfg)
    levels = _build_levels(tuple(shape), tuple(deltas), cfg)
    pinv = _coarse_pinv(levels[-1], cfg, dtype, device)
    cdt = _dtype(cfg.dtype)

    def M(r: Tensor) -> Tensor:
        rin = r.to(cdt) if cdt is not None else r
        x = v_cycle(levels, pinv, cfg, rin)
        for _ in range(cfg.cycles - 1):
            x = x + v_cycle(levels, pinv, cfg, rin - _lapl(x, levels[0], cfg))
        return x.to(r.dtype)

    M.config = cfg
    if cfg.cycles == 1 and cdt is None and len(levels) > 1:
        def apply_dots(r: Tensor):
            return v_cycle(levels, pinv, cfg, r, dots=True)
        M.apply_dots = apply_dots

        pd0 = _dtype(cfg.pre_dtype)
        # the fused legs that would let a narrow pre-smooth feed this path
        # are not ported, so only a field-dtype pre-smooth qualifies
        pd_ok = pd0 is None or pd0 == dtype
        if (cfg.smoother == "sor" and cfg.pre_smooth >= 1 and pd_ok
                and _kernels(cfg, device)):
            # CG's residual update fused into the cycle's first kernel:
            # (r, Ap, alpha) -> (v, b, ||b||^2, sum(b), <b, v>, sum(v))
            # for b = r - alpha*Ap
            w = 1.0 if cfg.damping is None else cfg.damping
            lvl0 = levels[0]

            def apply_update_dots(r: Tensor, ap: Tensor, alpha):
                b_new, x, rr, sr = sor_rb_zero_update_cuda(
                    r, ap, alpha, lvl0.deltas, w)
                if cfg.pre_smooth > 1:
                    x = sor_rb_multisweep_cuda(x, b_new, lvl0.deltas, w,
                                               cfg.pre_smooth - 1)
                v, rv, sv = _v_cycle_rest(levels, pinv, cfg, x, b_new, 0,
                                          dots=True)
                return v, b_new, rr, sr, rv, sv
            M.apply_update_dots = apply_update_dots
    return M
