"""Geometric multigrid V/W-cycle preconditioner (port of the single-device
part of :mod:`poissbox_tpu.solvers.mg`).

  * hierarchy: each level halves (nx, ny, nz) while every extent is even
    and above `coarse_size`; operators are re-discretised 7-point
    Laplacians;
  * smoothers: red-black SOR (the post-smoother runs the colours in
    reverse, so one cycle is symmetric), damped Jacobi, or Chebyshev;
  * transfers: cell-centred full weighting and trilinear prolongation
    (P = 2 R^T), in the roll formulation, as banded-matrix contractions
    ("matmul"), or, on kernel levels with "matmul", as one fused kernel
    each way;
  * coarse solve: the SVD pseudo-inverse of the assembled coarse
    Laplacian, computed once with the JAX package's numpy code.

On a CUDA device every level runs the hand-written kernels of
:mod:`poissbox_tpu_torch.ops.stencil_cuda` (impl ``"cuda"``); the JAX
package's ``min(shape) >= 16`` Pallas gate is a TPU tiling rule and has no
counterpart. ``transfers="auto"`` resolves to "matmul" on a CUDA device,
as the JAX package resolves it on its accelerator, so every non-coarsest
kernel level takes the fused legs of
:mod:`poissbox_tpu_torch.ops.transfer_cuda`: K6 goes from (x, b) straight
to the coarse residual, K7 from the coarse correction straight to x + P e,
the whole 3-D transfer in one launch each (the JAX package does x in its
kernels and y/z as contractions; the sums are the same, rounded as the roll
form rounds them). The other "matmul" levels, ``impl="roll"``, contract
with the banded matrices (`restrict_mm`, `prolong_mm`). On the CPU "auto"
resolves to "roll".
``impl="cuda"`` on CPU tensors runs the kernels' plain versions on every
level, so ``impl="cuda", transfers="matmul"`` walks the card's call graph
on the CPU. ``impl="roll"`` is the plain formulation on any device.

Over a process grid (``make_mg_preconditioner(..., grid=g)`` with `g`
spanning more than one rank) the JAX package's policy holds exactly, so
the level stacks and the iteration counts of the two packages match: a
level stays distributed (each rank its owned box) while every split local
extent is even; an uneven fine level runs distributed and the levels below
it replicated; coarser levels that no longer split evenly run replicated,
every rank computing the same field (the GAMG-style reduction of the
process count). Distributed levels run the correction-form operators of
:mod:`poissbox_tpu_torch.parallel.dist_stencil`: the first SOR colour from
zero in closed form, then one K11 launch a colour (never the one-launch
sweep: its second colour reads first-colour values across the faces), and
the roll-form transfers on halo-padded blocks. A replicated level is
reached by a gather and left by a cut; the coarse pseudo-inverse is
applied on every rank.

Spans (:func:`poissbox_tpu_torch.utils.profiling.span`): `MGLevel<k>`, a
level's cycle with the levels below it, and inside it `MGSmooth`, each
pre- or post-smoothing; each Chebyshev smoothing also counts its steps
(`MGSmooth.cheb_steps`) and their points by kind and dtype, which the
benchmark's byte model of the smoothing reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from poissbox_tpu_torch.ops.stencil import apply_laplacian, default_impl
from poissbox_tpu_torch.ops.stencil_cuda import (
    apply_laplacian_cuda,
    colour_parity,
    jacobi_sweep_cuda,
    residual_cuda,
    sor_rb_multisweep_cuda,
    sor_rb_zero_sweep_cuda,
    sor_rb_zero_update_cuda,
)
from poissbox_tpu_torch.ops.transfer_cuda import (
    prolong_add_cuda,
    prolong_axis,
    residual_restrict_cuda,
    restrict_axis,
)
from poissbox_tpu_torch.parallel import dist_stencil as ds
from poissbox_tpu_torch.parallel.halo import halo_pad_local, pad_from_global
from poissbox_tpu_torch.parallel.uneven import color_mask
from poissbox_tpu_torch.utils import profiling
from poissbox_tpu_torch.utils.profiling import span

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

    `impl`: auto | roll | cuda (level operators); "pallas", the JAX
    package's name for its kernel path, means "cuda". `transfers`: auto |
    roll | matmul ("auto" is matmul on a CUDA device, roll on the CPU).
    `dtype`/`pre_dtype`: "" (the field dtype), "float32", "float64" or
    "bfloat16". On the kernel path a bf16 `pre_dtype` runs the SOR
    pre-smooth in bf16 (the 512^3-class default); a bf16 cycle `dtype`
    needs bf16 stencil and transfer kernels, which are not ported, so it
    runs on the CPU or with impl='roll'.
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
    impl: str = "auto"            # auto | roll | cuda (pallas = cuda)
    transfers: str = "auto"       # auto | roll | matmul
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
    # the level's Grid3D when it runs distributed (each rank its owned
    # box); None when it runs replicated or on one device
    grid: Optional[object] = None


def _kernels(cfg: MGConfig, device) -> bool:
    """True when the levels run the CUDA kernels (or, for CPU tensors,
    their plain versions). "pallas", the reference's name for its kernel
    path, selects them too, so its command lines run unchanged."""
    impl = cfg.impl if cfg.impl != "auto" else default_impl(device)
    if impl not in ("roll", "cuda", "pallas"):
        raise ValueError(f"unknown MG impl {cfg.impl!r} "
                         "(expected auto|roll|cuda|pallas)")
    return impl != "roll"


def _transfers(cfg: MGConfig, device) -> str:
    """The resolved transfer form: "auto" is "matmul" on a CUDA device (the
    JAX package's choice on its accelerator, mg.py:586-587) and "roll" on
    the CPU."""
    tr = cfg.transfers
    if tr == "auto":
        return "matmul" if torch.device(device).type == "cuda" else "roll"
    if tr not in ("roll", "matmul"):
        raise ValueError(f"unknown transfers {tr!r} (expected auto|roll|matmul)")
    return tr


def _fused_leg(levels: Sequence[_Level], cfg: MGConfig, idx: int,
               device) -> bool:
    """True when level `idx` goes down through K6 and up through K7, one
    launch each way with the whole 3-D transfer in it (the path that takes
    a narrow pre-smooth iterate as it is): every non-coarsest kernel level
    with matmul transfers whose own and next level run on one device or
    replicated (never across a distributed level, as in the JAX
    package)."""
    return (idx < len(levels) - 1 and _transfers(cfg, device) == "matmul"
            and _kernels(cfg, device) and levels[idx].grid is None
            and levels[idx + 1].grid is None)


def _local_impl(cfg: MGConfig) -> str:
    """The block kernels' choice on distributed levels (dist_stencil's
    local_impl): roll, cuda (pallas) or auto."""
    return {"roll": "roll", "cuda": "cuda", "pallas": "cuda"}.get(cfg.impl, "auto")


def _lapl(x: Tensor, lvl: _Level, cfg: MGConfig) -> Tensor:
    if lvl.grid is not None:
        return ds.apply_laplacian_sharded(x, lvl.grid, local_impl=_local_impl(cfg))
    if _kernels(cfg, x.device):
        return apply_laplacian_cuda(x, lvl.deltas)
    return apply_laplacian(x, lvl.deltas)


def _residual(x: Tensor, b: Tensor, lvl: _Level, cfg: MGConfig) -> Tensor:
    if lvl.grid is not None:
        return ds.residual_sharded(x, b, lvl.grid, local_impl=_local_impl(cfg))
    if _kernels(cfg, b.device):
        return residual_cuda(x, b, lvl.deltas)
    return b - apply_laplacian(x, lvl.deltas)


def _level_shardable(n, grid) -> bool:
    """A level stays distributed while every split dim keeps an even local
    extent (the JAX package's rule, kept so the level stacks match)."""
    if grid is None or not grid.distributed:
        return False
    for nd, p in zip(n, grid.pgrid):
        if p > 1 and (nd % p != 0 or (nd // p) % 2 != 0):
            return False
    return True


def _build_levels(shape, deltas, cfg: MGConfig, grid=None) -> list[_Level]:
    levels = []
    n = tuple(int(v) for v in shape)
    d = tuple(float(x) for x in deltas)
    uneven_fine = grid is not None and grid.distributed and grid.uneven
    while True:
        diag = -2.0 * sum(1.0 / dd**2 for dd in d)
        lgrid = None
        if uneven_fine and not levels:
            # an uneven fine level runs distributed, the levels below it
            # replicated
            lgrid = grid
        elif _level_shardable(n, grid):
            lgrid = dataclasses.replace(grid, n=n)
        levels.append(_Level(n, d, diag, grid=lgrid))
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

def restrict(f: Tensor, axes=(0, 1, 2)) -> Tensor:
    """Full-weighting restriction, R = P^T / 8. Along each axis of `axes`:
    c_I = (3 f_{2I} + 3 f_{2I+1} + f_{2I+2} + f_{2I-1}) / 8, periodic."""
    for ax in axes:
        f = restrict_axis(f, ax)
    return f


def prolong(c: Tensor, axes=(0, 1, 2)) -> Tensor:
    """Trilinear prolongation: a fine cell at i = 2I + s takes 3/4 of its
    parent and 1/4 of the parent's periodic neighbour on side s."""
    for ax in axes:
        c = prolong_axis(c, ax)
    return c


def restrict_padded(fp: Tensor) -> Tensor:
    """restrict() of a block padded with one halo plane on every side (the
    planes f_{2I-1} and f_{2I+2} at its ends): the coarse block, the same
    sums in the same order as the global roll form."""
    for ax in range(3):
        n = fp.shape[ax] - 2
        every2 = (slice(None),) * ax + (slice(None, None, 2),)
        even = fp.narrow(ax, 1, n)[every2]          # f_{2I}
        odd = fp.narrow(ax, 2, n)[every2]           # f_{2I+1}
        up = fp.narrow(ax, 3, n - 1)[every2]        # f_{2I+2}
        dn = fp.narrow(ax, 0, n - 1)[every2]        # f_{2I-1}
        fp = (3.0 * (even + odd) + up + dn) * 0.125
    return fp


def prolong_padded(cp: Tensor) -> Tensor:
    """prolong() of a coarse block padded with one halo plane on every side
    (c_{I-1} and c_{I+1} at its ends): the fine block."""
    for ax in range(3):
        n = cp.shape[ax] - 2
        c = cp.narrow(ax, 1, n)
        even = 0.75 * c + 0.25 * cp.narrow(ax, 0, n)     # fine i = 2I
        odd = 0.75 * c + 0.25 * cp.narrow(ax, 2, n)      # fine i = 2I + 1
        c = torch.stack([even, odd], dim=ax + 1)
        cp = c.reshape(c.shape[:ax] + (2 * n,) + c.shape[ax + 2:])
    return cp


def _down(r: Tensor, lvl: _Level, nxt: _Level) -> Tensor:
    """The restricted residual on the coarse level `nxt`, from a
    distributed level: a halo-padded local restriction (distributed
    below), gathered where the coarse level runs replicated; an uneven
    fine level gathers its residual and restricts it replicated."""
    if lvl.grid.uneven:
        return restrict(lvl.grid.unshard(r))
    rc = restrict_padded(halo_pad_local(r, lvl.grid.mesh, 1))
    if nxt.grid is not None:
        return rc
    return dataclasses.replace(lvl.grid, n=nxt.shape).unshard(rc)


def _up(ec: Tensor, lvl: _Level, nxt: _Level) -> Tensor:
    """The prolonged correction on the distributed level `lvl`, from the
    coarse level `nxt`'s (block or replicated field)."""
    if lvl.grid.uneven:
        return lvl.grid.shard(prolong(ec))
    if nxt.grid is not None:
        return prolong_padded(halo_pad_local(ec, lvl.grid.mesh, 1))
    cgrid = dataclasses.replace(lvl.grid, n=nxt.shape)
    return prolong_padded(pad_from_global(ec, cgrid, 1))


@functools.lru_cache(maxsize=None)
def _restrict_matrix(n: int, dtype: torch.dtype, device: torch.device,
                     transpose: bool = False) -> Tensor:
    """1-D full weighting as a dense (n/2, n) banded matrix, or with
    `transpose` the prolongation P = 2 R^T; cached per (n, dtype, device)."""
    R = np.zeros((n // 2, n))
    for I in range(n // 2):
        R[I, (2 * I - 1) % n] += 1.0 / 8.0
        R[I, 2 * I] += 3.0 / 8.0
        R[I, (2 * I + 1) % n] += 3.0 / 8.0
        R[I, (2 * I + 2) % n] += 1.0 / 8.0
    return torch.as_tensor(2.0 * R.T if transpose else R, dtype=dtype,
                           device=device)


@contextlib.contextmanager
def _full_fp32_matmul():
    """float32 products in full float32: JAX runs these contractions at
    Precision.HIGHEST; a TF32 product would move them by ~1e-3 relative.
    Set for the call, whatever the global default is."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _contract(f: Tensor, axes, transpose: bool) -> Tensor:
    """Contract each axis of `axes` with the banded matrix, in place in
    the layout: the field is viewed as (before, n, after), so axis 0 is
    one product M @ f, a middle axis a product batched over `before`, and
    the last axis f @ M^T; no transposed copy is made (tensordot would
    permute the field first and movedim leave a strided result)."""
    out = f.contiguous()
    with _full_fp32_matmul():
        for ax in axes:
            shape = out.shape
            n = shape[ax] * 2 if transpose else shape[ax]
            M = _restrict_matrix(n, out.dtype, out.device, transpose)
            before, after = math.prod(shape[:ax]), math.prod(shape[ax + 1:])
            if after == 1:
                out = out.reshape(before, shape[ax]) @ M.T
            else:
                out = torch.matmul(M, out.reshape(before, shape[ax], after))
            out = out.reshape(shape[:ax] + (M.shape[0],) + shape[ax + 1:])
    return out


def restrict_mm(f: Tensor, axes=(0, 1, 2)) -> Tensor:
    """restrict() as one banded-matrix contraction per axis of `axes`: the
    "matmul" transfers of levels that run no kernels (``impl="roll"``); a
    kernel level's fused legs restrict and prolong inside K6 and K7."""
    return _contract(f, axes, transpose=False)


def prolong_mm(c: Tensor, axes=(0, 1, 2)) -> Tensor:
    """prolong() as contractions with P = 2 R^T."""
    return _contract(c, axes, transpose=True)


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------

def _smooth(x: Optional[Tensor], b: Tensor, lvl: _Level, cfg: MGConfig,
            sweeps: int, reverse: bool, dots: bool = False):
    """`sweeps` smoothing iterations, the span `MGSmooth` (inside the
    level's `MGLevel<k>`), for every smoother; `dots=True` also returns
    (<x_out, b>, sum(x_out)), from the last SOR kernel where it can (the
    sums taken after it, outside the span). The fine level's first SOR
    sweep that `apply_update_dots` fuses into CG's residual update is
    outside any `MGSmooth`; the rest of that pre-smooth is one."""
    with span("MGSmooth"):
        out = _smooth_impl(x, b, lvl, cfg, sweeps, reverse, dots)
    if not dots or isinstance(out, tuple):
        return out
    return out, torch.sum(out * b), torch.sum(out)


def chebyshev_degree(sweeps: int) -> int:
    """The Chebyshev smoother's polynomial degree for `sweeps` sweeps: two
    degrees a sweep (the JAX package's count, about one red-black SOR
    sweep's cost), at least 2."""
    return max(2 * sweeps, 2)


def _count_chebyshev(zero: bool, degree: int, b: Tensor) -> None:
    """The counters of one Chebyshev smoothing of `degree` steps on `b`'s
    points in `b`'s dtype: `MGSmooth.cheb_steps` (the degrees applied) and
    `MGSmooth.cheb_points.<step>.<dtype>`, the points of each kind of step
    summed (step: "zero", the first from a zero guess; "first", the first
    from a given x; "middle"; "last")."""
    pts, dt = b.numel(), str(b.dtype).replace("torch.", "")
    profiling.count("MGSmooth.cheb_steps", degree)
    profiling.count(f"MGSmooth.cheb_points.{'zero' if zero else 'first'}.{dt}", pts)
    if degree > 2:
        profiling.count(f"MGSmooth.cheb_points.middle.{dt}", (degree - 2) * pts)
    profiling.count(f"MGSmooth.cheb_points.last.{dt}", pts)


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
    dist = lvl.grid is not None
    if cfg.smoother == "jacobi":
        w = 8.0 / 9.0 if cfg.damping is None else cfg.damping
        if x is None:
            x = (w * inv_diag) * b      # first sweep from zero, closed form
            sweeps -= 1
        if dist:
            for _ in range(sweeps):
                x = ds.jacobi_sweep_sharded(x, b, lvl.grid, w,
                                            local_impl=_local_impl(cfg))
            return x
        for _ in range(sweeps):
            if kernels:
                x = jacobi_sweep_cuda(x, b, lvl.deltas, w)
            else:
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
        degree = chebyshev_degree(sweeps)
        if profiling.active():
            _count_chebyshev(x is None, degree, b)
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
        if dist:
            # the first colour from zero in closed form (its mask from global
            # indices), then one K11 launch a colour
            order = [1, 0] if reverse else [0, 1]
            if x is None:
                m0 = color_mask(lvl.grid, order[0], b.dtype)
                x = (w * inv_diag) * m0 * b
                x = ds.sor_sweep_sharded(x, b, lvl.grid, w, order[1],
                                         local_impl=_local_impl(cfg))
                sweeps -= 1
            for _ in range(sweeps):
                for color in order:
                    x = ds.sor_sweep_sharded(x, b, lvl.grid, w, color,
                                             local_impl=_local_impl(cfg))
            return x
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


# the spans of the levels, named once (MGLevel0 the finest)
_LEVEL_SPANS = tuple(f"MGLevel{k}" for k in range(32))


def v_cycle(levels: Sequence[_Level], coarse_pinv: Tensor, cfg: MGConfig,
            b: Tensor, idx: int = 0, dots: bool = False):
    """One cycle for the level-`idx` system A_idx e = b, the span
    `MGLevel<idx>` (the coarsest level's is its pseudo-inverse solve).
    `dots=True` (top level) returns (x, <x, b>, sum(x)), the reductions
    taken in the final post-smooth kernel."""
    with span(_LEVEL_SPANS[idx]):
        lvl = levels[idx]
        if idx == len(levels) - 1:
            # coarse solve in the pinv's (setup) precision, cast back; a
            # distributed coarse level is gathered, solved on every rank and cut
            full = b if lvl.grid is None else lvl.grid.unshard(b)
            flat = full.reshape(-1).to(coarse_pinv.dtype)
            x = (coarse_pinv @ flat).reshape(lvl.shape).to(b.dtype)
            return x if lvl.grid is None else lvl.grid.shard(x)
        pd = _dtype(cfg.pre_dtype)
        if pd is not None and pd != b.dtype:
            # low-precision pre-smooth; the full-precision residual below
            # absorbs x1's rounding. The fused legs read the narrow iterate as
            # it is (K6/K7 upcast it); the other paths widen it here.
            x = _smooth(None, b.to(pd), lvl, cfg, cfg.pre_smooth, reverse=False)
            if not _fused_leg(levels, cfg, idx, b.device):
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
    if _fused_leg(levels, cfg, idx, b.device):
        # down: the residual restricted along x, y and z in one kernel
        # (K6); up: the correction prolonged along y, z and x and added in
        # one kernel (K7). No fine or half-size intermediate is stored.
        rc = residual_restrict_cuda(x, b, lvl.deltas)
        ec = _coarse_correct(levels, coarse_pinv, cfg, rc, idx + 1)
        x = prolong_add_cuda(x, ec)
    elif lvl.grid is not None:
        # a distributed level: the roll-form transfers on halo-padded
        # blocks, with a gather or a cut where the next level is replicated
        r = _residual(x, b, lvl, cfg)
        nxt = levels[idx + 1]
        ec = _coarse_correct(levels, coarse_pinv, cfg, _down(r, lvl, nxt), idx + 1)
        x = x + _up(ec, lvl, nxt)
    else:
        down, up = ((restrict_mm, prolong_mm)
                    if _transfers(cfg, b.device) == "matmul"
                    else (restrict, prolong))
        r = _residual(x, b, lvl, cfg)
        ec = _coarse_correct(levels, coarse_pinv, cfg, down(r), idx + 1)
        x = x + up(ec)
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


def auto_bf16_presmooth(cfg: MGConfig, shape: Sequence[int], dtype) -> bool:
    """True when the JAX package's 512^3-class default applies: a float32
    field of min(shape) >= 512 whose cycle and pre-smooth dtypes are left
    unset gets a bf16 pre-smooth."""
    return (not cfg.pre_dtype and not cfg.dtype and min(shape) >= 512
            and dtype == torch.float32)


def make_mg_preconditioner(
    shape: Sequence[int],
    deltas: Sequence[float],
    cfg: MGConfig = MGConfig(),
    dtype=torch.float64,
    device="cuda",
    grid=None,
) -> Callable[[Tensor], Tensor]:
    """Build M(r) ~= A^{-1} r, a cycle closure on `device` (the card
    unless the caller asks for "cpu").

    Setup (hierarchy + dense coarse pseudo-inverse) runs once here. The
    closure is linear and symmetric. Like the JAX package's, it exposes
    `config` (the resolved MGConfig), `apply_dots` (single cycle, field
    dtype) and, for SOR on kernel levels of one device, `apply_update_dots`;
    `resolved` names the transfer form and pre-smooth dtype `device`
    resolves to; `levels` the hierarchy.

    Pass `grid` (a Grid3D over a process grid) to run the fine levels
    distributed: M then takes and returns this rank's block, its device is
    the grid's, and `apply_dots` returns this rank's partial sums (CG
    all-reduces them). A fine level that runs replicated (its split
    extents odd) is gathered on the way in and cut on the way out.
    """
    distributed = grid is not None and grid.distributed
    if distributed:
        device = grid.device
    device = torch.device(device)
    cfg = _resolve_sweeps(cfg, shape)
    if auto_bf16_presmooth(cfg, shape, dtype):
        cfg = dataclasses.replace(cfg, pre_dtype="bfloat16")
    kernels = _kernels(cfg, device)        # both validate the options
    transfers = _transfers(cfg, device)
    levels = _build_levels(tuple(shape), tuple(deltas), cfg,
                           grid=grid if distributed else None)
    pinv = _coarse_pinv(levels[-1], cfg, dtype, device)
    cdt = _dtype(cfg.dtype)
    # a replicated fine level under a process grid: gather, cycle, cut
    gather0 = distributed and levels[0].grid is None

    def cycle(r: Tensor) -> Tensor:
        rin = r.to(cdt) if cdt is not None else r
        if gather0:
            rin = grid.unshard(rin)
        x = v_cycle(levels, pinv, cfg, rin)
        for _ in range(cfg.cycles - 1):
            x = x + v_cycle(levels, pinv, cfg, rin - _lapl(x, levels[0], cfg))
        if gather0:
            x = grid.shard(x)
        return x.to(r.dtype)

    def M(r: Tensor) -> Tensor:
        with span("PCApply", r):
            return cycle(r)

    M.config = cfg
    M.levels = levels
    M.resolved = {"transfers": transfers,
                  "pre_dtype": str(_dtype(cfg.pre_dtype) or cdt or dtype
                                   ).replace("torch.", "")}
    if cfg.cycles == 1 and cdt is None and len(levels) > 1:
        if gather0:
            def apply_dots(r: Tensor):
                with span("PCApply", r):
                    v = cycle(r)
                    return v, torch.sum(v * r), torch.sum(v)
        else:
            def apply_dots(r: Tensor):
                with span("PCApply", r):
                    return v_cycle(levels, pinv, cfg, r, dots=True)
        M.apply_dots = apply_dots

        pd0 = _dtype(cfg.pre_dtype)
        # a narrow pre-smooth qualifies when its single sweep is K5's and
        # the fine level's fused leg reads the narrow iterate
        pd_ok = (pd0 is None or pd0 == dtype
                 or (cfg.pre_smooth == 1 and _fused_leg(levels, cfg, 0, device)))
        if (cfg.smoother == "sor" and cfg.pre_smooth >= 1 and pd_ok and kernels
                and not distributed):
            # CG's residual update fused into the cycle's first kernel:
            # (r, Ap, alpha) -> (v, b, ||b||^2, sum(b), <b, v>, sum(v))
            # for b = r - alpha*Ap; with a narrow pre_dtype K5 stores the
            # swept iterate narrow while b stays in the field dtype
            w = 1.0 if cfg.damping is None else cfg.damping
            lvl0 = levels[0]
            xdt = pd0 if pd0 is not None and pd0 != dtype else None

            def apply_update_dots(r: Tensor, ap: Tensor, alpha):
                with span("PCApply", r), span(_LEVEL_SPANS[0]):
                    b_new, x, rr, sr = sor_rb_zero_update_cuda(
                        r, ap, alpha, lvl0.deltas, w, out_dtype=xdt)
                    if cfg.pre_smooth > 1:
                        with span("MGSmooth"):
                            x = sor_rb_multisweep_cuda(x, b_new, lvl0.deltas, w,
                                                       cfg.pre_smooth - 1)
                    v, rv, sv = _v_cycle_rest(levels, pinv, cfg, x, b_new, 0,
                                              dots=True)
                return v, b_new, rr, sr, rv, sv
            M.apply_update_dots = apply_update_dots
    return M
