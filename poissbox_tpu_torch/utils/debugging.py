"""Runtime checking — the `-fcheck=all -ffpe-trap` analogue (port of
:mod:`poissbox_tpu.utils.debugging`).

The reference's Debug build traps FPEs and bounds errors at compile-flag
level. Here: explicit field validation (shape, dtype, finiteness) and a
switch that makes the Krylov loops raise on a non-finite residual norm.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from poissbox_tpu_torch.utils.profiling import span

_nan_checks = False


def enable_nan_checks(enable: bool = True) -> None:
    """Make the Krylov loops (``solvers/cg.py``, ``pipecg.py``,
    ``gmres.py``, ``richardson.py``) raise ``FloatingPointError``, naming
    the method and the iteration, when the residual norm they monitor is
    NaN or Inf.

    The JAX package sets ``jax_debug_nans``, which checks the output of
    every jitted computation and raises where a NaN is first produced, at a
    large cost. Torch has no such switch, so the port checks the one value
    each loop already reads every step: the stopping test, which with the
    flag on also carries whether the norm is finite. No device sync is
    added, on or off. A NaN that a step produces shows at the next norm, so
    the error names the iteration that reads it, not the kernel that made
    it; a non-finite field whose norm stays finite is not caught (use
    :func:`check_field`).
    """
    global _nan_checks
    _nan_checks = bool(enable)


def nan_checks_enabled() -> bool:
    return _nan_checks


def _nonfinite(method: str, k: int) -> FloatingPointError:
    return FloatingPointError(f"{method}: the residual norm is NaN or Inf at "
                              f"iteration {k} (NaN checks are on)")


def proceed(go: torch.Tensor, norm: torch.Tensor, method: str, k: int) -> bool:
    """A Krylov loop's one read a step, the span `KSPSync`: whether the
    device boolean `go` holds. With NaN checks on, the same read carries
    whether `norm` is finite, and raises FloatingPointError where it is
    not."""
    with span("KSPSync"):
        if not _nan_checks:
            return bool(go.item())
        code = int(torch.where(torch.isfinite(norm), go.to(torch.int8), -1).item())
    if code < 0:
        raise _nonfinite(method, k)
    return code == 1


def check_norm(norm: float, method: str, k: int) -> None:
    """With NaN checks on, raise FloatingPointError when a residual norm
    that the loop holds on the host is not finite."""
    if _nan_checks and not math.isfinite(float(norm)):
        raise _nonfinite(method, k)


def check_field(f: torch.Tensor, shape: Optional[Sequence[int]] = None,
                dtype: Optional[torch.dtype] = None, finite: bool = True,
                name: str = "field") -> torch.Tensor:
    """Validate a field eagerly; returns it unchanged (chainable).

    Host-side (synchronises when finite=True): use at API boundaries and in
    tests, not on a hot path.
    """
    if shape is not None and tuple(f.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(f.shape)} != expected {tuple(shape)}")
    if dtype is not None and f.dtype != dtype:
        raise TypeError(f"{name}: dtype {f.dtype} != expected {dtype}")
    if finite and not bool(torch.isfinite(f).all()):
        raise FloatingPointError(f"{name}: contains NaN/Inf")
    return f
