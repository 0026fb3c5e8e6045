"""Conversions between numpy arrays and the port's tensors.

Fields cross between the JAX package and the port as numpy arrays (the
tests hand the same seeded inputs to both). A :class:`SolveResult`
converts field by field. The solver has no trained weights: its only
setup state, the coarse-grid pseudo-inverse, is computed by the same
numpy code in both packages (solvers.mg._coarse_pinv).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from poissbox_tpu_torch.solvers.result import SolveResult

_FIELDS = SolveResult._fields   # x, iterations, residual_norm, history, reason


def to_torch(a, device="cpu", dtype=None) -> torch.Tensor:
    """A numpy array (or anything np.asarray takes) as a tensor (a copy:
    arrays that come from JAX are read-only)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def solve_result_to_numpy(res: SolveResult) -> dict[str, np.ndarray]:
    return {f: to_numpy(getattr(res, f)) for f in _FIELDS}


def solve_result_from_numpy(src: Mapping[str, Any] | Any,
                            device="cpu") -> SolveResult:
    """A SolveResult from a mapping of arrays or from any result object
    with the same fields (the JAX package's SolveResult included)."""
    get = src.__getitem__ if isinstance(src, Mapping) else lambda f: getattr(src, f)
    x, hist = (to_torch(get(f), device) for f in ("x", "history"))
    return SolveResult(
        x=x,
        iterations=to_torch(get("iterations"), dtype=torch.int32),
        residual_norm=to_torch(get("residual_norm"), device, x.dtype),
        history=hist,
        reason=to_torch(get("reason"), device, torch.int32),
    )
