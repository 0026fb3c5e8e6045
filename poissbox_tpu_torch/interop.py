"""Conversions between numpy arrays and the port's tensors.

Fields cross between the JAX package and the port as numpy arrays (the
tests hand the same seeded inputs to both). A :class:`SolveResult`, a
:class:`RefineResult` and a checkpoint's state dict convert field by
field. The solver has no trained weights: its only
setup state, the coarse-grid pseudo-inverse, is computed by the same
numpy code in both packages (solvers.mg._coarse_pinv).

Across ranks a field is each rank's owned box: :func:`shard_numpy` cuts a
rank's box out of a global numpy field, :func:`unshard_numpy` gathers the
global field back, and :func:`rank_blocks` / :func:`assemble_blocks` split
a global field (a JAX package's sharded array included: it converts with
``np.asarray``) into the per-rank blocks, in rank order, and put them
back together, without a process group.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from poissbox_tpu_torch.parallel.decomp import owned_boxes
from poissbox_tpu_torch.solvers.refine import RefineResult
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


def _getter(src):
    return src.__getitem__ if isinstance(src, Mapping) else lambda f: getattr(src, f)


def refine_result_to_numpy(res: RefineResult) -> dict[str, Any]:
    """Arrays for x, residual_norm and history; ints for the counts."""
    return {f: (v if isinstance(v, int) else to_numpy(v))
            for f, v in res._asdict().items()}


def refine_result_from_numpy(src: Mapping[str, Any] | Any,
                             device="cpu") -> RefineResult:
    """A RefineResult from a mapping or from any result object with the
    same fields (the JAX package's RefineResult included)."""
    get = _getter(src)
    return RefineResult(
        x=to_torch(get("x"), device),
        outer_iterations=int(get("outer_iterations")),
        inner_iterations=int(get("inner_iterations")),
        residual_norm=to_torch(get("residual_norm"), device, torch.float64),
        history=to_torch(get("history"), device, torch.float64),
    )


def checkpoint_to_numpy(state: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A checkpoint state dict (x, b, iterations, residual_norm) as numpy
    arrays, the form both packages' npz files hold."""
    return {k: to_numpy(v) if torch.is_tensor(v) else np.asarray(v)
            for k, v in state.items()}


def checkpoint_from_numpy(state: Mapping[str, Any], device="cpu") -> dict:
    """A checkpoint state dict of arrays (the JAX package's included) as
    tensors on `device`."""
    return {k: to_torch(v, device) for k, v in state.items()}


def shard_numpy(a, grid, dtype=None) -> torch.Tensor:
    """This rank's owned box of the global field `a` (anything np.asarray
    takes), on the grid's device."""
    t = grid.shard(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def unshard_numpy(t: torch.Tensor, grid) -> np.ndarray:
    """The global field gathered from every rank's block, as numpy (a
    collective: every rank calls it)."""
    return to_numpy(grid.unshard(t))


def rank_blocks(a, shape, pgrid) -> list[np.ndarray]:
    """The owned boxes of the global field `a` on process grid `pgrid`,
    in rank order (C order over the process coordinates)."""
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"expected a field of shape {tuple(shape)}, got {a.shape}")
    return [a[xs:xs + xn, ys:ys + yn, zs:zs + zn].copy()
            for _, ((xs, ys, zs), (xn, yn, zn))
            in sorted(owned_boxes(shape, pgrid).items())]


def assemble_blocks(blocks, shape, pgrid) -> np.ndarray:
    """The global field from its per-rank blocks (rank order)."""
    boxes = [box for _, box in sorted(owned_boxes(shape, pgrid).items())]
    if len(blocks) != len(boxes):
        raise ValueError(f"{len(blocks)} blocks for {len(boxes)} ranks")
    out = np.empty(tuple(shape), dtype=np.asarray(blocks[0]).dtype)
    for blk, ((xs, ys, zs), (xn, yn, zn)) in zip(blocks, boxes):
        out[xs:xs + xn, ys:ys + yn, zs:zs + zn] = np.asarray(blk)
    return out
