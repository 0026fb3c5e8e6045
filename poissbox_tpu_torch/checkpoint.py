"""Checkpoint and resume of long solves (port of the single-host numpy
branch of :mod:`poissbox_tpu.checkpoint`).

Solver state (iterate, right-hand side, iteration count, residual norm)
goes to an ``.npz`` file; tensors cross as numpy arrays and come back on
an explicit device (the card unless the caller asks for "cpu"). Resuming
a Krylov solve from the saved iterate is mathematically clean: the solve
restarted from x0 continues to the same stopping point, since the
residual target stays relative to ||b||.

    state = SolveCheckpoint.from_result(result, b=b)
    save(path, state.as_dict())
    ...
    st = load(path, device="cuda")
    res = cg(A, st["b"], x0=st["x"], ...)

Across ranks each rank saves its owned box and nothing is gathered (the
JAX package refuses its gathering fallback on several hosts for the same
reason): one file a rank under `path` (:func:`checkpoint_path`), each
with the box's offset and shape beside the state. Every file is written
under a temporary name and renamed into place, so a kill leaves the last
complete file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save(path: str, state: Mapping[str, Any]) -> str:
    """Save a dict of tensors (or numbers) to `path`.npz, written under a
    temporary name and renamed into place; returns the file name."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.npz.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{k: _numpy(v) for k, v in state.items()})
    os.replace(tmp, path + ".npz")
    return path + ".npz"


def checkpoint_path(path: str, grid=None) -> str:
    """Where this rank's checkpoint of `path` lives (without ".npz"):
    `path` itself on one rank; over a process grid of more than one rank
    one file a rank under the directory `path`, named by rank and world
    size (``rank1of4``)."""
    if grid is None or not grid.distributed:
        return path
    return os.path.join(path, f"rank{grid.mesh.rank}of{grid.mesh.size}")


def resume_verdict(ok: bool, iterations: int, allreduce_max=None,
                   device="cpu") -> bool:
    """Whether to resume, the same on every rank: this rank's own verdict
    (`ok`: its file exists, holds its box and this b exactly) and its
    saved iteration count, reduced by `allreduce_max` (the maximum of a
    1-D tensor over every rank; None on one rank). All ranks resume only
    if every one may and all saved the same count (a kill between two
    ranks' writes leaves files of different chunks); else all start
    fresh."""
    if allreduce_max is None:
        return ok
    v = allreduce_max(torch.tensor([0.0 if ok else 1.0, iterations, -iterations],
                                   dtype=torch.float64, device=device)).tolist()
    return v[0] == 0.0 and v[1] == -v[2]


def load(path: str, device="cuda") -> dict:
    """Load a checkpoint written by :func:`save` as tensors on `device`."""
    path = os.path.abspath(path)
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as data:
        return {k: torch.as_tensor(v, device=device) for k, v in data.items()}


@dataclasses.dataclass
class SolveCheckpoint:
    """Typed view of resumable solver state."""

    x: torch.Tensor
    b: torch.Tensor
    iterations: int
    residual_norm: float

    @classmethod
    def from_result(cls, result, b: torch.Tensor) -> "SolveCheckpoint":
        return cls(x=result.x, b=b, iterations=int(result.iterations),
                   residual_norm=float(result.residual_norm))

    def as_dict(self) -> dict:
        return {"x": self.x, "b": self.b,
                "iterations": torch.tensor(self.iterations, dtype=torch.int32),
                "residual_norm": torch.tensor(self.residual_norm,
                                              dtype=torch.float64)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SolveCheckpoint":
        return cls(x=d["x"], b=d["b"], iterations=int(d["iterations"]),
                   residual_norm=float(d["residual_norm"]))


def solve_with_checkpoints(
    A,
    b: torch.Tensor,
    path: str,
    *,
    M=None,
    rtol: float = 1.0e-6,
    atol: float = 1.0e-50,
    max_it: int = 500,
    every: int = 25,
    solver=None,
    on_chunk=None,
    grid=None,
):
    """Krylov solve in chunks of `every` iterations, with (x, b,
    iterations, residual_norm) saved to `path` after each chunk; a killed
    run resumes from `path` and loses at most `every` iterations.

    A checkpoint is resumed only when its b equals this b exactly (shape,
    dtype and every element): a right-hand side that differs in one
    element by one ulp is another problem and starts fresh. `on_chunk(
    chunk_index, result)` is called after each save (tests inject a kill
    there). Returns (SolveResult, total_iterations), the total counting the
    resumed run's saved iterations.

    Over a process grid (`A` on rank blocks) pass the `grid`: each rank
    saves its box to its own file (:func:`checkpoint_path`) and checks on
    load that the file holds this box and this b; the verdict is
    all-reduced (:func:`resume_verdict`), so every rank resumes or every
    rank starts fresh.
    """
    from poissbox_tpu_torch.solvers.cg import cg
    from poissbox_tpu_torch.solvers.result import ConvergedReason

    distributed = grid is not None and grid.distributed
    if getattr(A, "allreduce", None) is not None and not distributed:
        raise ValueError("a solve on rank blocks saves each rank's box: pass "
                         "the grid over its process grid")
    file = checkpoint_path(path, grid)
    box = {}
    if distributed:
        box = {"offset": torch.tensor(grid.offset), "shape": torch.tensor(grid.local_shape)}
    solver = solver or cg
    done_before = 0
    x0 = None
    ok, saved, st = False, -1, None
    try:
        data = load(file, device=b.device)
        st = SolveCheckpoint.from_dict(data)
        saved = st.iterations
        ok = (st.b.shape == b.shape and st.b.dtype == b.dtype
              and torch.equal(st.b, b)
              and all(torch.equal(data[k].cpu(), v) for k, v in box.items()))
    except (FileNotFoundError, KeyError, OSError):
        pass
    if distributed:
        ok = resume_verdict(ok, saved, A.allreduce_max, device=b.device)
    if ok:
        x0 = st.x
        done_before = st.iterations

    total = done_before
    result = None
    chunk = 0
    while total < max_it:
        it = min(every, max_it - total)
        result = solver(A, b, x0, M=M, rtol=rtol, atol=atol, max_it=it)
        total += int(result.iterations)
        save(file, {**SolveCheckpoint(
            x=result.x, b=b, iterations=total,
            residual_norm=float(result.residual_norm)).as_dict(), **box})
        if on_chunk is not None:
            on_chunk(chunk, result)
        chunk += 1
        if int(result.reason) > 0:          # CONVERGED_*
            break
        if int(result.reason) != int(ConvergedReason.DIVERGED_MAX_IT):
            break                           # breakdown: surface it
        x0 = result.x
    return result, total
