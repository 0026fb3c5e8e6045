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
    """Save a dict of tensors (or numbers) to `path`.npz; returns the file
    name."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path + ".npz", **{k: _numpy(v) for k, v in state.items()})
    return path + ".npz"


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
    """
    from poissbox_tpu_torch.solvers.cg import cg
    from poissbox_tpu_torch.solvers.result import ConvergedReason

    solver = solver or cg
    done_before = 0
    x0 = None
    try:
        st = SolveCheckpoint.from_dict(load(path, device=b.device))
        if (st.b.shape == b.shape and st.b.dtype == b.dtype
                and torch.equal(st.b, b)):
            x0 = st.x
            done_before = st.iterations
    except (FileNotFoundError, KeyError, OSError):
        pass

    total = done_before
    result = None
    chunk = 0
    while total < max_it:
        it = min(every, max_it - total)
        result = solver(A, b, x0, M=M, rtol=rtol, atol=atol, max_it=it)
        total += int(result.iterations)
        save(path, SolveCheckpoint(
            x=result.x, b=b, iterations=total,
            residual_norm=float(result.residual_norm)).as_dict())
        if on_chunk is not None:
            on_chunk(chunk, result)
        chunk += 1
        if int(result.reason) > 0:          # CONVERGED_*
            break
        if int(result.reason) != int(ConvergedReason.DIVERGED_MAX_IT):
            break                           # breakdown: surface it
        x0 = result.x
    return result, total
