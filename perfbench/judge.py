"""The comparison that decides ``correct``.

Every solve of the window has to stop converged (PETSc's positive
reasons). A sample of them, drawn from the seed (one solve of each pool
slot, by reservoir sampling over the slot's solves), is judged by the
reference once the window has closed, with b the right-hand side the
solver was handed and every operation in float64. The traffic file's
"limits" name the numbers a cell compares, each the worst over the
sample:

  * ``residual``: the true relative residual ||A x - b|| / ||b|| of the
    x the timed path returned (A the reference operator); its limit is
    the rtol the configuration states;
  * ``error``: ||x - x*|| / ||x*||, x* the reference's exact spectral
    solve and x's mean removed: what a direct solve promises;
  * ``residual_gap``: | the residual norm the solve reported - the
    reference's ||P b - A x|| | / ||b||, which holds the program's own
    operator (applied to form its residual) to the reference's.

The count of unconverged solves has the limit 0. PERF.md gives the
readings each limit was set from.
"""

from __future__ import annotations

import math
import random
import sys

NOT_FINITE = 1.0e300


class Sampler:
    """Reservoir sampling of one solve a pool slot: solve i of slot
    i % pool replaces the kept one with probability 1 / (its cycle + 1),
    the draws from the seed."""

    def __init__(self, seed: int, pool: int):
        self.rng = random.Random(int(seed))
        self.pool = pool
        self.kept: dict[int, tuple[int, object]] = {}

    def offer(self, i: int, x) -> None:
        slot, cycle = i % self.pool, i // self.pool
        if self.rng.random() * (cycle + 1) < 1.0:
            self.kept[slot] = (i, x)


def judge_solve(order: int, x, reported, b, deltas, limits: dict) -> dict:
    """The numbers `limits` names, for one solve."""
    from perfbench.reference import operators
    out = {}
    if "residual" in limits or "residual_gap" in limits:
        rnorm, bnorm = operators.residual_norms(order, x, b, deltas)
        out["residual"] = rnorm / bnorm
        out["residual_gap"] = abs(float(reported) - rnorm) / bnorm
    if "error" in limits:
        out["error"] = operators.relative_error(order, x, b, deltas)
    return {k: v for k, v in out.items() if k in limits}


def _worst(values: list) -> float:
    # a number that is not finite, or none judged, reads as 1e300 (JSON
    # has no infinity)
    return max((v if math.isfinite(v) else NOT_FINITE for v in values), default=NOT_FINITE)


def numbers(judged: list[dict], reasons: list, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers compared."""
    out = {name: {"value": _worst([j[name] for j in judged]), "limit": lim}
           for name, lim in limits.items()}
    out["unconverged"] = {"value": sum(1 for c in reasons if c <= 0), "limit": 0}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def failed_count(judged: list[dict], reasons: list, limits: dict) -> int:
    """Solves that failed: not converged, or sampled and over a limit."""
    over = sum(1 for j in judged if not all(j[k] <= lim for k, lim in limits.items()))
    return sum(1 for c in reasons if c <= 0) + over


def print_checks(checks: dict) -> None:
    """The numbers compared beside their limits, as the last lines of
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
