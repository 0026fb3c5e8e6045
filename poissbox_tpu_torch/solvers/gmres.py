"""Restarted GMRES — PETSc's default KSP type, reached whenever
`-ksp_type` is not given (port of :mod:`poissbox_tpu.solvers.gmres`).

Left-preconditioned GMRES(m) with a zero-padded (m+1, *field) Krylov basis
on the device, Gram-Schmidt against the whole basis in two products (as
the JAX package's `tensordot`s), and Givens rotations. The JAX package
masks the steps of a cycle after convergence inside a fixed-length
`fori_loop`; here the host loop stops the cycle at the first masked step,
which gives the same history and iteration count. Each step copies the
new Hessenberg column (m + 2 numbers) to the host, which is the loop's one
synchronisation; the rotations and the triangular solve run there, in the
field dtype.

Over a process grid (``A.allreduce``) the fields are rank blocks and the
basis holds this rank's block of every vector: the initial norms go out
in one all-reduce, a restart's norm in one, and a Gram-Schmidt step takes
two, as the JAX package's two psums: the local coefficients h = V w (with
K2's partial <V_j, A V_j> stacked on them on the fused path), then
||w - h V||^2. Every rank then holds the same column, so the host's
rotations and every stopping decision agree; the restart length is agreed
too (:func:`clamp_restart`).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from poissbox_tpu_torch.linops import LinearOperator
from poissbox_tpu_torch.mesh import ranks_on_device
from poissbox_tpu_torch.solvers.cg import _dot, _monitor_print, _sums
from poissbox_tpu_torch.solvers.mg import _full_fp32_matmul
from poissbox_tpu_torch.solvers.result import SolveResult, classify
from poissbox_tpu_torch.utils import debugging
from poissbox_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _basis_budget_bytes(device=None) -> int:
    """Device-memory budget for the Krylov basis: a quarter of the card's
    memory, shared by the ranks on that card, 4 GiB elsewhere. The
    (m+1, *field) basis is GMRES's dominant allocation; the rest is left
    to the operator and the preconditioner."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.mem_get_info(device)[1] // 4 // ranks_on_device(device)
    return 4 << 30


def clamp_restart(restart: int, b: Tensor, budget_bytes=None,
                  allreduce_max=None) -> int:
    """Shrink the restart length so that the stacked basis fits the
    budget, with a warning (more restarts, same convergence semantics).
    At 512^3 f32, GMRES(30) needs 31 fields, 16.6 GB.

    Over a process grid pass the operator's `allreduce_max`: every rank
    then takes the largest box against the smallest budget, so all take
    the same length (a rank that restarted alone would leave the others
    in the next all-reduce) and warn alike."""
    budget = (_basis_budget_bytes(b.device) if budget_bytes is None
              else int(budget_bytes))
    field = b.numel() * b.element_size()
    if allreduce_max is not None:
        v = allreduce_max(torch.tensor([field, -budget], dtype=torch.float64,
                                       device=b.device))
        field, budget = int(v[0]), -int(v[1])
    max_m = max(1, budget // max(field, 1) - 1)
    if restart > max_m:
        warnings.warn(
            f"gmres: restart {restart} needs {(restart + 1) * field / 2**30:.1f}"
            f" GiB of Krylov basis (> {budget / 2**30:.1f} GiB budget); "
            f"shrunk to restart={max_m}", RuntimeWarning, stacklevel=3)
        return max_m
    return restart


def gmres(
    A: LinearOperator,
    b: Tensor,
    x0: Optional[Tensor] = None,
    *,
    M: Optional[Callable[[Tensor], Tensor]] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 1000,
    restart: int = 30,
    monitor: bool = False,
) -> SolveResult:
    """Solve A x = b by left-preconditioned restarted GMRES(restart).

    Convergence is monitored on the preconditioned residual norm (PETSc's
    default for left preconditioning), relative to ||M b||; the history
    has one entry per inner iteration. As in the JAX package, a cycle runs
    to its end (or convergence) even past `max_it`; its later entries
    fall off the end of the history.
    """
    reduce = getattr(A, "allreduce", None)
    m = clamp_restart(int(restart), b,
                      allreduce_max=getattr(A, "allreduce_max", None)
                      if reduce is not None else None)
    x = torch.zeros_like(b) if x0 is None else x0
    b = A.project(b)
    x = A.project(x)
    precond = M if M is not None else (lambda v: v)
    ft = _NP[b.dtype]

    def pres(v: Tensor) -> Tensor:
        return A.project(precond(v))

    with span("MatMult"):
        r0 = b - A(x)
    r0 = pres(r0)
    pb = pres(b)
    rr0, pbb = _sums(reduce, _dot(r0, r0), _dot(pb, pb))
    rnorm0_t, bnorm_t = torch.sqrt(rr0), torch.sqrt(pbb)
    with span("KSPSync"):
        rnorm0, bnorm = ft(rnorm0_t.item()), ft(bnorm_t.item())
    debugging.check_norm(rnorm0, "gmres", 0)
    hist = [rnorm0]
    if monitor:
        _monitor_print(0, rnorm0)
    tiny = ft(np.finfo(ft).tiny)
    target = max(ft(rtol) * bnorm, ft(atol))
    use_fused = M is None and A.apply_dot is not None

    # the zero-padded basis: rows past the current step are zero, so the
    # whole-basis products see only the vectors built so far
    V = torch.zeros((m + 1,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    Vf = V.view(m + 1, -1)
    resnorm, k = rnorm0, 0
    r, beta_t = r0, rnorm0_t
    while resnorm > target and np.isfinite(resnorm) and k < max_it:
        if r is None:
            # a restart: the true preconditioned residual, a clean basis
            with span("MatMult"):
                r = b - A(x)
            r = pres(r)
            rr, = _sums(reduce, _dot(r, r))
            beta_t = torch.sqrt(rr)
            V.zero_()
        torch.div(r, torch.clamp(beta_t, min=float(tiny)), out=V[0])
        with span("KSPSync"):
            beta = ft(beta_t.item())
        H = np.zeros((m + 1, m), dtype=ft)
        cs = np.zeros(m, dtype=ft)
        sn = np.zeros(m, dtype=ft)
        g = np.zeros(m + 1, dtype=ft)
        g[0] = beta
        resnorm, jdone = beta, 0
        debugging.check_norm(resnorm, "gmres", k)
        for j in range(m):
            if not resnorm > target:
                break            # the JAX package's masked steps
            with span("KSPIteration"):
                if use_fused:
                    # unpreconditioned: K2 returns <V_j, A V_j>, the j-th
                    # Gram-Schmidt coefficient (V_j is mean-free, so the
                    # projection does not change it)
                    with span("MatMult"):
                        Av, vAv = A.apply_dot(V[j])
                    w = A.project(Av)
                else:
                    with span("MatMult"):
                        w = A(V[j])
                    w = pres(w)
                with _full_fp32_matmul():
                    h = Vf @ w.reshape(-1)
                    if reduce is not None:
                        # this rank's coefficients (and K2's partial) summed
                        # over every rank in one all-reduce
                        h = reduce(torch.cat([h, vAv.reshape(1)]) if use_fused else h)
                        if use_fused:
                            h, vAv = h[:-1], h[-1]
                    if use_fused:
                        h[j] = vAv
                    w = w - (h @ Vf).view(b.shape)
                ww, = _sums(reduce, _dot(w, w))
                hnext_t = torch.sqrt(ww)
                torch.div(w, torch.clamp(hnext_t, min=float(tiny)), out=V[j + 1])
                with span("KSPSync"):
                    col = torch.cat([h, hnext_t.reshape(1)]).cpu().numpy().astype(ft)
                hcol = col[:m + 1].copy()
                hcol[j + 1] = col[m + 1]
                # the accumulated rotations on the new column
                for i in range(j):
                    hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                    hip = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                    hcol[i], hcol[i + 1] = hi, hip
                denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                cs[j] = hcol[j] / max(denom, tiny)
                sn[j] = hcol[j + 1] / max(denom, tiny)
                hcol[j] = cs[j] * hcol[j] + sn[j] * hcol[j + 1]
                hcol[j + 1] = 0.0
                gj = g[j]
                g[j] = cs[j] * gj
                g[j + 1] = -sn[j] * gj
                resnorm = abs(g[j + 1])
                H[:, j] = hcol
                jdone = j + 1
                k += 1
                debugging.check_norm(resnorm, "gmres", k)
                if k <= max_it:
                    hist.append(resnorm)
                if monitor:
                    _monitor_print(k, resnorm)
        # the upper-triangular system H[:j, :j] y = g[:j] of the steps taken
        y = np.zeros(m, dtype=ft)
        if jdone:
            y[:jdone] = torch.linalg.solve_triangular(
                torch.from_numpy(H[:jdone, :jdone]),
                torch.from_numpy(g[:jdone, None]), upper=True)[:, 0].numpy()
        yt = torch.from_numpy(y).to(b.device)
        with _full_fp32_matmul():
            dx = (yt @ Vf[:m]).view(b.shape)
        x = A.project(x + dx)
        r = None

    hist_t = torch.full((max_it + 1,), float("nan"), dtype=b.dtype,
                        device=b.device)
    hist_t[:len(hist)] = torch.tensor(np.asarray(hist, dtype=ft),
                                      device=b.device)
    resnorm_t = torch.tensor(resnorm, dtype=b.dtype, device=b.device)
    rtol_ = torch.tensor(rtol, dtype=b.dtype, device=b.device)
    atol_ = torch.tensor(atol, dtype=b.dtype, device=b.device)
    reason = classify(resnorm_t, k, bnorm_t, rtol_, atol_, max_it)
    return SolveResult(x, torch.tensor(k, dtype=torch.int32), resnorm_t,
                       hist_t, reason)
