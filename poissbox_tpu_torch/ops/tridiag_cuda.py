"""Batched tridiagonal solves on Hopper: K13 (Thomas) and K14 (circulant
PCR) — the port of :mod:`poissbox_tpu.ops.tridiag_pallas`.

:class:`CudaTridiagFactor` mirrors ``PallasTridiagFactor``: a fixed
(a, b, c) system, periodic or not, factored once, then ``solve(d, axis)``
on any batch. The line axis moves to the front and the batch flattens to
(n, B) — no copy for a contiguous 3-D field solved along axis 0 — and the
result is moved back.

  * ``algorithm="thomas"`` (K13, ``csrc/tridiag.cu``): one thread per
    line, forward sweep, back substitution and the periodic rank-1
    correction in one launch; the factor vectors come from the port's
    :mod:`~poissbox_tpu_torch.ops.tridiag` in the JAX package's order.
  * ``algorithm="pcr"`` (K14): the circulant PCR solve d <- d*scale, then
    the truncated schedule, on K15's line kernel (``csrc/compact.cu``)
    with its RHS taps off. Only periodic, constant, symmetric, diagonally
    dominant systems qualify.
  * ``algorithm="auto"``: PCR for every qualifying system with n >= 4
    (the schedule is n-agnostic; the JAX package's Mosaic-safe extent gate
    has no counterpart here), Thomas for everything else.
  * ``algorithm="babe"`` (K16, the twisted factorization) is not ported.

The fused compact-RHS Thomas entry points of the JAX module
(``solve_compact``, ``compact_dual``, ``compact_chain``, ``compact_sum``:
K17) are not ported: the compact stack runs on K15 for every n here.

A CPU tensor runs the plain versions (:func:`thomas_plain`,
``compact_pcr._vop``); a CUDA tensor launches the kernel or raises.
Launches count in :data:`poissbox_tpu_torch.ops.stencil_cuda.LAUNCHES` as
``tridiag.thomas`` and ``tridiag.pcr``.
"""

from __future__ import annotations

import torch

from poissbox_tpu_torch.ops import _build, compact_pcr
from poissbox_tpu_torch.ops.stencil_cuda import (
    DTYPE_CODE,
    LAUNCHES,
    _ptr,
    _raise_on,
    _stream,
)
from poissbox_tpu_torch.ops.tridiag import TridiagFactor

Tensor = torch.Tensor


def thomas_plain(w, binv, cb, corr, d: Tensor) -> Tensor:
    """K13's plain version on a (n, B) RHS: the Pallas kernel's row loop
    (`_thomas_kernel`, `_bwd_and_corr`)."""
    n = d.shape[0]
    rows = [d[0]]
    for i in range(1, n):
        rows.append(d[i] - w[i] * rows[i - 1])
    rows[n - 1] = rows[n - 1] * binv[n - 1]
    for i in range(n - 2, -1, -1):
        rows[i] = rows[i] * binv[i] - cb[i] * rows[i + 1]
    if float(corr[1]) != 0.0:
        factor = (rows[0] + corr[0] * rows[n - 1]) * corr[1]
        rows = [rows[i] - corr[2 + i] * factor for i in range(n)]
    return torch.stack(rows)


class CudaTridiagFactor:
    """The Hopper counterpart of ``PallasTridiagFactor``: solves along
    `axis` of any RHS; ``algorithm`` is "auto", "thomas" or "pcr"."""

    def __init__(self, a, b, c, periodic: bool, algorithm: str = "auto"):
        a, b, c = torch.broadcast_tensors(*(torch.as_tensor(v) for v in (a, b, c)))
        self.n = b.shape[0]
        self.dtype = b.dtype
        self.periodic = periodic
        if algorithm == "babe":
            raise NotImplementedError(
                "algorithm='babe' (K16, the twisted factorization) is not "
                "ported yet; see ROADMAP.md")
        if algorithm == "auto":
            algorithm = "pcr" if self._pcr_eligible(a, b, c, periodic) else "thomas"
        if algorithm not in ("thomas", "pcr"):
            raise ValueError(f"unknown tridiag algorithm {algorithm!r}")
        self.algorithm = algorithm
        if algorithm == "pcr":
            if not self._pcr_eligible(a, b, c, periodic):
                raise ValueError("pcr needs a periodic constant symmetric "
                                 "diagonally dominant system of n >= 4")
            av, bv = float(a[0]), float(b[0])
            sched = compact_pcr.pcr_schedule(
                av / bv, self.n, compact_pcr._dtype_rtol(self.dtype))
            self.pcr_spec = compact_pcr.solve_spec(1.0 / bv, sched)
        else:
            self._thomas_setup(a, b, c, periodic)
        self._dev = {}

    def _thomas_setup(self, a, b, c, periodic: bool) -> None:
        """Factor vectors w, binv, cb, corr, in the coefficients' dtype
        (the JAX package's `_thomas_setup`), from the plain stack's
        factorization and Sherman–Morrison vector."""
        ref = TridiagFactor(a, b, c, periodic, method="seq")
        self.w = ref.w
        self.binv = 1.0 / ref.bmod
        cb = c * self.binv
        cb[-1] = 0.0
        self.cb = cb
        if periodic:
            self.corr = torch.cat([torch.stack([ref.alpha_ratio, 1.0 / ref.denom]),
                                   ref.usol])
        else:
            self.corr = torch.zeros(self.n + 2, dtype=b.dtype)

    def _factors(self, device) -> tuple[Tensor, ...]:
        """(w, binv, cb, corr) on `device`, copied there once."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(v.to(device=device, dtype=self.dtype)
                                   .contiguous()
                                   for v in (self.w, self.binv, self.cb, self.corr))
        return self._dev[key]

    @staticmethod
    def _pcr_eligible(a, b, c, periodic: bool) -> bool:
        """Periodic, constant, symmetric, diagonally dominant, n >= 4."""
        if not periodic or b.shape[0] < 4:
            return False
        const = bool((a == a[0]).all() and (b == b[0]).all()
                     and (c == c[0]).all() and a[0] == c[0])
        return const and 2.0 * abs(float(a[0])) < abs(float(b[0]))

    def _solve_lines(self, d2: Tensor, plain: bool) -> Tensor:
        """Solve along axis 0 of the contiguous (n, B) RHS."""
        if self.algorithm == "pcr":
            if plain or d2.device.type == "cpu":
                return compact_pcr._vop(d2, 0, self.pcr_spec)
            (x,) = compact_pcr.sweep((((0, (self.pcr_spec,)),),), [d2], 0,
                                     key="tridiag.pcr")
            return x
        w, binv, cb, corr = self._factors(d2.device)
        if plain or d2.device.type == "cpu":
            return thomas_plain(w, binv, cb, corr, d2)
        if d2.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the Thomas kernel takes float32 or float64, not "
                            f"{str(d2.dtype).replace('torch.', '')}")
        x = torch.empty_like(d2)
        lib = _build.load()
        err = lib.poissbox_thomas(
            DTYPE_CODE[d2.dtype], d2.device.index or 0, _stream(d2), _ptr(d2),
            _ptr(x), _ptr(w), _ptr(binv), _ptr(cb), _ptr(corr), self.n,
            d2.shape[1])
        _raise_on(lib, err, "tridiag.thomas")
        LAUNCHES["tridiag.thomas"] += 1
        return x

    def solve(self, d: Tensor, axis: int = 0, *, plain: bool = False) -> Tensor:
        """Solve along `axis` of an (arbitrarily batched) RHS; the result
        has d's shape, in the factor's dtype. `plain` runs the plain
        version on any device (what chip_smoke.py holds the kernel to)."""
        axis %= d.dim()
        if d.shape[axis] != self.n:
            raise ValueError(f"RHS has {d.shape[axis]} rows along axis {axis}, "
                             f"the system {self.n}")
        moved = d.movedim(axis, 0)
        rest = moved.shape[1:]
        d2 = moved.reshape(self.n, -1).to(self.dtype).contiguous()
        x = self._solve_lines(d2, plain)
        return x.reshape((self.n,) + tuple(rest)).movedim(0, axis).contiguous()
