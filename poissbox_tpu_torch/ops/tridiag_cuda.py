"""Batched tridiagonal solves on Hopper: K13 (Thomas), K14 (circulant
PCR), K16 (the twisted factorization) and K17 (the compact RHS fused into
the Thomas sweeps) — the port of :mod:`poissbox_tpu.ops.tridiag_pallas`.

:class:`CudaTridiagFactor` mirrors ``PallasTridiagFactor``: a fixed
(a, b, c) system, periodic or not, factored once, then ``solve(d, axis)``
on any batch. The line axis moves to the front and the batch flattens to
(n, B) — no copy for a contiguous 3-D field solved along axis 0 — and the
result is moved back.

  * ``algorithm="thomas"`` (K13, ``csrc/tridiag.cu``): one thread per
    line, forward sweep, back substitution and the periodic rank-1
    correction in one launch; the factor vectors come from the port's
    :mod:`~poissbox_tpu_torch.ops.tridiag` in the JAX package's order.
  * ``algorithm="babe"`` (K16, ``csrc/tridiag.cu``): the twisted
    (burn-at-both-ends) factorization. Rows 1..m are eliminated downward
    and rows n-2..m+1 upward (m = (n-2)//2), the middle row couples both,
    and the back substitution runs outward from m; each step advances both
    recurrences, halving the dependent depth. Its operands come from a
    numpy float64 setup (the JAX package's ``_babe_setup``), cast to the
    factor's dtype.
  * ``algorithm="pcr"`` (K14): the circulant PCR solve d <- d*scale, then
    the truncated schedule, on K15's line kernel (``csrc/compact.cu``)
    with its RHS taps off. Only periodic, constant, symmetric, diagonally
    dominant systems qualify.
  * ``algorithm="auto"``: PCR for every qualifying system with n >= 4
    (the schedule is n-agnostic; the JAX package's Mosaic-safe extent gate
    has no counterpart here), Thomas for everything else.

K17 fuses the staggered compact-scheme RHS, a*(f[i+sh] + s*f[i+sh-1]) +
b*(f[i+sh+1] + s*f[i+sh-2]) (indices mod n), into the Thomas sweeps along
axis 0 of a 3-D field, one thread per line: ``solve_compact`` (one
operator), :func:`compact_dual` (two operators of one input),
:func:`compact_chain` (op2(op1(f)) along one axis) and
:func:`compact_sum` (op1(fa + fb) + op2(f3)). A spec is (a, b, opsign,
shift); each operator brings its own factor, whose Thomas vectors a PCR or
babe factor builds when a fused entry first needs them.

A CPU tensor runs the plain versions (:func:`thomas_plain`,
:func:`babe_plain`, :func:`compact_thomas_plain`, ``compact_pcr._vop``):
the Pallas kernels' row loops on (n, B) tensors. A CUDA tensor launches the
kernel or raises; any other device raises. Launches count in
:data:`poissbox_tpu_torch.ops.stencil_cuda.LAUNCHES` as ``tridiag.thomas``,
``tridiag.pcr``, ``tridiag.babe``, ``tridiag.compact``, ``tridiag.dual``,
``tridiag.chain`` and ``tridiag.sum``.
"""

from __future__ import annotations

import numpy as np
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

# K17's modes and their codes in the C entry
_MODES = {"compact": 0, "dual": 1, "chain": 2, "sum": 3}


# ---------------------------------------------------------------------------
# plain versions (the Pallas kernels' row loops on (n, B) tensors)
# ---------------------------------------------------------------------------

def _bwd_and_corr(rows: list, binv, cb, corr) -> list:
    """Back substitution and the periodic correction on the forward
    sweep's rows (`_bwd_and_corr`)."""
    n = len(rows)
    rows[n - 1] = rows[n - 1] * binv[n - 1]
    for i in range(n - 2, -1, -1):
        rows[i] = rows[i] * binv[i] - cb[i] * rows[i + 1]
    return _correct(rows, corr)


def _correct(rows: list, corr) -> list:
    """x_i -= usol_i * ((x_0 + ar*x_{n-1}) * (1/denom)) when corr[1] != 0."""
    if float(corr[1]) == 0.0:
        return rows
    n = len(rows)
    factor = (rows[0] + corr[0] * rows[n - 1]) * corr[1]
    return [rows[i] - corr[2 + i] * factor for i in range(n)]


def _thomas_rows(rhs, fac, n: int) -> list:
    """Thomas solve of the rows rhs(0..n-1) with fac = (w, binv, cb, corr)."""
    w, binv, cb, corr = fac
    rows = [rhs(0)]
    for i in range(1, n):
        rows.append(rhs(i) - w[i] * rows[i - 1])
    return _bwd_and_corr(rows, binv, cb, corr)


def thomas_plain(w, binv, cb, corr, d: Tensor) -> Tensor:
    """K13's plain version on a (n, B) RHS: the Pallas kernel's row loop
    (`_thomas_kernel`, `_bwd_and_corr`)."""
    return torch.stack(_thomas_rows(lambda i: d[i], (w, binv, cb, corr), d.shape[0]))


def babe_plain(wv, binv, ca, corr, d: Tensor, m: int) -> Tensor:
    """K16's plain version on a (n, B) RHS: `_babe_kernel`'s row loop,
    the odd split's one-sided steps included."""
    n = d.shape[0]
    x = [None] * n
    x[0], x[n - 1] = d[0], d[n - 1]
    for i in range(1, m + 1):               # downward elimination
        x[i] = d[i] - wv[i] * x[i - 1]
    for j in range(n - 2, m, -1):           # upward elimination
        x[j] = d[j] - wv[j] * x[j + 1]
    x[m] = (x[m] - corr[n + 2] * x[m + 1]) * binv[m]
    for i in range(m - 1, -1, -1):
        x[i] = (x[i] - ca[i] * x[i + 1]) * binv[i]
    for j in range(m + 1, n):
        x[j] = (x[j] - ca[j] * x[j - 1]) * binv[j]
    return torch.stack(_correct(x, corr))


def _taps(f_at, n: int, spec):
    """Row i of the staggered compact RHS from a row accessor f_at
    (`_rhs_taps`)."""
    a, b, opsign, shift = spec
    s = float(opsign)
    return lambda i: (a * (f_at((i + shift) % n) + s * f_at((i + shift - 1) % n))
                      + b * (f_at((i + shift + 1) % n) + s * f_at((i + shift - 2) % n)))


def compact_thomas_plain(mode: str, inputs, facs, specs):
    """K17's plain version on (n, B) inputs: the row loops of
    `_compact_thomas_kernel` (compact), `_compact_thomas2_kernel` (dual),
    `_compact_chain_kernel` (chain) and `_compact_sum_kernel` (sum), with
    facs the operators' (w, binv, cb, corr) and specs their
    (a, b, opsign, shift). dual returns two fields, the others one."""
    n = inputs[0].shape[0]
    rows = lambda t: (lambda i: t[i])
    solve = lambda f_at, k: _thomas_rows(_taps(f_at, n, specs[k]), facs[k], n)
    f = inputs[0]
    if mode == "compact":
        return torch.stack(solve(rows(f), 0))
    if mode == "dual":
        return torch.stack(solve(rows(f), 0)), torch.stack(solve(rows(f), 1))
    if mode == "chain":
        mid = solve(rows(f), 0)
        return torch.stack(solve(rows(mid), 1))
    if mode == "sum":
        fa, fb, f3 = inputs
        acc = solve(lambda i: fa[i] + fb[i], 0)
        return torch.stack(solve(rows(f3), 1)) + torch.stack(acc)
    raise ValueError(f"unknown compact mode {mode!r}")


# ---------------------------------------------------------------------------
# the twisted factorization's setup (numpy, float64, once)
# ---------------------------------------------------------------------------

def _babe_factor_np(a, b, c):
    """Downward elimination on rows 0..m, upward on n-1..m+1, coupled at
    the middle row m."""
    n = len(b)
    m = (n - 2) // 2
    w = np.zeros(n)
    bd = np.array(b, dtype=np.float64)
    for i in range(1, m + 1):
        w[i] = a[i] / bd[i - 1]
        bd[i] = b[i] - w[i] * c[i - 1]
    v = np.zeros(n)
    bu = np.array(b, dtype=np.float64)
    for i in range(n - 2, m, -1):
        v[i] = c[i] / bu[i + 1]
        bu[i] = b[i] - v[i] * a[i + 1]
    vm = c[m] / bu[m + 1]
    bmid = bd[m] - vm * a[m + 1]
    return w, bd, v, bu, vm, bmid, m


def _babe_solve_np(a, b, c, d):
    """One solve with the twisted factorization (the periodic setup's
    auxiliary solve)."""
    n = len(b)
    w, bd, v, bu, vm, bmid, m = _babe_factor_np(a, b, c)
    dd = np.array(d, dtype=np.float64)
    for i in range(1, m + 1):
        dd[i] = d[i] - w[i] * dd[i - 1]
    du = np.array(d, dtype=np.float64)
    for i in range(n - 2, m, -1):
        du[i] = d[i] - v[i] * du[i + 1]
    x = np.zeros(n)
    x[m] = (dd[m] - vm * du[m + 1]) / bmid
    for i in range(m - 1, -1, -1):
        x[i] = (dd[i] - c[i] * x[i + 1]) / bd[i]
    for i in range(m + 1, n):
        x[i] = (du[i] - a[i] * x[i - 1]) / bu[i]
    return x


def _babe_operands(a, b, c, periodic: bool):
    """(wv, binv, ca, corr, m) of K16 in float64 (`_babe_setup`): periodic
    systems take the Thomas path's Sherman–Morrison reduction with the
    twisted auxiliary solve; corr has n + 3 entries, vm at corr[n + 2]."""
    n = len(b)
    corr = np.zeros(n + 3)
    bmod = np.array(b, dtype=np.float64)
    if periodic:
        gamma = -b[0]
        bmod[0] -= gamma
        bmod[n - 1] -= c[n - 1] * a[0] / gamma
        u = np.zeros(n)
        u[0] = gamma
        u[n - 1] = c[n - 1]
        usol = _babe_solve_np(a, bmod, c, u)
        ar = a[0] / gamma
        denom = 1.0 + usol[0] + ar * usol[n - 1]
        corr[0] = ar
        corr[1] = 1.0 / denom
        corr[2:n + 2] = usol
    w, bd, v, bu, vm, bmid, m = _babe_factor_np(a, bmod, c)
    idx = np.arange(n)
    wv = np.where(idx <= m, w, v)
    binv = np.zeros(n)
    binv[:m] = 1.0 / bd[:m]
    binv[m] = 1.0 / bmid
    binv[m + 1:] = 1.0 / bu[m + 1:]
    ca = np.where(idx < m, c, a)
    ca[m] = 0.0
    corr[n + 2] = vm
    return wv, binv, ca, corr, m


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _check_cuda(*ts: Tensor) -> None:
    """What the kernels take: tensors on one CUDA device, float32 or
    float64."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if t.device != ts[0].device:
            raise ValueError(f"tensors on {ts[0].device} and {t.device}")
    if ts[0].dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the tridiagonal kernels take float32 or float64, not "
                        f"{str(ts[0].dtype).replace('torch.', '')}")


def _spec(spec) -> tuple:
    a, b, opsign, shift = spec
    if int(opsign) not in (-1, 1) or int(shift) not in (0, 1):
        raise ValueError(f"a compact spec is (a, b, opsign = +-1, shift = 0 or 1), "
                         f"got {tuple(spec)}")
    return float(a), float(b), int(opsign), int(shift)


def _fused(mode: str, inputs, facs, specs, plain: bool):
    """K17 on lines along axis 0 of 3-D fields of one shape (cast to the
    first factor's dtype); returns fields of that shape."""
    shape = inputs[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in inputs):
        raise ValueError("the fused compact entries take 3-D fields of one shape, "
                         "lines along axis 0; move the axis first")
    n = shape[0]
    if any(fac.n != n for fac in facs):
        raise ValueError(f"lines of {n} rows, factors of {[fac.n for fac in facs]}")
    ins = [t.to(facs[0].dtype).contiguous().reshape(n, -1) for t in inputs]
    specs = [_spec(s) for s in specs]
    on_cpu = ins[0].device.type == "cpu"
    if not (plain or on_cpu):
        _check_cuda(*ins)
    fvs = [fac._on(ins[0].device, "thomas") for fac in facs]
    if plain or on_cpu:
        out = compact_thomas_plain(mode, ins, fvs, specs)
    else:
        out = _launch_compact(mode, ins, fvs, specs)
    return tuple(o.reshape(shape) for o in out) if mode == "dual" else out.reshape(shape)


def _launch_compact(mode: str, ins, fvs, specs):
    f0 = ins[0]
    n, Q = f0.shape
    outs = [torch.empty_like(f0) for _ in range(2 if mode == "dual" else 1)]
    mid = torch.empty_like(f0) if mode in ("chain", "sum") else None
    pad = lambda seq, k: list(seq) + [None] * (k - len(seq))
    fv2 = fvs[1] if len(fvs) > 1 else (None,) * 4
    sp2 = specs[1] if len(specs) > 1 else (0.0, 0.0, 1, 0)
    lib = _build.load()
    err = lib.poissbox_compact_thomas(
        DTYPE_CODE[f0.dtype], _MODES[mode], f0.device.index or 0, _stream(f0),
        *map(_ptr, pad(ins, 3)), *map(_ptr, pad(outs, 2)), _ptr(mid),
        *map(_ptr, fvs[0]), *map(_ptr, fv2), *specs[0], *sp2, n, Q)
    key = f"tridiag.{mode}"
    _raise_on(lib, err, key)
    LAUNCHES[key] += 1
    return tuple(outs) if mode == "dual" else outs[0]


def compact_dual(f: Tensor, fac1, spec1, fac2, spec2, *, plain: bool = False):
    """(op1(f), op2(f)) along axis 0 of a 3-D field in one K17 launch
    (dual mode; 3 field passes at the floor). spec = (a, b, opsign, shift);
    fac = the operator's CudaTridiagFactor. `plain` runs the plain version
    on any device (what chip_smoke.py holds the kernel to)."""
    return _fused("dual", [f], [fac1, fac2], [spec1, spec2], plain)


def compact_chain(f: Tensor, fac1, spec1, fac2, spec2, *, plain: bool = False) -> Tensor:
    """op2(op1(f)) along axis 0 in one K17 launch (chain mode; op1's
    solution waits in a scratch field)."""
    return _fused("chain", [f], [fac1, fac2], [spec1, spec2], plain)


def compact_sum(fa: Tensor, fb: Tensor, f3: Tensor, fac1, spec1, fac2, spec2, *,
                plain: bool = False) -> Tensor:
    """op1(fa + fb) + op2(f3) along axis 0 in one K17 launch (sum mode; 4
    field passes at the floor)."""
    return _fused("sum", [fa, fb, f3], [fac1, fac2], [spec1, spec2], plain)


class CudaTridiagFactor:
    """The Hopper counterpart of ``PallasTridiagFactor``: solves along
    `axis` of any RHS; ``algorithm`` is "auto", "thomas", "babe" or
    "pcr"."""

    def __init__(self, a, b, c, periodic: bool, algorithm: str = "auto"):
        a, b, c = torch.broadcast_tensors(*(torch.as_tensor(v) for v in (a, b, c)))
        self.n = b.shape[0]
        self.dtype = b.dtype
        self.periodic = periodic
        if algorithm == "auto":
            algorithm = "pcr" if self._pcr_eligible(a, b, c, periodic) else "thomas"
        if algorithm not in ("thomas", "babe", "pcr"):
            raise ValueError(f"unknown tridiag algorithm {algorithm!r}")
        self.algorithm = algorithm
        self._abc = (a, b, c)
        self._dev = {}
        if algorithm == "pcr":
            if not self._pcr_eligible(a, b, c, periodic):
                raise ValueError("pcr needs a periodic constant symmetric "
                                 "diagonally dominant system of n >= 4")
            av, bv = float(a[0]), float(b[0])
            sched = compact_pcr.pcr_schedule(
                av / bv, self.n, compact_pcr._dtype_rtol(self.dtype))
            self.pcr_spec = compact_pcr.solve_spec(1.0 / bv, sched)
        elif algorithm == "babe":
            if self.n < 2:
                raise ValueError("babe needs n >= 2")
            *ops, self.babe_m = _babe_operands(
                *(v.detach().cpu().numpy().astype(np.float64) for v in (a, b, c)),
                periodic)
            self.babe = tuple(torch.as_tensor(v, dtype=self.dtype) for v in ops)
        else:
            self._thomas_setup()

    def _thomas_setup(self) -> None:
        """Factor vectors (w, binv, cb, corr), in the coefficients' dtype
        (the JAX package's `_thomas_setup`), from the plain stack's
        factorization and Sherman–Morrison vector."""
        a, b, c = self._abc
        ref = TridiagFactor(a, b, c, self.periodic, method="seq")
        binv = 1.0 / ref.bmod
        cb = c * binv
        cb[-1] = 0.0
        if self.periodic:
            corr = torch.cat([torch.stack([ref.alpha_ratio, 1.0 / ref.denom]), ref.usol])
        else:
            corr = torch.zeros(self.n + 2, dtype=b.dtype)
        self.thomas = (ref.w, binv, cb, corr)

    def _on(self, device, name: str) -> tuple[Tensor, ...]:
        """The "thomas" or "babe" vectors on `device`, copied there once;
        a PCR or babe factor builds its Thomas vectors here when first
        asked (`_ensure_thomas`)."""
        key = (name, str(device))
        if key not in self._dev:
            if name == "thomas" and not hasattr(self, "thomas"):
                self._thomas_setup()
            self._dev[key] = tuple(v.to(device=device, dtype=self.dtype).contiguous()
                                   for v in getattr(self, name))
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
        use_plain = plain or d2.device.type == "cpu"
        if not use_plain:
            _check_cuda(d2)
        if self.algorithm == "pcr":
            if use_plain:
                return compact_pcr._vop(d2, 0, self.pcr_spec)
            (x,) = compact_pcr.sweep((((0, (self.pcr_spec,)),),), [d2], 0,
                                     key="tridiag.pcr")
            return x
        babe = self.algorithm == "babe"
        v = self._on(d2.device, self.algorithm)
        if use_plain:
            return babe_plain(*v, d2, self.babe_m) if babe else thomas_plain(*v, d2)
        x = torch.empty_like(d2)
        lib = _build.load()
        head = (DTYPE_CODE[d2.dtype], d2.device.index or 0, _stream(d2), _ptr(d2),
                _ptr(x), *map(_ptr, v))
        if babe:
            err = lib.poissbox_babe(*head, self.n, self.babe_m, d2.shape[1])
        else:
            err = lib.poissbox_thomas(*head, self.n, d2.shape[1])
        key = f"tridiag.{self.algorithm}"
        _raise_on(lib, err, key)
        LAUNCHES[key] += 1
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

    def solve_compact(self, f: Tensor, a: float, b: float, opsign: int, shift: int,
                      axis: int = 0, *, plain: bool = False) -> Tensor:
        """The staggered compact RHS of `f` (a, b, opsign, shift) solved
        with this system along axis 0 of a 3-D field, in one K17 launch
        (compact mode; 2 field passes at the floor). Other layouts move the
        axis first, or build the RHS and call :meth:`solve`."""
        if f.dim() != 3 or axis % 3 != 0:
            raise ValueError("solve_compact requires a 3-D field with axis=0; "
                             "move the axis first or use the unfused path")
        return _fused("compact", [f], [self], [(a, b, opsign, shift)], plain)
