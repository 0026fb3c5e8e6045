"""Batched tridiagonal solves on Hopper: K13 (Thomas), K14 (circulant
PCR), K16 (the twisted factorization) and K17 (the compact RHS fused into
the Thomas sweeps) — the port of :mod:`poissbox_tpu.ops.tridiag_pallas`.

:class:`CudaTridiagFactor` mirrors ``PallasTridiagFactor``: a fixed
(a, b, c) system, periodic or not, factored once, then ``solve(d, axis)``
on any batch. The line axis moves to the front and the batch flattens to
(n, B) — no copy for a contiguous 3-D field solved along axis 0 — and the
result is moved back.

  * ``algorithm="thomas"`` (K13, ``csrc/tridiag.cu``): forward sweep,
    back substitution and the periodic rank-1 correction in one launch on
    the strip kernel (below), the correction fused into the store; the
    factor vectors come from the port's
    :mod:`~poissbox_tpu_torch.ops.tridiag` in the JAX package's order.
  * ``algorithm="babe"`` (K16, ``csrc/tridiag.cu``): the twisted
    (burn-at-both-ends) factorization. Rows 1..m are eliminated downward
    and rows n-2..m+1 upward (m = (n-2)//2), the middle row couples both,
    and the back substitution runs outward from m; each step advances both
    recurrences, halving the dependent depth. Its operands come from a
    numpy float64 setup (the JAX package's ``_babe_setup``), cast to the
    factor's dtype. Lines run on the strip kernel (below).
  * ``algorithm="pcr"`` (K14): the circulant PCR solve d <- d*scale, then
    the truncated schedule, on K15's line kernel (``csrc/compact.cu``)
    with its RHS taps off. Only periodic, constant, symmetric, diagonally
    dominant systems qualify.
  * ``algorithm="auto"``: PCR for every qualifying system with n >= 4
    (the schedule is n-agnostic; the JAX package's Mosaic-safe extent gate
    has no counterpart here), Thomas for everything else.

K17 fuses the staggered compact-scheme RHS, a*(f[i+sh] + s*f[i+sh-1]) +
b*(f[i+sh+1] + s*f[i+sh-2]) (indices mod n), into the Thomas sweeps along
axis 0 of a 3-D field: ``solve_compact`` (one operator),
:func:`compact_dual` (two operators of one input), :func:`compact_chain`
(op2(op1(f)) along one axis) and :func:`compact_sum` (op1(fa + fb) +
op2(f3)). A spec is (a, b, opsign, shift); each operator brings its own
factor, whose Thomas vectors a PCR or babe factor builds when a fused
entry first needs them.

K13, K16 and K17 run on strip kernels: a worker of 32 or 16 lanes holds
whole lines in shared memory from load to store, one lane per line, so HBM
sees each input and output once. :func:`strip_lanes` says what a shape
takes; lines too long for a strip take the streaming kernels (one thread
per line through HBM). :func:`thomas_strip_mirror`,
:func:`compact_strip_mirror` and :func:`babe_strip_mirror` run the strip
kernels' algorithm on the CPU: the same chunked loads, in-place overwrites
and held taps, bit-equal to the plain versions.

A CPU tensor runs the plain versions (:func:`thomas_plain`,
:func:`babe_plain`, :func:`compact_thomas_plain`, ``compact_pcr._vop``):
the Pallas kernels' row loops on (n, B) tensors. A CUDA tensor launches the
kernel or raises; any other device raises. Launches count in
:data:`poissbox_tpu_torch.ops._build.LAUNCHES` as ``tridiag.thomas``,
``tridiag.pcr``, ``tridiag.babe``, ``tridiag.compact``, ``tridiag.dual``,
``tridiag.chain`` and ``tridiag.sum``, with ``.long`` for the streaming
kernels of K13, K16 and K17.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from poissbox_tpu_torch.ops import _build, compact_pcr
from poissbox_tpu_torch.ops.tridiag import TridiagFactor

Tensor = torch.Tensor

# K17's modes and their codes in the C entry; K16's and K13's codes in
# strip_lanes
_MODES = {"compact": 0, "dual": 1, "chain": 2, "sum": 3, "babe": 4, "thomas": 5}


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
# the strip kernels (csrc/tridiag.cu), mirrored on the CPU
# ---------------------------------------------------------------------------

STRIP_CHUNK = 16   # kChunk: rows of one cp.async group
STRIP_DEPTH = 32   # kDepth: groups issued up front; a chunk's sweep waits for two
STRIP_BLOCK = 8    # kU: rows read into registers before any of them is written


class _Feed:
    """A lane set's cp.async groups: group c copies, for each (global,
    strip column, rows) part, the (source row, strip row) pairs rows(c);
    ``wait(k)`` lands every group but the k most recent. A row read before
    it lands reads the strip's NaN, and a group that lands over a row the
    sweep already wrote undoes it, so either fault shows in the result."""

    def __init__(self, parts):
        self.parts, self.pending = parts, []

    def issue(self, c: int) -> None:
        self.pending.append([(src, dst, rows(c)) for src, dst, rows in self.parts])

    def start(self) -> None:
        for c in range(STRIP_DEPTH):
            self.issue(c)

    def wait(self, k: int) -> None:
        while len(self.pending) > k:
            for src, dst, rows in self.pending.pop(0):
                for r_src, r_dst in rows:
                    dst[r_dst] = src[r_src]


def _chunk_rows(n: int):
    return lambda c: [(r, r) for r in range(c * STRIP_CHUNK, min(n, (c + 1) * STRIP_CHUNK))]


def _forward_strip(spec, w, x, y, tap, feed, n: int):
    """`forward_strip`: op's forward sweep over a lane set's columns x
    (plus y: the sum's fb), dmod_i written over x[i]; the taps start from
    `tap` and the wrapped ones come from the held rows h0, h1. Returns
    dmod_{n-1}."""
    a, b, opsign, sh = spec
    s = float(opsign)
    rhs = lambda t0, t1, t2, t3: a * (t2 + s * t1) + b * (t3 + s * t0)
    t0, t1, t2, t3 = (tap(j % n) for j in (sh - 2, sh - 1, sh, sh + 1))
    h0, h1 = tap(0), tap(1 % n)
    wrap = n - 1 - sh
    prev = None
    for c in range(-(-n // STRIP_CHUNK)):
        if feed is not None:
            feed.wait(STRIP_DEPTH - 2)
        hi = min(n, (c + 1) * STRIP_CHUNK)
        i = c * STRIP_CHUNK
        if i == 0:
            prev = rhs(t0, t1, t2, t3)
            x[0] = prev
            i = 1
        main_end = min(hi, wrap)
        tap_at = lambda j: x[j].clone() if y is None else x[j] + y[j]
        while i < main_end:   # kU rows' taps, then their steps; then row by row
            rows = range(i, i + STRIP_BLOCK) if i + STRIP_BLOCK <= main_end else [i]
            for r, t in list(zip(rows, [tap_at(r + sh + 1) for r in rows])):
                t0, t1, t2, t3 = t1, t2, t3, t
                v = rhs(t0, t1, t2, t3) - w[r] * prev
                x[r] = v
                prev = v
            i += len(rows)
        for i in range(i, hi):   # the new tap past the line's end
            t0, t1, t2, t3 = t1, t2, t3, h0 if i + sh + 1 == n else h1
            v = rhs(t0, t1, t2, t3) - w[i] * prev
            x[i] = v
            prev = v
        if feed is not None:
            feed.issue(c + STRIP_DEPTH)
    if feed is not None:
        feed.wait(0)
    return prev


def _backward_strip(fac, x, last, n: int):
    """`backward_strip`: the back substitution on the strip; returns the
    uncorrected (x_0, x_{n-1})."""
    _, binv, cb, _ = fac
    vn = last * binv[n - 1]
    x[n - 1] = vn
    prev = vn
    i = n - 2
    while i >= 0:   # kU rows, then row by row
        rows = range(i, i - STRIP_BLOCK, -1) if i >= STRIP_BLOCK - 1 else [i]
        for r, xr in list(zip(rows, [x[r].clone() for r in rows])):
            v = xr * binv[r] - cb[r] * prev
            x[r] = v
            prev = v
        i -= len(rows)
    return prev, vn


def _correction(corr, x0, xn):
    """`Correction`: row i of the corrected solution on the strip."""
    if float(corr[1]) == 0.0:
        return lambda x, i: x[i].clone()
    factor = (x0 + corr[0] * xn) * corr[1]
    return lambda x, i: x[i] - corr[2 + i] * factor


def _each_row(n: int, get, put) -> None:
    """`each_row`: put(i, get(i)) in blocks of kU rows whose gets come
    first, then row by row."""
    i = 0
    while i < n:
        rows = range(i, i + STRIP_BLOCK) if i + STRIP_BLOCK <= n else [i]
        for r, v in list(zip(rows, [get(r) for r in rows])):
            put(r, v)
        i += len(rows)


def _rows(n: int, get) -> list:
    out = [None] * n
    _each_row(n, get, out.__setitem__)
    return out


class _Strip:
    """The blocks of a strip kernel side by side: a NaN strip of (n,
    blocks, pitch) values, and the (n, blocks, lines) view of a global
    (n, Q) field that a lane set reads (a lane past the last line reads
    line Q-1, as the kernel does)."""

    def __init__(self, n: int, Q: int, lines: int, pitch: int, like: Tensor):
        self.n, self.Q, self.lines = n, Q, lines
        self.blocks = -(-Q // lines)
        self.s = torch.full((n, self.blocks, pitch), float("nan"), dtype=like.dtype)
        self.q = torch.arange(self.blocks * lines).clamp(max=Q - 1)

    def col(self, lo: int):
        return self.s[:, :, lo:lo + self.lines]

    def gather(self, f: Tensor) -> Tensor:
        return f[:, self.q].reshape(self.n, self.blocks, self.lines)

    def scatter(self, rows: list) -> Tensor:
        return torch.stack(rows).reshape(self.n, -1)[:, :self.Q]


def _solve_fed(st: _Strip, spec, fac, x, g0, g1=None, y=None):
    """Load g0 (and g1 into y) by chunks and sweep op over them: x then
    holds the back substitution; returns (x_0, x_{n-1})."""
    n = st.n
    rows = _chunk_rows(n)
    feed = _Feed([(g0, x, rows)] + ([(g1, y, rows)] if g1 is not None else []))
    feed.start()
    tap = (lambda j: g0[j].clone()) if g1 is None else (lambda j: g0[j] + g1[j])
    last = _forward_strip(spec, fac[0], x, y, tap, feed, n)
    return _backward_strip(fac, x, last, n)


def compact_strip_mirror(mode: str, inputs, facs, specs, lanes: int = 32):
    """K17's strip kernel (`compact_strip_kernel`) on (n, Q) inputs, on the
    CPU: workers of `lanes` lanes, the same chunked loads, tap window, held
    rows, in-place overwrites and stores. Returns what
    :func:`compact_thomas_plain` returns, bit for bit."""
    f = inputs[0]
    n, Q = f.shape
    st = _Strip(n, Q, lanes, 2 * lanes if mode == "sum" else lanes, f)
    g = [st.gather(t) for t in inputs]

    def store(fac, x, ends):
        corr = _correction(fac[3], *ends)
        return st.scatter(_rows(n, lambda i: corr(x, i)))

    def correct(fac, x, ends):
        corr = _correction(fac[3], *ends)
        _each_row(n, lambda i: corr(x, i), x.__setitem__)

    if mode in ("compact", "dual"):
        x = st.col(0)
        out0 = store(facs[0], x, _solve_fed(st, specs[0], facs[0], x, g[0]))
        if mode == "compact":
            return out0
        # f once more, for op2
        return out0, store(facs[1], x, _solve_fed(st, specs[1], facs[1], x, g[0]))
    if mode == "chain":
        x = st.col(0)
        correct(facs[0], x, _solve_fed(st, specs[0], facs[0], x, g[0]))
        # op2's window and held rows are op1's solution, read from the strip
        last = _forward_strip(specs[1], facs[1][0], x, None, lambda j: x[j].clone(), None, n)
        return store(facs[1], x, _backward_strip(facs[1], x, last, n))
    if mode == "sum":   # op1 on fa + fb in x (fb in y), then op2 on f3 in y
        x, y = st.col(0), st.col(lanes)
        correct(facs[0], x, _solve_fed(st, specs[0], facs[0], x, g[0], g[1], y))
        corr2 = _correction(facs[1][3], *_solve_fed(st, specs[1], facs[1], y, g[2]))
        return st.scatter(_rows(n, lambda i: corr2(y, i) + x[i]))
    raise ValueError(f"unknown compact mode {mode!r}")


def thomas_strip_mirror(w, binv, cb, corr, d: Tensor, lanes: int = 32) -> Tensor:
    """K13's strip kernel (`compact_strip_kernel`, mode kThomas) on a (n,
    Q) RHS, on the CPU: chunked loads, the forward sweep over each chunk
    once its own group has landed, in place, the back substitution on the
    strip and the corrected store; bit-equal to :func:`thomas_plain`."""
    n, Q = d.shape
    st = _Strip(n, Q, lanes, lanes, d)
    x = st.col(0)
    feed = _Feed([(st.gather(d), x, _chunk_rows(n))])
    feed.start()
    prev = None
    for c in range(-(-n // STRIP_CHUNK)):
        feed.wait(STRIP_DEPTH - 1)
        hi = min(n, (c + 1) * STRIP_CHUNK)
        i = c * STRIP_CHUNK
        if i == 0:
            prev = x[0].clone()
            i = 1
        while i < hi:   # kU rows read, then their steps; then row by row
            rows = range(i, i + STRIP_BLOCK) if i + STRIP_BLOCK <= hi else [i]
            for r, dr in list(zip(rows, [x[r].clone() for r in rows])):
                prev = dr - w[r] * prev
                x[r] = prev
            i += len(rows)
        feed.issue(c + STRIP_DEPTH)
    feed.wait(0)
    out = _correction(corr, *_backward_strip((w, binv, cb, corr), x, prev, n))
    return st.scatter(_rows(n, lambda i: out(x, i)))


def babe_strip_mirror(wv, binv, ca, corr, d: Tensor, m: int, lanes: int = 32) -> Tensor:
    """K16's strip kernel (`babe_strip_kernel`) on a (n, Q) RHS, on the
    CPU: loads from both ends by chunks, both eliminations in place, the
    middle row, the outward back substitution and the corrected store;
    bit-equal to :func:`babe_plain`."""
    n, Q = d.shape
    st = _Strip(n, Q, lanes, lanes, d)
    x, g = st.col(0), st.gather(d)
    C = STRIP_CHUNK
    rows = lambda c: [(r, r) for r in (list(range(c * C, min(m + 1, (c + 1) * C)))
                                       + list(range(n - 1 - c * C,
                                                    max(m + 1, n - (c + 1) * C) - 1, -1)))]
    feed = _Feed([(g, x, rows)])
    feed.start()
    feed.wait(STRIP_DEPTH - 1)
    lo, hi = x[0].clone(), x[n - 1].clone()
    kd, ku = m, n - 2 - m
    ke = max(kd, ku)
    U = STRIP_BLOCK
    for c in range(-(-ke // C)):
        feed.wait(STRIP_DEPTH - 2)
        k, k1 = c * C, min(ke, (c + 1) * C)
        while k + U <= min(k1, kd, ku):   # both chains: the block's rows, then its steps
            xd = [x[1 + k + u].clone() for u in range(U)]
            xu = [x[n - 2 - k - u].clone() for u in range(U)]
            for u in range(U):
                lo = xd[u] - wv[1 + k + u] * lo
                x[1 + k + u] = lo
                hi = xu[u] - wv[n - 2 - k - u] * hi
                x[n - 2 - k - u] = hi
            k += U
        for k in range(k, k1):
            if k < kd:
                i = 1 + k
                lo = x[i] - wv[i] * lo
                x[i] = lo
            if k < ku:
                j = n - 2 - k
                hi = x[j] - wv[j] * hi
                x[j] = hi
        feed.issue(c + STRIP_DEPTH)
    feed.wait(0)
    xm = (lo - corr[n + 2] * hi) * binv[m]
    x[m] = xm
    lo = hi = xm
    k = 0
    while k + U <= m:   # both directions: the block's rows, then its steps
        xd = [x[m - 1 - k - u].clone() for u in range(U)]
        xu = [x[m + 1 + k + u].clone() for u in range(U)]
        for u in range(U):
            lo = (xd[u] - ca[m - 1 - k - u] * lo) * binv[m - 1 - k - u]
            x[m - 1 - k - u] = lo
            hi = (xu[u] - ca[m + 1 + k + u] * hi) * binv[m + 1 + k + u]
            x[m + 1 + k + u] = hi
        k += U
    for k in range(k, n - 1 - m):
        if k < m:
            i = m - 1 - k
            lo = (x[i] - ca[i] * lo) * binv[i]
            x[i] = lo
        if k < n - 1 - m:
            j = m + 1 + k
            hi = (x[j] - ca[j] * hi) * binv[j]
            x[j] = hi
    out = _correction(corr, lo, hi)
    return st.scatter(_rows(n, lambda i: out(x, i)))

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


@functools.lru_cache(maxsize=None)
def _strip_lanes(code: int, mode: int, n: int, Q: int, index: int) -> int:
    lanes = _build.load().poissbox_strip_lanes(code, mode, n, Q, index)
    if lanes < 0:
        raise RuntimeError(f"poissbox_strip_lanes: error {-lanes}")
    return lanes


def _index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def strip_lanes(mode: str, n: int, Q: int, dtype: torch.dtype, device) -> int:
    """The lanes of a strip worker that K17's `mode` (or K16, "babe", or
    K13, "thomas") takes on Q lines of n rows of `dtype` on CUDA `device`: 32 when a block
    holds three 32-lane workers beside its factor tables and the lines make
    two strips an SM, else 16 when it holds two 16-lane workers, else 0
    (the streaming kernel)."""
    return _strip_lanes(_build.DTYPE_CODE[dtype], _MODES[mode], n, Q, _index(device))


def _launch_compact(mode: str, ins, fvs, specs):
    """One K17 launch on the kernel strip_lanes picks."""
    f0 = ins[0]
    n, Q = f0.shape
    lanes = strip_lanes(mode, n, Q, f0.dtype, f0.device)
    outs = [torch.empty_like(f0) for _ in range(2 if mode == "dual" else 1)]
    # the streaming kernel solves chain's and sum's op1 in a scratch field
    mid = torch.empty_like(f0) if lanes == 0 and mode in ("chain", "sum") else None
    pad = lambda seq, k: list(seq) + [None] * (k - len(seq))
    fv2 = fvs[1] if len(fvs) > 1 else (None,) * 4
    sp2 = specs[1] if len(specs) > 1 else (0.0, 0.0, 1, 0)
    ptr = _build.ptr
    _build.launch(
        "poissbox_compact_thomas", f"tridiag.{mode}" + ("" if lanes else ".long"),
        _build.DTYPE_CODE[f0.dtype], _MODES[mode], f0.device.index or 0, _build.stream(f0),
        *map(ptr, pad(ins, 3)), *map(ptr, pad(outs, 2)), ptr(mid), *map(ptr, fvs[0]),
        *map(ptr, fv2), *specs[0], *sp2, n, Q)
    return tuple(outs) if mode == "dual" else outs[0]


def compact_dual(f: Tensor, fac1, spec1, fac2, spec2, *, plain: bool = False):
    """(op1(f), op2(f)) along axis 0 of a 3-D field in one K17 launch
    (dual mode; 3 field passes at the floor). spec = (a, b, opsign, shift);
    fac = the operator's CudaTridiagFactor. `plain` runs the plain version
    on any device (what chip_smoke.py holds the kernel to)."""
    return _fused("dual", [f], [fac1, fac2], [spec1, spec2], plain)


def compact_chain(f: Tensor, fac1, spec1, fac2, spec2, *, plain: bool = False) -> Tensor:
    """op2(op1(f)) along axis 0 in one K17 launch (chain mode; op1's
    solution stays on chip for op2: 2 field passes at the floor)."""
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
        return self._launch(d2, v, babe)

    def _launch(self, d2: Tensor, v, babe: bool) -> Tensor:
        """One K16 (`babe`) or K13 launch on the contiguous (n, B) CUDA RHS
        with the factor vectors v, on the kernel strip_lanes picks."""
        name = "babe" if babe else "thomas"
        lanes = strip_lanes(name, self.n, d2.shape[1], d2.dtype, d2.device)
        x = torch.empty_like(d2)
        ptr = _build.ptr
        head = (_build.DTYPE_CODE[d2.dtype], d2.device.index or 0, _build.stream(d2), ptr(d2),
                ptr(x), *map(ptr, v), self.n)
        tail = (self.babe_m, d2.shape[1]) if babe else (d2.shape[1],)
        _build.launch("poissbox_babe" if babe else "poissbox_thomas",
                      f"tridiag.{name}" + ("" if lanes else ".long"), *head, *tail)
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
