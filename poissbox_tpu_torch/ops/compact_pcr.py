"""Compact-scheme operators by parallel cyclic reduction (PCR), and K15,
their Hopper line kernel (port of :mod:`poissbox_tpu.ops.compact_pcr`).

Every 1-D operator of the 6th-order staggered stack solves the circulant
system alpha*g_{i-1} + g_i + alpha*g_{i+1} = RHS_i(f). For a circulant
system cyclic reduction has scalar per-step coefficients: one step is

    d <- d - f_k * (roll(d, +s) + roll(d, -s)),   s = 2^k,

and the factors decay like alpha^(2^k), so a schedule truncated at a
quarter ulp of the dtype (:func:`pcr_schedule` with rtol > 0) is a handful
of steps for any n, powers of two or not.

The plain versions (:func:`_vrhs`, :func:`_vpcr`, :func:`_vop`,
:func:`pcr_op`) use ``torch.roll``. K15 (``csrc/compact.cu``) runs one
*sweep*: a program of up to three outputs along one axis, each the sum of
up to two chains of up to two operators applied to one of up to three
inputs (:func:`sweep`). The Pallas kernels hold a whole (T, ny, nz) x-slab
in VMEM and chain the z and y sweeps there; a 256^3 f32 plane is more than
the 227 KB of shared memory a Hopper block may use, so here every sweep is
its own launch:

  * :func:`lapl`: 3 launches, 10 HBM passes (z: 1r 2w; y: 2r 2w; x: 2r 1w)
    against the TPU's regrouped 6;
  * :func:`grad`, :func:`div`, :func:`interp`: 3 launches each;
  * :func:`op_1d`: 1 launch.

A launch takes one of two kernels, by the line length n alone
(:func:`route`). For n = 32 m with m in :data:`REG_M` (64, 96, 128, 256,
384, 512, 640) the register kernel: a warp holds a line in registers as 32
chunks of m points, every shift of the taps and the PCR steps a register
rename or a warp shuffle (:func:`reg_source`), the whole program run with
no shared-memory pass between operators, so a sweep is bound by its
arithmetic and HBM traffic. Every other n >= 4 takes the tile kernel,
whose operators are passes over a tile of lines in shared memory (bound
by shared-memory traffic and barriers), up to the length whose tile fits
(:func:`tile_width`). A failure of either raises; neither stands in for
the other.

A CPU tensor runs the plain versions (:func:`sweep_plain`); a CUDA tensor
launches a kernel or raises. Launches count in
:data:`poissbox_tpu_torch.ops._build.LAUNCHES` as ``compact.x``,
``compact.y`` and ``compact.z`` by the sweep's axis, and in
:data:`ROUTE_LAUNCHES` by kernel. The Mosaic-safe extent gate of the JAX
package (``_tile_ok``) has no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from poissbox_tpu_torch.ops import _build
from poissbox_tpu_torch.ops.coefficients import (
    compact_grad_coeffs,
    compact_interp_coeffs,
)

Tensor = torch.Tensor

MAX_STEPS = 12          # csrc/compact.cu kMaxSteps
SMEM_BYTES = 232448     # shared memory one Hopper block may use (227 KB)
SM_SMEM_BYTES = 233472  # shared memory of one SM (228 KB)
BLOCK_RESERVED_BYTES = 1024   # of it, reserved per resident block
WIDTHS = (32, 16, 8)    # lanes per block the tile kernel is built for
# chunk lengths m of the register kernel's lines, n = 32 m
# (csrc/compact.cu run_compact_reg)
REG_M = (2, 3, 4, 8, 12, 16, 20)
# launches by kernel: the register kernel and the tile kernel
ROUTE_LAUNCHES: dict[str, int] = {"registers": 0, "tile": 0}


def route(n: int) -> str:
    """The kernel a sweep over lines of `n` points takes: "registers" for
    n = 32 m with m in REG_M, "tile" for any other n."""
    return "registers" if n % 32 == 0 and n // 32 in REG_M else "tile"


def reg_source(j: int, s: int, m: int) -> tuple[int, int]:
    """Where the register kernel finds point l*m + j + s of a line of
    n = 32 m points for lane l, which holds points l*m .. l*m + m - 1:
    (lane offset, register), the lane being (l + offset) mod 32. Any
    shift s; the line wraps with the lanes."""
    t = j + s % (32 * m)
    return (t // m) % 32, t % m


# ---------------------------------------------------------------------------
# host-side schedule
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def pcr_schedule(alpha: float, n: int,
                 rtol: float = 0.0) -> tuple[tuple[float, ...], float, float]:
    """Scalar elimination factors (f_0, f_1, ...) and the final (b, a) of
    the circulant (alpha, 1, alpha) system of size n, in float64.

    One step maps bI + a(P^s + P^-s) to b'I + a'(P^2s + P^-2s) with
    f = a/b, a' = -a f, b' = b - 2 a f, exact for any n and stride (shifts
    wrap mod n). With `rtol` > 0 the schedule stops once |f_k| < rtol
    (the dropped correction is O(rtol)); rtol = 0 is the exact ladder of
    log2(n) - 1 steps closed by the (i, i+n/2) pairing, which needs a
    power-of-two n. A truncating schedule that never truncates (a system
    that is not diagonally dominant) would end on that pairing at a stride
    other than n/2, which is wrong: it raises, where the JAX package
    returns the schedule."""
    if n < 4 or (rtol <= 0.0 and n & (n - 1)):
        raise ValueError(
            f"exact (rtol=0) PCR needs power-of-two n >= 4, got {n}; "
            "pass a truncation rtol for arbitrary n")
    a, b = float(alpha), 1.0
    fs = []
    s = 1
    limit = n // 2 if rtol <= 0.0 else n * 64
    while s < limit:
        f = a / b
        if rtol > 0.0 and abs(f) < rtol:
            a = 0.0
            break
        fs.append(f)
        a, b = -a * f, b - 2.0 * a * f
        s *= 2
    if rtol > 0.0 and abs(a / b) < rtol:
        a = 0.0
    if rtol > 0.0 and a != 0.0:
        raise ValueError(
            f"the PCR schedule of alpha={alpha!r} at n={n} did not truncate "
            f"below rtol={rtol!r} (not diagonally dominant?): its final "
            "pairing would not be the (i, i+n/2) one")
    return tuple(fs), b, a


def _dtype_rtol(dtype) -> float:
    """Truncation tolerance: a quarter ulp of the compute dtype."""
    return float(torch.finfo(dtype).eps) * 0.25


def _spec(coeffs, opsign: int, stagger: int, n: int, rtol: float = 0.0):
    """Static op descriptor: (a, b, opsign, shift, schedule)."""
    shift = 0 if stagger == -1 else 1
    return (float(coeffs.a), float(coeffs.b), int(opsign), shift,
            pcr_schedule(float(coeffs.alpha), n, rtol))


def grad_spec(d: float, stagger: int, n: int, rtol: float = 0.0):
    return _spec(compact_grad_coeffs(d), -1, stagger, n, rtol)


def interp_spec(stagger: int, n: int, rtol: float = 0.0):
    return _spec(compact_interp_coeffs(), +1, stagger, n, rtol)


def solve_spec(scale: float, sched):
    """The op of a plain circulant PCR solve (K14): d*scale, then the
    schedule; no RHS taps (b is None)."""
    return (float(scale), None, 0, 0, sched)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _vroll(c: Tensor, k: int, axis: int) -> Tensor:
    """Periodic roll by k (any sign): out[i] = c[i-k] along axis."""
    k %= c.shape[axis]
    return c if k == 0 else torch.roll(c, k, axis)


def _vrhs(c: Tensor, axis: int, a: float, b: float, opsign: int,
          shift: int) -> Tensor:
    """Staggered compact RHS:
    rhs_i = a*(f_{i+sh} + s*f_{i+sh-1}) + b*(f_{i+sh+1} + s*f_{i+sh-2})."""
    s = float(opsign)
    at = lambda k: _vroll(c, -k, axis)    # f_{i+k}
    return (a * (at(shift) + s * at(shift - 1))
            + b * (at(shift + 1) + s * at(shift - 2)))


def _vpcr(d: Tensor, axis: int, sched) -> Tensor:
    """Solve the circulant (alpha, 1, alpha) system along `axis`."""
    fs, bF, aF = sched
    s = 1
    for f in fs:
        d = d - f * (_vroll(d, s, axis) + _vroll(d, -s, axis))
        s *= 2
    if aF == 0.0:  # truncated schedule: off-diagonal below roundoff
        return d * (1.0 / bF)
    dn = _vroll(d, d.shape[axis] // 2, axis)
    inv = 1.0 / (bF * bF - 4.0 * aF * aF)
    return (bF * inv) * d - (2.0 * aF * inv) * dn


def _vop(c: Tensor, axis: int, spec) -> Tensor:
    a, b, opsign, shift, sched = spec
    if b is None:
        return _vpcr(c * a, axis, sched)
    return _vpcr(_vrhs(c, axis, a, b, opsign, shift), axis, sched)


def _vchain(c: Tensor, axis: int, specs) -> Tensor:
    """A sequence of compact ops along the SAME axis."""
    for spec in specs:
        c = _vop(c, axis, spec)
    return c


def pcr_op(f: Tensor, spec, axis: int) -> Tensor:
    """Plain single operator (any device; the CPU reference)."""
    return _vop(f, axis % f.dim(), spec)


# ---------------------------------------------------------------------------
# sweeps: the kernel's programs
# ---------------------------------------------------------------------------
#
# A program is a tuple of outputs; an output a tuple of one or two terms;
# a term (input index, (spec,) or (spec, spec)): the chain applied to that
# input. Output = term0 + term1, summed after both chains, as the Pallas
# kernels sum.

def sweep_plain(program, inputs: Sequence[Tensor], axis: int) -> list[Tensor]:
    outs = []
    for out in program:
        acc = None
        for idx, specs in out:
            v = _vchain(inputs[idx], axis, specs)
            acc = v if acc is None else acc + v
        outs.append(acc)
    return outs


def _encode(program, nin: int) -> list[float]:
    """The flat program csrc/compact.cu parses."""
    code = [nin, len(program)]
    for out in program:
        code.append(len(out))
        for idx, specs in out:
            code += [idx, len(specs)]
            for a, b, opsign, shift, (fs, bF, aF) in specs:
                if len(fs) > MAX_STEPS:
                    raise ValueError(f"PCR schedule of {len(fs)} steps; the "
                                     f"kernel takes at most {MAX_STEPS}")
                code += [0 if b is None else 1, a, 0.0 if b is None else b,
                         float(opsign), shift, len(fs), *fs]
                if aF == 0.0:
                    code += [0, 1.0 / bF, 0.0]
                else:
                    inv = 1.0 / (bF * bF - 4.0 * aF * aF)
                    code += [1, bF * inv, 2.0 * aF * inv]
    return [float(v) for v in code]


def tile_width(n: int, dtype, nbuf: int) -> int:
    """Lanes per block: the widest of WIDTHS whose `nbuf` tiles of
    n x (W + 1) values let two blocks share an SM (one block's loads then
    overlap the other's steps), else the widest that fits one block;
    raises beyond."""
    item = torch.empty((), dtype=dtype).element_size()
    size = lambda w: nbuf * n * (w + 1) * item
    for w in WIDTHS:
        if 2 * (size(w) + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES:
            return w
    for w in WIDTHS:
        if size(w) <= SMEM_BYTES:
            return w
    w = WIDTHS[-1]
    raise ValueError(
        f"compact line kernel: a line of {n} {str(dtype).replace('torch.', '')} "
        f"values does not fit shared memory ({nbuf} tiles of n x {w + 1}); "
        f"the longest it takes is {SMEM_BYTES // (nbuf * (w + 1) * item)}")


def _view3(t: Tensor, axis: int) -> tuple[int, int, int]:
    """(P, n, Q): the contiguous field seen with `axis` in the middle."""
    shape = tuple(t.shape)
    P = 1
    for s in shape[:axis]:
        P *= s
    Q = 1
    for s in shape[axis + 1:]:
        Q *= s
    return P, shape[axis], Q


def sweep(program, inputs: Sequence[Tensor], axis: int,
          key: str | None = None, width: int | None = None) -> list[Tensor]:
    """Run `program` along `axis`: the plain version for CPU tensors, one
    K15 launch for CUDA tensors (the kernel :func:`route` names; counted
    under `key`, by default ``compact.x|y|z``: lines along the first, a
    middle or the last axis). `width` is the tile kernel's lanes per
    block, by default :func:`tile_width`'s; a line length the register
    kernel takes refuses it. Inputs are fields of one shape, dtype and
    device; the outputs are new tensors of that shape."""
    axis %= inputs[0].dim()
    if inputs[0].device.type == "cpu":
        return sweep_plain(program, inputs, axis)
    f0 = inputs[0]
    for t in inputs:
        if t.device != f0.device or t.dtype != f0.dtype or t.shape != f0.shape:
            raise ValueError("compact sweep: inputs of one shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous fields")
    if f0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the compact kernel takes float32 or float64, not "
                        f"{str(f0.dtype).replace('torch.', '')}")
    if len(inputs) > 3 or len(program) > 3:
        raise ValueError("compact sweep: at most 3 inputs and 3 outputs")
    P, n, Q = _view3(f0, axis)
    if n < 4:
        raise ValueError(f"compact sweep: lines of {n} < 4 points")
    nbuf = 3 if any(len(out) == 2 for out in program) else 2
    kernel = route(n)
    if kernel == "registers":
        if width is not None:
            raise ValueError(f"compact sweep: lines of {n} take the register "
                             "kernel, which has no lane width")
        width = 0
    elif width is None:
        width = tile_width(n, f0.dtype, nbuf)
    elif width not in WIDTHS or nbuf * n * (width + 1) * f0.element_size() > SMEM_BYTES:
        raise ValueError(f"compact sweep: width {width} is not one of {WIDTHS} "
                         "or its tiles do not fit shared memory")
    code = _encode(program, len(inputs))
    outs = [torch.empty_like(f0) for _ in program]
    ins = list(inputs) + [None] * (3 - len(inputs))
    optr = outs + [None] * (3 - len(outs))
    if key is None:   # by the lines' layout: the axis's counter for 3-D
        key = "compact.z" if Q == 1 else ("compact.x" if P == 1 else "compact.y")
    ptr = _build.ptr
    _build.launch(
        "poissbox_compact", key, _build.DTYPE_CODE[f0.dtype], f0.device.index or 0,
        _build.stream(f0), (ctypes.c_double * len(code))(*code), len(code),
        *map(ptr, ins), *map(ptr, optr), P, n, Q, width, nbuf)
    ROUTE_LAUNCHES[kernel] += 1
    return outs


# ---------------------------------------------------------------------------
# public operators
# ---------------------------------------------------------------------------

def _deltas(deltas):
    return tuple(float(d) for d in deltas)


def _sweeper(plain: bool):
    """`sweep`, or with `plain` its plain version on any device (what
    chip_smoke.py holds the kernel to on the card)."""
    if plain:
        return lambda program, inputs, axis: sweep_plain(
            program, inputs, axis % inputs[0].dim())
    return sweep


def grad_sweeps(shape, deltas, dtype):
    """The gradient's three (program, axis) sweeps, cell->vertex: z
    (1r2w), y (2r3w), x (3r3w); the outputs are the components."""
    dx, dy, dz = _deltas(deltas)
    nx, ny, nz = shape
    rt = _dtype_rtol(dtype)
    iz, gz = interp_spec(-1, nz, rt), grad_spec(dz, -1, nz, rt)
    iy, gy = interp_spec(-1, ny, rt), grad_spec(dy, -1, ny, rt)
    ix, gx = interp_spec(-1, nx, rt), grad_spec(dx, -1, nx, rt)
    return [((((0, (iz,)),), ((0, (gz,)),)), 2),
            ((((0, (iy,)),), ((0, (gy,)),), ((1, (iy,)),)), 1),
            ((((0, (gx,)),), ((1, (ix,)),), ((2, (ix,)),)), 0)]


def div_sweeps(shape, deltas, dtype):
    """The divergence's three sweeps, vertex->cell, on the components: x
    (3r3w), y (interp'/div'/interp', 3r2w), then the summed z sweep
    interp'(h1 + h2) + div'(h3) (2r1w)."""
    dx, dy, dz = _deltas(deltas)
    nx, ny, nz = shape
    rt = _dtype_rtol(dtype)
    ixp, gxp = interp_spec(+1, nx, rt), grad_spec(dx, +1, nx, rt)
    iyp, gyp = interp_spec(+1, ny, rt), grad_spec(dy, +1, ny, rt)
    izp, gzp = interp_spec(+1, nz, rt), grad_spec(dz, +1, nz, rt)
    return [((((0, (gxp,)),), ((1, (ixp,)),), ((2, (ixp,)),)), 0),
            ((((0, (iyp,)), (1, (gyp,))), ((2, (iyp,)),)), 1),
            ((((0, (izp,)), (1, (gzp,))),), 2)]


def interp_sweeps(shape, stagger: int, dtype):
    """Tri-directional interpolation's sweeps, z then y then x: one
    operator each (1r1w)."""
    nx, ny, nz = shape
    rt = _dtype_rtol(dtype)
    return [((((0, (interp_spec(stagger, m, rt),)),),), axis)
            for m, axis in ((nz, 2), (ny, 1), (nx, 0))]


def run_sweeps(sweeps, fields: Sequence[Tensor], *, plain: bool = False) -> list[Tensor]:
    """Run `sweeps` in order, each on the previous one's outputs."""
    run = _sweeper(plain)
    for program, axis in sweeps:
        fields = run(program, fields, axis)
    return fields


def grad(f: Tensor, deltas, *, plain: bool = False) -> Tensor:
    """Gradient tensor (nx, ny, nz, 3), cell->vertex: the three sweeps of
    :func:`grad_sweeps`, then the components stacked."""
    g = run_sweeps(grad_sweeps(f.shape, deltas, f.dtype), [f], plain=plain)
    return torch.stack(g, dim=-1)


def div(F: Tensor, deltas, *, plain: bool = False) -> Tensor:
    """Divergence, vertex->cell: the three sweeps of :func:`div_sweeps`."""
    comps = [F[..., k].contiguous() for k in range(3)]
    (out,) = run_sweeps(div_sweeps(F.shape[:3], deltas, F.dtype), comps, plain=plain)
    return out


def lapl_sweeps(shape, deltas, dtype):
    """The Laplacian's three (program, axis) sweeps, in order: each takes
    the previous one's outputs (the first, the field)."""
    dx, dy, dz = _deltas(deltas)
    nx, ny, nz = shape
    rt = _dtype_rtol(dtype)
    izz = (interp_spec(-1, nz, rt), interp_spec(+1, nz, rt))
    gzz = (grad_spec(dz, -1, nz, rt), grad_spec(dz, +1, nz, rt))
    iyy = (interp_spec(-1, ny, rt), interp_spec(+1, ny, rt))
    gyy = (grad_spec(dy, -1, ny, rt), grad_spec(dy, +1, ny, rt))
    ixx = (interp_spec(-1, nx, rt), interp_spec(+1, nx, rt))
    gxx = (grad_spec(dx, -1, nx, rt), grad_spec(dx, +1, nx, rt))
    return [((((0, izz),), ((0, gzz),)), 2),
            ((((0, iyy),), ((0, gyy), (1, iyy))), 1),
            ((((0, gxx), (1, ixx)),), 0)]


def lapl(f: Tensor, deltas, *, plain: bool = False) -> Tensor:
    """6th-order Laplacian div(grad(f)) in the regrouped form

        gx'gx (iy'iy iz'iz f) + ix'ix (gy'gy iz'iz f + iy'iy gz'gz f)

    (per-axis circulant operators commute): the z sweep makes a1 = iz'iz f
    and a3 = gz'gz f, the y sweep b1 = iy'iy a1 and b23 = gy'gy a1 +
    iy'iy a3, the x sweep gx'gx b1 + ix'ix b23 — 3 launches, 10 HBM
    passes."""
    return run_sweeps(lapl_sweeps(f.shape, deltas, f.dtype), [f], plain=plain)[0]


def op_1d(f: Tensor, spec, axis: int, *, plain: bool = False) -> Tensor:
    """Single compact operator along `axis` in the field's own layout: one
    launch, 1r 1w."""
    (out,) = _sweeper(plain)((((0, (spec,)),),), [f], axis)
    return out


def interp(f: Tensor, stagger: int = -1, *, plain: bool = False) -> Tensor:
    """Tri-directional interpolation, z then y then x: 3 launches."""
    return run_sweeps(interp_sweeps(f.shape, stagger, f.dtype), [f], plain=plain)[0]
