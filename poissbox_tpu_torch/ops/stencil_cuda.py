"""Hopper kernels of the 7-point stencil, the red-black SOR smoother and
CG's fused update.

The port of :mod:`poissbox_tpu.ops.stencil_pallas` for the kernels of the
7-point stack. Three CUDA kernels (``csrc/stencil7.cu``, ``csrc/rbsor.cu``,
``csrc/cgupd.cu``) cover these TPU kernels:

  ==========================  ======================================  ======
  wrapper                     Pallas counterpart                      TPU
  ==========================  ======================================  ======
  apply_laplacian_cuda        apply_laplacian_pallas;                 K1,
                              stencil_inplace.apply_laplacian_stream  K1'
  apply_laplacian_dot_cuda    apply_laplacian_dot_pallas;             K2,
                              stencil_inplace.apply_laplacian_dot_    K2'
                              stream
  pupdate_lapl_dot_cuda       pupdate_lapl_dot_pallas;                K12
                              stencil_inplace.pupdate_matvec_stream
  residual_cuda               residual_pallas                         K9
  chebyshev_first_cuda,       none: the JAX package's Chebyshev step  K9 +
  chebyshev_step_cuda         is jnp around K9 (solvers/mg.py:408)
  jacobi_sweep_cuda           jacobi_sweep_pallas                     K10
  sor_sweep_cuda              sor_sweep_pallas                        K11
  sor_rb_zero_sweep_cuda      sor_rb_zero_sweep_pallas                K3
  sor_rb_zero_update_cuda     sor_rb_zero_update_pallas               K5
  sor_rb_sweep_cuda           sor_rb_sweep_pallas (with ``dots``)     K4
  sor_rb_multisweep_cuda      sor_rb_multisweep_pallas                K4
  cg_fused_update_cuda        cg_fused_update                         K8
  ==========================  ======================================  ======

K11, one colour update, streams x planes through a (y, z) tile on KA's
grid (:func:`ka_blocks`), a thread a z-adjacent pair of cells, updating
the one of the colour; a sweep (K3, K4, K5) is ONE launch of KB's sweep
kernel, which recomputes the first colour on a halo of its tile instead
of storing it (``csrc/rbsor.cu``). K1'/K2', the
TPU's streamed matvec for fields of 256 MB and more, is KA's apply and
apply_dot out of place.

The multigrid transfer legs (K6, K7) are in
:mod:`poissbox_tpu_torch.ops.transfer_cuda`.

Each wrapper has a plain PyTorch version here, ``*_plain``, which follows
the Pallas formula and its grouping (not the roll path's). A tensor on the
CPU takes the plain version; a CUDA tensor launches the kernel or raises.
There is no fallback from a failed build or launch to the plain version.

bf16: the SOR colour update and sweeps take bfloat16 fields (the bf16
pre-smooth of the 512^3-class cycle), and K5 can store its swept iterate
narrow (``out_dtype``); so do the residual (K9), the Jacobi sweep (K10)
and the Chebyshev step, which the Chebyshev and multi-sweep Jacobi
pre-smooths reach. A bf16 value is upcast to float32, each colour update
(or residual, or Jacobi sweep) runs in float32 and rounds once where the
two-launch sweep
stored it (the sweep kernel rounds its first colour to the input dtype
before the second reads it); the plain versions round at the same stores.
This is the port's definition of the
bf16 result (the Pallas kernels compute in bf16 throughout). :data:`DTYPES`
says which mode takes which input dtype.

Launches count in :data:`poissbox_tpu_torch.ops._build.LAUNCHES` by
kernel and mode (``stencil7.*`` for the star's epilogues and K12's
prologue, ``stencil7.cheb`` for every Chebyshev step, ``rbsor.general``
for K11's colour update,
``rbsor.zero``/``sweep``/``dots``/``zero_update`` for KB's sweeps (one
launch a sweep: K3, K4, K4 with dots, K5), ``cgupd`` for K8; ``.bf16``
marks a bf16 launch, ``.narrow`` K5 storing its swept iterate in bf16);
:data:`LAUNCHES` and :func:`reset_launches` here are the same objects.
Reductions come back as per-block partials that the wrapper sums with
``torch.sum``, as the JAX wrappers sum theirs. KA streams x planes
through a (y, z) tile, as KB's sweeps and K6 do (:func:`ka_blocks`): one
partial a block, a few thousand at 512^3.
"""

from __future__ import annotations

from typing import Sequence

import torch

from poissbox_tpu_torch.ops import _build

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches

_EPI = {"stencil7.apply": 0, "stencil7.apply_dot": 1, "stencil7.residual": 2,
        "stencil7.jacobi": 3}
# KB's sweep modes (csrc/rbsor.cu SweepMode)
_SWEEP = {"rbsor.sweep": 0, "rbsor.dots": 1, "rbsor.zero": 2,
          "rbsor.zero_update": 3}
_WIDE = (torch.float32, torch.float64)
_WIDE_OR_BF16 = _WIDE + (torch.bfloat16,)
# the input dtypes each kernel mode of this module takes
DTYPES: dict[str, tuple] = {
    "stencil7.apply": _WIDE, "stencil7.apply_dot": _WIDE,
    "stencil7.pupd_dot": _WIDE,
    "stencil7.residual": _WIDE_OR_BF16, "stencil7.jacobi": _WIDE_OR_BF16,
    "stencil7.cheb": _WIDE_OR_BF16,
    "rbsor.general": _WIDE_OR_BF16, "rbsor.zero": _WIDE_OR_BF16,
    "rbsor.sweep": _WIDE_OR_BF16, "rbsor.zero_update": _WIDE,
    "rbsor.dots": _WIDE, "cgupd": _WIDE,
}


def check_dtype(mode: str, dtype: torch.dtype, dtypes: dict = DTYPES) -> None:
    """Raise TypeError unless kernel mode `mode` takes input `dtype`
    (`dtypes`: the wrapper's table of its modes, this module's by
    default)."""
    if dtype not in dtypes[mode]:
        names = ", ".join(str(d).replace("torch.", "") for d in dtypes[mode])
        raise TypeError(f"the CUDA kernel mode {mode} takes {names}, not "
                        f"{str(dtype).replace('torch.', '')}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (Pallas grouping)
# ---------------------------------------------------------------------------

def inv_squares(deltas: Sequence[float]) -> tuple[float, float, float]:
    return tuple(1.0 / float(d) ** 2 for d in deltas)


def _winv(invs, weight: float) -> float:
    """w / diag, diag = -2 sum(1/d^2) (negative), as the Pallas launchers
    compute it."""
    return float(weight) / (-2.0 * sum(invs))


def _pm1(c: torch.Tensor, axis: int) -> torch.Tensor:
    """c[i-1] + c[i+1] along `axis`, periodic (Pallas `_pm1_sum`)."""
    return torch.roll(c, 1, axis) + torch.roll(c, -1, axis)


def _star(u: torch.Tensor, invs) -> torch.Tensor:
    """The 7-point star in `_star_into`'s grouping (also `_star_ext`'s for
    non-cubic cells)."""
    ivx, ivy, ivz = invs
    acc = _pm1(u, 0) * ivx
    acc = acc + _pm1(u, 1) * ivy
    acc = acc + _pm1(u, 2) * ivz
    return acc - (2.0 * (ivx + ivy + ivz)) * u


def star_ext(u: torch.Tensor, invs) -> torch.Tensor:
    """The 7-point star in `_star_ext`'s grouping, the one K6 uses: for
    cubic cells the six-neighbour sum scaled once, s*ivx - (6*ivx)*u."""
    ivx, ivy, ivz = invs
    if ivx == ivy == ivz:
        s = (_pm1(u, 0) + _pm1(u, 1)) + _pm1(u, 2)
        return s * ivx - (6.0 * ivx) * u
    return _star(u, invs)


def _halfstep(x: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
              invs) -> torch.Tensor:
    """One masked SOR half-step, `_rb_halfstep`: c + w*(b - star(x)) with
    the weight field w = winv on the updated colour, 0 elsewhere."""
    ivx, ivy, ivz = invs
    if ivx == ivy == ivz:
        s = (_pm1(x, 0) + _pm1(x, 1)) + _pm1(x, 2)
        return x + w * ((b - ivx * s) + (6.0 * ivx) * x)
    return x + w * (b - _star(x, invs))


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The arithmetic form of a stored field: bf16 upcasts to float32."""
    return t.float() if t.dtype == torch.bfloat16 else t


def colour_parity(shape, device) -> torch.Tensor:
    """(i + j + k) % 2 of the global index; 0 is red."""
    i = torch.arange(shape[0], device=device).view(-1, 1, 1)
    j = torch.arange(shape[1], device=device).view(1, -1, 1)
    k = torch.arange(shape[2], device=device).view(1, 1, -1)
    return (i + j + k) % 2


def colour_mask(shape, colour: int, device) -> torch.Tensor:
    """(i + j + k) % 2 == colour as a bool field, written once: the parity
    of i + j on a 2-D plane broadcast against that of k, so no int64 field
    of the whole shape is built (a face plane, with its index along the
    face's axis fixed, takes the same call)."""
    i = torch.arange(shape[0], device=device).view(-1, 1, 1)
    j = torch.arange(shape[1], device=device).view(1, -1, 1)
    k = torch.arange(shape[2], device=device).view(1, 1, -1)
    return ((i + j) & 1) == ((k & 1) ^ int(colour))


def _colour_weights(b: torch.Tensor, winv: float, reverse: bool):
    """(w1, w2): the masked weight fields of the first and second colour."""
    c0, c1 = _colours(reverse)
    return _colour_weight(b, winv, c0), _colour_weight(b, winv, c1)


def _colours(reverse: bool) -> tuple[int, int]:
    return (1, 0) if reverse else (0, 1)


def apply_laplacian_plain(u, deltas):
    return _star(u, inv_squares(deltas))


def apply_laplacian_dot_plain(u, deltas):
    y = _star(u, inv_squares(deltas))
    return y, torch.sum(u * y)


def pupdate_lapl_dot_plain(v, p_old, beta, zshift, deltas):
    """(p', A p', <p', A p'>) for p' = (v - zshift) + beta * p_old, in
    `_pupd_lapl_dot_kernel_fy`'s grouping."""
    pn = (v - zshift) + beta * p_old
    y = _star(pn, inv_squares(deltas))
    return pn, y, torch.sum(pn * y)


def residual_plain(u, b, deltas):
    """bf16 fields: computed in float32, rounded once at the store."""
    return (_wide(b) - _star(_wide(u), inv_squares(deltas))).to(u.dtype)


def jacobi_sweep_plain(u, b, deltas, weight):
    """u + winv*(b - A u), `_upd_jacobi` on `_star_into`'s star; bf16
    fields are computed in float32 and rounded once at the store."""
    invs = inv_squares(deltas)
    uw = _wide(u)
    return (uw + _winv(invs, weight) * (_wide(b) - _star(uw, invs))).to(u.dtype)


def chebyshev_first_plain(x, b, deltas, theta):
    """(x + d', d') for d' = r / theta, r = b - A x as
    :func:`residual_plain` gives it: the Chebyshev smoother's first step
    from a given x, in torch's ops, whose roundings the kernel takes."""
    d = residual_plain(x, b, deltas) / theta
    return x + d, d


def chebyshev_step_plain(x, b, d, deltas, c1, c2, store_d=True):
    """(x + d', d') for d' = c1 d + c2 r, r = b - A x as
    :func:`residual_plain` gives it (x + d' alone without `store_d`): a
    middle or the last step of the Chebyshev smoother, in torch's ops. x
    may be d itself."""
    d = c1 * d + c2 * residual_plain(x, b, deltas)
    x = x + d
    return (x, d) if store_d else x


def _colour_weight(b: torch.Tensor, winv: float, colour: int) -> torch.Tensor:
    """winv where the parity is `colour`, 0 elsewhere (`_color_weight`)."""
    par = colour_parity(b.shape, b.device)
    wt = torch.tensor(winv, dtype=b.dtype, device=b.device)
    return torch.where(par == colour, wt, torch.zeros((), dtype=b.dtype,
                                                      device=b.device))


def sor_sweep_plain(u, b, deltas, weight, color):
    """One colour update (K11): the points of parity `color` get
    x + winv (b - A x), the others are copied, in `_rb_halfstep`'s grouping
    (KB's general mode); bf16 fields compute in float32 and round at the
    store."""
    invs = inv_squares(deltas)
    bw = _wide(b)
    w = _colour_weight(bw, _winv(invs, weight), color)
    return _halfstep(_wide(u), bw, w, invs).to(u.dtype)


def sor_rb_zero_sweep_plain(b, deltas, weight, reverse=False):
    """A bf16 b: each colour computes in float32 and rounds at its store."""
    invs = inv_squares(deltas)
    bw = _wide(b)
    w1, w2 = _colour_weights(bw, _winv(invs, weight), reverse)
    x1 = (w1 * bw).to(b.dtype)
    return _halfstep(_wide(x1), bw, w2, invs).to(b.dtype)


def sor_rb_zero_update_plain(r, ap, alpha, deltas, weight, reverse=False,
                             out_dtype=None):
    """`out_dtype` rounds the swept iterate once, at its store."""
    invs = inv_squares(deltas)
    a = torch.as_tensor(alpha, dtype=r.dtype, device=r.device)
    b = r - a * ap
    w1, w2 = _colour_weights(b, _winv(invs, weight), reverse)
    x = _halfstep(w1 * b, b, w2, invs)
    if out_dtype is not None:
        x = x.to(out_dtype)
    return b, x, torch.sum(b * b), torch.sum(b)


def sor_rb_sweep_plain(u, b, deltas, weight, reverse=False, dots=False):
    """bf16 fields: each colour computes in float32 and rounds at its
    store."""
    c0, c1 = _colours(reverse)
    x1 = sor_sweep_plain(u, b, deltas, weight, c0)
    x = sor_sweep_plain(x1, b, deltas, weight, c1)
    return (x, torch.sum(x * b), torch.sum(x)) if dots else x


def sor_rb_multisweep_plain(u, b, deltas, weight, nsweeps, reverse=False,
                            dots=False):
    for k in range(nsweeps):
        last = k == nsweeps - 1
        u = sor_rb_sweep_plain(u, b, deltas, weight, reverse, dots and last)
        if dots and last:
            return u
    return (u, torch.sum(u * b), torch.sum(u)) if dots else u


def cg_fused_update_plain(alpha, x, p, r, ap):
    """(x + alpha*p, r - alpha*Ap, ||r'||^2, sum(r')), `_cg_update_kernel`."""
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    rn = r - a * ap
    return x + a * p, rn, torch.sum(rn * rn), torch.sum(rn)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _check(mode: str, *ts: torch.Tensor) -> None:
    """What kernel mode `mode` takes: contiguous 3-D fields of one shape
    and one dtype, a dtype listed for `mode` in :data:`DTYPES`, on one
    CUDA device."""
    t0 = ts[0]
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if t.device != t0.device:
            raise ValueError(f"tensors on {t0.device} and {t.device}")
        if t.dtype != t0.dtype or t.shape != t0.shape or t.dim() != 3:
            raise ValueError(f"expected matching 3-D fields, got {t0.dtype} "
                             f"{tuple(t0.shape)} and {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous fields")
    check_dtype(mode, t0.dtype)


# KA's geometry (csrc/stencil7.cu ka_chunk, csrc/common.cuh): a block owns
# a TILE_Z x TILE_Y (z, y) tile and walks a chunk of x planes
TILE_Z, TILE_Y, KA_MIN_BLOCKS = 32, 16, 4096


def ka_blocks(shape) -> tuple[int, int, int, int]:
    """KA's launch over a field of `shape`: (blocks along z, along y,
    along x, x planes a block walks), the chunk halved from 128 until the
    grid holds KA_MIN_BLOCKS blocks, but not below 4. One dot partial a
    block. K11's colour update takes the same grid."""
    nx, ny, nz = shape
    gz, gy = -(-nz // TILE_Z), -(-ny // TILE_Y)
    chunk = 128
    while chunk > 4 and gz * gy * -(-nx // chunk) < KA_MIN_BLOCKS:
        chunk //= 2
    return gz, gy, -(-nx // chunk), chunk


def _partials(u: torch.Tensor) -> torch.Tensor:
    """One slot per block of KA's launch over u's grid."""
    gz, gy, gx, _ = ka_blocks(u.shape)
    return torch.empty(gz * gy * gx, dtype=u.dtype, device=u.device)


def _stencil7(key: str, u, b, y, part, deltas, weight: float = 0.0) -> None:
    invs = inv_squares(deltas)
    ivx, ivy, ivz = invs
    epi = _EPI[key]
    if u.dtype == torch.bfloat16:
        key += ".bf16"
    ptr = _build.ptr
    _build.launch(
        "poissbox_stencil7", key, _build.DTYPE_CODE[u.dtype], epi, u.device.index or 0,
        _build.stream(u), ptr(u), ptr(b), ptr(y), ptr(part), *u.shape, ivx, ivy, ivz,
        2.0 * (ivx + ivy + ivz), _winv(invs, weight))


def _coefs(deltas, weight) -> tuple:
    """(ivx, ivy, ivz, center, 6*ivx, winv) and iso, as KB takes them."""
    invs = inv_squares(deltas)
    ivx, ivy, ivz = invs
    return ((ivx, ivy, ivz, 2.0 * (ivx + ivy + ivz), 6.0 * ivx,
             _winv(invs, weight)), int(ivx == ivy == ivz))


def _sweep(mode: str, like, out, reverse: bool, deltas, weight, *, x=None,
           b=None, r=None, ap=None, alpha=None, bout=None,
           sums: bool = False):
    """One launch of KB's sweep kernel; `like` carries the input dtype,
    `out` the output dtype. With `sums`, returns the two reductions
    (their per-block partials summed)."""
    part0 = part1 = None
    if sums:
        nblk = _build.load().poissbox_rbsor_sweep_blocks(*like.shape)
        part0, part1 = (torch.empty(nblk, dtype=like.dtype, device=like.device)
                        for _ in range(2))
    coefs, iso = _coefs(deltas, weight)
    key = mode
    if like.dtype == torch.bfloat16:
        key += ".bf16"
    elif out.dtype != like.dtype:
        key += ".narrow"
    ptr = _build.ptr
    code = _build.DTYPE_CODE
    _build.launch(
        "poissbox_rbsor_sweep", key, code[like.dtype], code[out.dtype], _SWEEP[mode], iso,
        like.device.index or 0, _build.stream(like), ptr(x), ptr(b), ptr(r),
        ptr(ap), ptr(alpha), ptr(out), ptr(bout), ptr(part0), ptr(part1), *like.shape, *coefs,
        _colours(reverse)[0])
    if sums:
        return torch.sum(part0), torch.sum(part1)
    return None


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def apply_laplacian_cuda(u: torch.Tensor, deltas) -> torch.Tensor:
    """y = A u, the periodic 7-point Laplacian (K1)."""
    if _on_cpu(u):
        return apply_laplacian_plain(u, deltas)
    _check("stencil7.apply", u)
    y = torch.empty_like(u)
    _stencil7("stencil7.apply", u, None, y, None, deltas)
    return y


def apply_laplacian_dot_cuda(u: torch.Tensor, deltas):
    """(A u, <u, A u>) in one pass (K2)."""
    if _on_cpu(u):
        return apply_laplacian_dot_plain(u, deltas)
    _check("stencil7.apply_dot", u)
    y = torch.empty_like(u)
    part = _partials(u)
    _stencil7("stencil7.apply_dot", u, None, y, part, deltas)
    return y, torch.sum(part)


def pupdate_lapl_dot_cuda(v: torch.Tensor, p_old: torch.Tensor, beta, zshift,
                          deltas):
    """(p', A p', <p', A p'>) with p' = (v - zshift) + beta * p_old in one
    pass (K12): CG's search-direction update formed inside the matvec.
    beta and zshift (0-d device tensors or numbers) are read on the device;
    v and p_old stay untouched."""
    if _on_cpu(v):
        return pupdate_lapl_dot_plain(v, p_old, beta, zshift, deltas)
    _check("stencil7.pupd_dot", v, p_old)
    sc = torch.stack([torch.as_tensor(beta, dtype=v.dtype, device=v.device),
                      torch.as_tensor(zshift, dtype=v.dtype, device=v.device)])
    pn, y = torch.empty_like(v), torch.empty_like(v)
    part = _partials(v)
    ivx, ivy, ivz = inv_squares(deltas)
    ptr = _build.ptr
    _build.launch(
        "poissbox_pupd_dot", "stencil7.pupd_dot", _build.DTYPE_CODE[v.dtype],
        v.device.index or 0, _build.stream(v), ptr(v), ptr(p_old), ptr(sc), ptr(pn), ptr(y),
        ptr(part), *v.shape, ivx, ivy, ivz, 2.0 * (ivx + ivy + ivz))
    return pn, y, torch.sum(part)


def residual_cuda(u: torch.Tensor, b: torch.Tensor, deltas) -> torch.Tensor:
    """r = b - A u (K9); u and b may be bf16 (r is then bf16)."""
    if _on_cpu(u):
        return residual_plain(u, b, deltas)
    _check("stencil7.residual", u, b)
    y = torch.empty_like(u)
    _stencil7("stencil7.residual", u, b, y, None, deltas)
    return y


def jacobi_sweep_cuda(u: torch.Tensor, b: torch.Tensor, deltas,
                      weight: float) -> torch.Tensor:
    """One damped-Jacobi sweep u + (w/diag)(b - A u) (K10); u and b may
    be bf16."""
    if _on_cpu(u):
        return jacobi_sweep_plain(u, b, deltas, weight)
    _check("stencil7.jacobi", u, b)
    y = torch.empty_like(u)
    _stencil7("stencil7.jacobi", u, b, y, None, deltas, weight)
    return y


def _cheb(kind: int, x, b, d, xout, dout, deltas, c1: float, c2: float) -> None:
    """One launch of KA's Chebyshev epilogue `kind` (0 first, 1 middle, 2
    last); d None: d is x."""
    ivx, ivy, ivz = inv_squares(deltas)
    key = "stencil7.cheb" + (".bf16" if x.dtype == torch.bfloat16 else "")
    ptr = _build.ptr
    _build.launch(
        "poissbox_cheb", key, _build.DTYPE_CODE[x.dtype], kind, x.device.index or 0,
        _build.stream(x), ptr(x), ptr(b), ptr(d), ptr(xout), ptr(dout), *x.shape, ivx, ivy,
        ivz, 2.0 * (ivx + ivy + ivz), float(c1), float(c2))


def chebyshev_first_cuda(x: torch.Tensor, b: torch.Tensor, deltas, theta: float):
    """(x', d') = (x + d', d'), d' = (b - A x) / theta, in one launch: the
    Chebyshev smoother's first step from a given x (K9 and the recurrence
    in KA's Chebyshev epilogue, bit-equal to :func:`chebyshev_first_plain`
    on the card). x and b may be bf16; both outputs are new tensors."""
    if _on_cpu(x):
        return chebyshev_first_plain(x, b, deltas, theta)
    _check("stencil7.cheb", x, b)
    xo, do = torch.empty_like(x), torch.empty_like(x)
    _cheb(0, x, b, None, xo, do, deltas, 0.0, theta)
    return xo, do


def chebyshev_step_cuda(x: torch.Tensor, b: torch.Tensor, d: torch.Tensor, deltas,
                        c1: float, c2: float, store_d: bool = True):
    """(x', d') = (x + d', d'), d' = c1 d + c2 (b - A x), in one launch: a
    middle Chebyshev step, or with `store_d=False` the last, which returns
    x' alone and writes no d'. Bit-equal to :func:`chebyshev_step_plain` on
    the card. x, b and d may be bf16. d may be x itself (the step after the
    first from zero), and is then read once; the outputs are new tensors,
    so neither input is written while the other is read."""
    if _on_cpu(x):
        return chebyshev_step_plain(x, b, d, deltas, c1, c2, store_d)
    _check("stencil7.cheb", x, b, d)
    xo = torch.empty_like(x)
    do = torch.empty_like(x) if store_d else None
    same = d.data_ptr() == x.data_ptr()
    _cheb(1 if store_d else 2, x, b, None if same else d, xo, do, deltas, c1, c2)
    return (xo, do) if store_d else xo


def sor_sweep_cuda(u: torch.Tensor, b: torch.Tensor, deltas, weight: float,
                   color: int) -> torch.Tensor:
    """One red-black colour update (K11, KB's general mode): the points of
    parity `color` (0 = red, (i+j+k) even) get x + winv (b - A x), the
    others are copied. u and b may be bf16. One launch on KA's grid
    (:func:`ka_blocks`)."""
    if _on_cpu(u):
        return sor_sweep_plain(u, b, deltas, weight, color)
    _check("rbsor.general", u, b)
    x = torch.empty_like(u)
    coefs, iso = _coefs(deltas, weight)
    key = "rbsor.general" + (".bf16" if u.dtype == torch.bfloat16 else "")
    ptr = _build.ptr
    _build.launch(
        "poissbox_rbsor_colour", key, _build.DTYPE_CODE[u.dtype], iso, u.device.index or 0,
        _build.stream(u), ptr(u), ptr(b), ptr(x), *u.shape, *coefs, int(color))
    return x


def sor_rb_zero_sweep_cuda(b: torch.Tensor, deltas, weight: float,
                           reverse: bool = False) -> torch.Tensor:
    """One red-black sweep from x = 0 (K3), one launch: the first colour is
    winv * mask * b, the second a general colour update. b may be bf16."""
    if _on_cpu(b):
        return sor_rb_zero_sweep_plain(b, deltas, weight, reverse)
    _check("rbsor.zero", b)
    x = torch.empty_like(b)
    _sweep("rbsor.zero", b, x, reverse, deltas, weight, b=b)
    return x


def sor_rb_zero_update_cuda(r: torch.Tensor, ap: torch.Tensor, alpha,
                            deltas, weight: float, reverse: bool = False,
                            out_dtype=None):
    """(b, x1, ||b||^2, sum(b)) with b = r - alpha*Ap and x1 the zero-guess
    sweep for A x = b (K5): CG's residual update fused into the V-cycle's
    first kernel. r and Ap stay untouched: both are still live in the
    caller (CG keeps r until the iteration ends). One launch. `out_dtype`
    (bf16) stores x1 narrow: the second colour reads float32 and writes
    bf16."""
    if _on_cpu(r):
        return sor_rb_zero_update_plain(r, ap, alpha, deltas, weight, reverse,
                                        out_dtype)
    _check("rbsor.zero_update", r, ap)
    a = torch.as_tensor(alpha, dtype=r.dtype, device=r.device).reshape(1)
    b = torch.empty_like(r)
    x = torch.empty_like(r, dtype=out_dtype or r.dtype)
    rr, sr = _sweep("rbsor.zero_update", r, x, reverse, deltas, weight, r=r,
                    ap=ap, alpha=a, bout=b, sums=True)
    return b, x, rr, sr


def sor_rb_sweep_cuda(u: torch.Tensor, b: torch.Tensor, deltas,
                      weight: float, reverse: bool = False,
                      dots: bool = False):
    """One red-black sweep, both colours, one launch (K4); u and b may be
    bf16. `dots=True` (float32/float64) also returns (<x_out, b>,
    sum(x_out)), taken as the second colour is stored."""
    if _on_cpu(u):
        return sor_rb_sweep_plain(u, b, deltas, weight, reverse, dots)
    mode = "rbsor.dots" if dots else "rbsor.sweep"
    _check(mode, u, b)
    x = torch.empty_like(u)
    sums = _sweep(mode, u, x, reverse, deltas, weight, x=u, b=b, sums=dots)
    return (x, *sums) if dots else x


def sor_rb_multisweep_cuda(u: torch.Tensor, b: torch.Tensor, deltas,
                           weight: float, nsweeps: int,
                           reverse: bool = False, dots: bool = False):
    """`nsweeps` red-black sweeps; `dots` as in :func:`sor_rb_sweep_cuda`,
    taken in the last sweep."""
    for k in range(nsweeps):
        last = k == nsweeps - 1
        u = sor_rb_sweep_cuda(u, b, deltas, weight, reverse, dots and last)
        if dots and last:
            return u
    if dots:
        # nsweeps == 0 only
        return u, torch.sum(u * b), torch.sum(u)
    return u


def cg_fused_update_cuda(alpha, x: torch.Tensor, p: torch.Tensor,
                         r: torch.Tensor, ap: torch.Tensor):
    """(x + alpha*p, r - alpha*Ap, ||r'||^2, sum(r')) in one pass over the
    four fields (K8); alpha is read on the device. No input is written."""
    if _on_cpu(x):
        return cg_fused_update_plain(alpha, x, p, r, ap)
    _check("cgupd", x, p, r, ap)
    dev = x.device.index or 0
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device).reshape(1)
    xo, ro = torch.empty_like(x), torch.empty_like(r)
    nblk = _build.load().poissbox_cgupd_blocks(x.numel(), dev)
    prr = torch.empty(nblk, dtype=x.dtype, device=x.device)
    psr = torch.empty(nblk, dtype=x.dtype, device=x.device)
    ptr = _build.ptr
    _build.launch("poissbox_cgupd", "cgupd", _build.DTYPE_CODE[x.dtype], dev, _build.stream(x),
                  ptr(a), ptr(x), ptr(p), ptr(r), ptr(ap), ptr(xo), ptr(ro), ptr(prr),
                  ptr(psr), x.numel())
    return xo, ro, torch.sum(prr), torch.sum(psr)
