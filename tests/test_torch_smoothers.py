"""The port's red-black SOR and Jacobi kernels (plain versions) and MG
smoothers against the JAX package.

K3 (zero-guess sweep), K4 (sweep, with and without the dots), K5 (zero
sweep with CG's update fused in) and K10 (Jacobi sweep) are held to the
Pallas kernels in interpret mode, both colour orders, at 16^3, 32^3 and a
grid with three different spacings; so are the bf16 forms of K3 and K5.
The roll-path smoothers are held to the JAX roll path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.ops import stencil_pallas as jpallas
from poissbox_tpu.solvers import mg as jmg
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import gmres_cuda, stencil_cuda, transfer_cuda
from poissbox_tpu_torch.solvers import mg

GRIDS = [((16, 16, 16), (1.0, 1.0, 1.0)),
         ((32, 32, 32), (1.0, 1.0, 1.0)),
         ((16, 8, 12), (1.0, 0.75, 1.5))]
GRID_IDS = ["16^3", "32^3", "aniso"]
RTOL, ATOL = 1e-12, 1e-13
W = 1.0


def fields(shape, seed, k):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape) for _ in range(k)]


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_zero_sweep_plain_matches_pallas(shape, length, reverse):
    """K3."""
    (b,) = fields(shape, 11, 1)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = jpallas.sor_rb_zero_sweep_pallas(jnp.asarray(b), d, W, reverse=reverse)
    close(stencil_cuda.sor_rb_zero_sweep_plain(t(b), d, W, reverse).numpy(), ref)


@pytest.mark.parametrize("dots", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_sweep_plain_matches_pallas(shape, length, reverse, dots):
    """K4, with and without the <x, b>, sum(x) partials."""
    u, b = fields(shape, 12, 2)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = jpallas.sor_rb_sweep_pallas(jnp.asarray(u), jnp.asarray(b), d, W,
                                      reverse=reverse, dots=dots)
    got = stencil_cuda.sor_rb_sweep_plain(t(u), t(b), d, W, reverse, dots)
    if not dots:
        close(got.numpy(), ref)
        return
    close(got[0].numpy(), ref[0])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-11)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-11)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_zero_update_plain_matches_pallas(shape, length, reverse):
    """K5: b = r - alpha*Ap formed, written, reduced, then swept."""
    r, ap = fields(shape, 13, 2)
    alpha = 0.41
    d = Grid3D(shape, length, device="cpu").deltas
    rb, rx, rrr, rsr = jpallas.sor_rb_zero_update_pallas(
        jnp.asarray(r), jnp.asarray(ap), alpha, d, W, reverse=reverse)
    b, x, rr, sr = stencil_cuda.sor_rb_zero_update_plain(
        t(r), t(ap), torch.tensor(alpha, dtype=torch.float64), d, W, reverse)
    close(b.numpy(), rb)
    close(x.numpy(), rx)
    np.testing.assert_allclose(float(rr), float(rrr), rtol=1e-11)
    # sum(b) of zero-mean noise: relative to the sum of |b|
    np.testing.assert_allclose(float(sr), float(rsr), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(rb)).sum())


@pytest.mark.parametrize("nsweeps", [0, 2])
def test_multisweep_plain_matches_pallas(nsweeps):
    u, b = fields((16, 16, 16), 14, 2)
    d = (1.0 / 16,) * 3
    ref = jpallas.sor_rb_multisweep_pallas(jnp.asarray(u), jnp.asarray(b), d,
                                           W, nsweeps, reverse=True, dots=True)
    got = stencil_cuda.sor_rb_multisweep_plain(t(u), t(b), d, W, nsweeps,
                                               reverse=True, dots=True)
    close(got[0].numpy(), ref[0])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-11)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-11)
    # the wrapper on CPU tensors is the plain version
    wrapped = stencil_cuda.sor_rb_multisweep_cuda(t(u), t(b), d, W, nsweeps,
                                                  reverse=True, dots=True)
    for a, c in zip(wrapped, got):
        assert torch.equal(a, c)


def test_sor_wrappers_take_plain_version_on_cpu():
    r, ap, u = (t(a) for a in fields((8, 8, 8), 15, 3))
    d = (0.125,) * 3
    alpha = torch.tensor(0.3, dtype=torch.float64)
    stencil_cuda.reset_launches()
    assert torch.equal(stencil_cuda.sor_rb_zero_sweep_cuda(r, d, W, True),
                       stencil_cuda.sor_rb_zero_sweep_plain(r, d, W, True))
    for a, c in zip(stencil_cuda.sor_rb_zero_update_cuda(r, ap, alpha, d, W),
                    stencil_cuda.sor_rb_zero_update_plain(r, ap, alpha, d, W)):
        assert torch.equal(a, c)
    for a, c in zip(stencil_cuda.sor_rb_sweep_cuda(u, r, d, W, dots=True),
                    stencil_cuda.sor_rb_sweep_plain(u, r, d, W, dots=True)):
        assert torch.equal(a, c)
    assert not any(stencil_cuda.LAUNCHES.values())


def _levels(shape, length):
    d = Grid3D(shape, length, device="cpu").deltas
    return (mg._build_levels(shape, d, mg.MGConfig()),
            jmg._build_levels(shape, d, jmg.MGConfig()))


@pytest.mark.parametrize("smoother", ["sor", "jacobi", "chebyshev"])
@pytest.mark.parametrize("zero_guess", [True, False])
def test_roll_smoothers_match_jax(smoother, zero_guess):
    shape, length = (16, 8, 12), (1.0, 0.75, 1.5)
    (lvl, *_), (jlvl, *_) = _levels(shape, length)
    x, b = fields(shape, 16, 2)
    cfg = mg.MGConfig(smoother=smoother, impl="roll")
    jcfg = jmg.MGConfig(smoother=smoother, impl="roll")
    got = mg._smooth(None if zero_guess else t(x), t(b), lvl, cfg, 2,
                     reverse=True)
    ref = jax.jit(lambda xx, bb: jmg._smooth(xx, bb, jlvl, jcfg, 2, reverse=True))(
        None if zero_guess else jnp.asarray(x), jnp.asarray(b))
    close(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("impl", ["roll", "cuda"])
def test_zero_sweeps_are_exact_noops(impl):
    shape = (8, 8, 8)
    (lvl, *_), _ = _levels(shape, (1.0, 1.0, 1.0))
    x, b = (t(a) for a in fields(shape, 17, 2))
    cfg = mg.MGConfig(impl=impl)
    assert torch.equal(mg._smooth(None, b, lvl, cfg, 0, False),
                       torch.zeros_like(b))
    assert mg._smooth(x, b, lvl, cfg, 0, True) is x
    with pytest.raises(ValueError):
        mg._smooth(x, b, lvl, cfg, -1, True)


def test_kernel_smoother_matches_pallas_smoother():
    """The impl='cuda' SOR smoother (plain versions on CPU) against the
    JAX impl='pallas' smoother, zero guess and from an iterate, with dots."""
    shape, length = (16, 16, 16), (1.0, 1.0, 1.0)
    (lvl, *_), (jlvl, *_) = _levels(shape, length)
    x, b = fields(shape, 18, 2)
    cfg, jcfg = mg.MGConfig(impl="cuda"), jmg.MGConfig(impl="pallas")
    close(mg._smooth(None, t(b), lvl, cfg, 3, False).numpy(),
          jmg._smooth(None, jnp.asarray(b), jlvl, jcfg, 3, False))
    got = mg._smooth(t(x), t(b), lvl, cfg, 2, True, dots=True)
    ref = jmg._smooth(jnp.asarray(x), jnp.asarray(b), jlvl, jcfg, 2, True,
                      dots=True)
    close(got[0].numpy(), ref[0])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-11)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-11)


def test_jacobi_kernel_not_ported_raises():
    """The Jacobi smoother on the kernel path, which raised until K10 was
    ported: the impl='cuda' smoother (K10's plain version on CPU) against
    the JAX impl='pallas' smoother, zero guess and from an iterate."""
    shape, length = (16, 8, 12), (1.0, 0.75, 1.5)
    (lvl, *_), (jlvl, *_) = _levels(shape, length)
    x, b = fields(shape, 19, 2)
    cfg = mg.MGConfig(smoother="jacobi", impl="cuda", damping=0.8)
    jcfg = jmg.MGConfig(smoother="jacobi", impl="pallas", damping=0.8)
    for guess in (None, x):
        got = mg._smooth(None if guess is None else t(guess), t(b), lvl, cfg,
                         3, False)
        ref = jmg._smooth(None if guess is None else jnp.asarray(guess),
                          jnp.asarray(b), jlvl, jcfg, 3, False)
        close(got.numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_jacobi_plain_matches_pallas(shape, length):
    """K10: u + (w/diag)(b - A u)."""
    u, b = fields(shape, 20, 2)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = jpallas.jacobi_sweep_pallas(jnp.asarray(u), jnp.asarray(b), d, 8 / 9)
    close(stencil_cuda.jacobi_sweep_plain(t(u), t(b), d, 8 / 9).numpy(), ref)


# bf16 K3 against the Pallas kernel: Pallas rounds every intermediate of
# both colours to bf16, the port each colour's result once (its stated
# bf16 definition), so the two differ by a few bf16 ulps of max|x|
# (at most 0.0079 of it on these inputs)
BF16_PALLAS_TOL = 2.0 ** -6


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_zero_sweep_bf16_plain_matches_pallas(shape, length, reverse):
    """K3 on a bf16 right-hand side (the bf16 pre-smooth)."""
    (b,) = fields(shape, 21, 1)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = np.asarray(jpallas.sor_rb_zero_sweep_pallas(
        jnp.asarray(b, jnp.bfloat16), d, W, reverse=reverse)).astype(np.float32)
    got = stencil_cuda.sor_rb_zero_sweep_plain(t(b).to(torch.bfloat16), d, W,
                                               reverse)
    assert got.dtype == torch.bfloat16
    close(got.float().numpy(), ref, rtol=0,
          atol=BF16_PALLAS_TOL * np.abs(ref).max())


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_zero_update_narrow_plain_matches_pallas(shape, length):
    """K5 with out_dtype=bf16: b, the sums and the sweep in f32, x1
    stored in bf16 (one rounding on both sides)."""
    r, ap = (a.astype(np.float32) for a in fields(shape, 22, 2))
    alpha = np.float32(0.41)
    d = Grid3D(shape, length, device="cpu").deltas
    rb, rx, rrr, _ = jpallas.sor_rb_zero_update_pallas(
        jnp.asarray(r), jnp.asarray(ap), jnp.asarray(alpha), d, W,
        out_dtype=jnp.bfloat16)
    b, x, rr, _ = stencil_cuda.sor_rb_zero_update_plain(
        t(r), t(ap), torch.tensor(alpha), d, W, out_dtype=torch.bfloat16)
    assert b.dtype == torch.float32 and x.dtype == torch.bfloat16
    close(b.numpy(), rb, rtol=0, atol=1e-6)
    rx = np.asarray(rx).astype(np.float32)
    close(x.float().numpy(), rx, rtol=0, atol=2.0 ** -7 * np.abs(rx).max())
    np.testing.assert_allclose(float(rr), float(rrr), rtol=1e-5)


@pytest.mark.parametrize("smoother,sweeps", [("chebyshev", 1), ("chebyshev", 2),
                                             ("jacobi", 2), ("jacobi", 3)])
def test_bf16_presmooth_on_ka_k10_matches_pallas(smoother, sweeps):
    """The bf16 pre-smooths that reach KA's residual (Chebyshev) and K10
    (Jacobi with two or more sweeps), forced with pre_dtype='bfloat16':
    the impl='cuda' smoother (plain versions on CPU: f32 arithmetic, one
    rounding at each kernel store) against the JAX impl='pallas' smoother
    (bf16 throughout), within BF16_PALLAS_TOL of max|x|."""
    shape, length = (16, 16, 16), (1.0, 1.0, 1.0)
    (lvl, *_), (jlvl, *_) = _levels(shape, length)
    (b,) = fields(shape, 24, 1)
    kw = dict(smoother=smoother, pre_dtype="bfloat16")
    cfg = mg.MGConfig(impl="cuda", **kw)
    jcfg = jmg.MGConfig(impl="pallas", **kw)
    got = mg._smooth(None, t(b).to(torch.bfloat16), lvl, cfg, sweeps, False)
    ref = np.asarray(jax.jit(lambda bb: jmg._smooth(None, bb, jlvl, jcfg, sweeps,
                                                    False))(
        jnp.asarray(b, jnp.bfloat16))).astype(np.float32)
    assert got.dtype == torch.bfloat16
    close(got.float().numpy(), ref, rtol=0,
          atol=BF16_PALLAS_TOL * np.abs(ref).max())


def test_bf16_sweep_plain_rounds_once_per_colour():
    """The port's bf16 sweep: each colour computes in f32 and rounds at
    its store, so it stays within two bf16 roundings (2^-7 of max|x|) of
    the f32 sweep on the same bf16 inputs."""
    u, b = (t(a).to(torch.bfloat16) for a in fields((16, 8, 12), 23, 2))
    d = Grid3D((16, 8, 12), (1.0, 0.75, 1.5), device="cpu").deltas
    got = stencil_cuda.sor_rb_sweep_plain(u, b, d, W, reverse=True)
    ref = stencil_cuda.sor_rb_sweep_plain(u.float(), b.float(), d, W, reverse=True)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


def test_kernel_dtype_table():
    """bf16 where a kernel takes it (KB zero/general, the transfer legs'
    iterate, KA's residual and Jacobi epilogues), refused where none does
    (KA's apply forms, K8, K5's inputs, KB dots)."""
    bf16 = torch.bfloat16
    for mode in ("rbsor.zero", "rbsor.general", "stencil7.residual", "stencil7.jacobi"):
        stencil_cuda.check_dtype(mode, bf16)
    for mode in ("xfer.restrict", "xfer.prolong_add"):
        stencil_cuda.check_dtype(mode, bf16, transfer_cuda.DTYPES)
    for mode in ("stencil7.apply", "stencil7.apply_dot", "cgupd",
                 "rbsor.zero_update", "rbsor.dots"):
        with pytest.raises(TypeError, match="bfloat16"):
            stencil_cuda.check_dtype(mode, bf16)
    for table in (stencil_cuda.DTYPES, transfer_cuda.DTYPES, gmres_cuda.DTYPES):
        for mode in table:
            for dt in (torch.float32, torch.float64):
                stencil_cuda.check_dtype(mode, dt, table)
            with pytest.raises(TypeError):
                stencil_cuda.check_dtype(mode, torch.float16, table)


# ---------------------------------------------------------------------------
# KB's one-launch sweep (csrc/rbsor.cu sweep_kernel): its premise on the CPU
# ---------------------------------------------------------------------------

def kernel_tile(shape, start=32):
    """(chunk, 16, 32): the x planes and (y, z) tile of a sweep block, as
    csrc/common.cuh tile_chunk picks them."""
    nx, ny, nz = shape
    tiles = -(-nz // 32) * -(-ny // 16)
    c = start
    while c > 4 and tiles * -(-nx // c) < 2048:
        c //= 2
    return c, 16, 32


def _window(f, lo, n, shape):
    """f on planes/rows/columns lo[a] .. lo[a] + n[a] - 1, every index
    wrapped (a halo wider than the extent wraps more than once)."""
    idx = [torch.arange(lo[a], lo[a] + n[a]) % shape[a] for a in range(3)]
    return f[idx[0]][:, idx[1]][:, :, idx[2]], idx


def _update(x, b, invs, winv):
    """c + winv (b - A x) on the interior of window x, _rb_halfstep's
    grouping (b already on the interior)."""
    ivx, ivy, ivz = invs
    c = x[1:-1, 1:-1, 1:-1]
    xm, xp = x[:-2, 1:-1, 1:-1], x[2:, 1:-1, 1:-1]
    ym, yp = x[1:-1, :-2, 1:-1], x[1:-1, 2:, 1:-1]
    zm, zp = x[1:-1, 1:-1, :-2], x[1:-1, 1:-1, 2:]
    if ivx == ivy == ivz:
        s = ((xm + xp) + (ym + yp)) + (zm + zp)
        res = (b - ivx * s) + (6.0 * ivx) * c
    else:
        acc = (xm + xp) * ivx
        acc = acc + (ym + yp) * ivy
        acc = acc + (zm + zp) * ivz
        res = b - (acc - (2.0 * (ivx + ivy + ivz)) * c)
    return c + winv * res


def tiled_sweep(mode, f, deltas, reverse, tile, out_dtype=None):
    """The sweep as one block of the kernel computes it, block by block:
    the first colour x' from the input x alone, on the tile and a 1-cell
    halo (x on a 2-cell halo), rounded to the input dtype; then the second
    colour on the tile from x' alone. Partials of the sums over the points
    each block owns. Returns (out, sums) and for zero_update (b, x, sums)."""
    src = f["r"] if mode == "zero_update" else f["b"]
    shape, ti = tuple(src.shape), src.dtype
    wide = lambda t: t.float() if t.dtype == torch.bfloat16 else t
    invs = stencil_cuda.inv_squares(deltas)
    winv = stencil_cuda._winv(invs, W)
    c0, c1 = (1, 0) if reverse else (0, 1)
    out = torch.empty(shape, dtype=out_dtype or ti)
    bout = torch.empty(shape, dtype=ti)
    s0, s1 = [], []
    ch, ty, tz = tile
    for i0 in range(0, shape[0], ch):
        for j0 in range(0, shape[1], ty):
            for k0 in range(0, shape[2], tz):
                n = (min(ch, shape[0] - i0), min(ty, shape[1] - j0), min(tz, shape[2] - k0))
                lo, ext = (i0 - 2, j0 - 2, k0 - 2), (n[0] + 4, ty + 4, tz + 4)
                if mode == "zero_update":
                    bw = (_window(f["r"], lo, ext, shape)[0]
                          - f["alpha"] * _window(f["ap"], lo, ext, shape)[0])
                else:
                    bw = wide(_window(f["b"], lo, ext, shape)[0])
                idx = _window(f["b"] if "b" in f else f["r"], lo, ext, shape)[1]
                par = (idx[0].view(-1, 1, 1) + idx[1].view(1, -1, 1)
                       + idx[2].view(1, 1, -1)) % 2
                b1, p1 = bw[1:-1, 1:-1, 1:-1], par[1:-1, 1:-1, 1:-1]
                if mode in ("sweep", "dots"):
                    xw = wide(_window(f["u"], lo, ext, shape)[0])
                    x1 = torch.where(p1 == c0, _update(xw, b1, invs, winv),
                                     xw[1:-1, 1:-1, 1:-1])
                else:
                    w = torch.where(p1 == c0, torch.tensor(winv, dtype=b1.dtype),
                                    torch.zeros((), dtype=b1.dtype))
                    x1 = w * b1
                x1 = wide(x1.to(ti))
                b2 = b1[1:-1, 1:-1, 1:-1]
                x2 = torch.where(p1[1:-1, 1:-1, 1:-1] == c1, _update(x1, b2, invs, winv),
                                 x1[1:-1, 1:-1, 1:-1])
                own = (slice(0, n[0]), slice(0, n[1]), slice(0, n[2]))
                dst = (slice(i0, i0 + n[0]), slice(j0, j0 + n[1]), slice(k0, k0 + n[2]))
                out[dst] = x2[own].to(out.dtype)
                if mode == "dots":
                    s0.append(torch.sum(x2[own] * b2[own]))
                    s1.append(torch.sum(x2[own]))
                elif mode == "zero_update":
                    bout[dst] = b2[own]
                    s0.append(torch.sum(b2[own] * b2[own]))
                    s1.append(torch.sum(b2[own]))
    sums = (torch.sum(torch.stack(s0)), torch.sum(torch.stack(s1))) if s0 else ()
    return (bout, out, sums) if mode == "zero_update" else (out, sums)


# (shape, deltas, tile): odd extents, cubic and not, with small ragged
# tiles; a 4^3 level (the 2-cell halo wraps past the whole axis); the
# anisotropic (64, 32, 48) level at the kernel's own tile
SWEEP_CASES = [((5, 6, 7), (1.0, 1.0, 1.0), (2, 4, 8)),
               ((5, 6, 7), (0.2, 0.25, 0.125), (3, 4, 4)),
               ((4, 4, 4), (0.25, 0.25, 0.25), kernel_tile((4, 4, 4))),
               ((64, 32, 48), (1 / 64, 0.75 / 32, 1.5 / 48), kernel_tile((64, 32, 48)))]
SWEEP_IDS = ["odd", "odd-aniso", "4^3", "aniso-64x32x48"]
SWEEP_MODES = ["sweep", "sweep.bf16", "dots", "zero", "zero.bf16", "zero_update",
               "zero_update.narrow"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mode", SWEEP_MODES)
@pytest.mark.parametrize("shape,deltas,tile", SWEEP_CASES, ids=SWEEP_IDS)
def test_one_pass_sweep_premise_matches_plain(shape, deltas, tile, mode, reverse):
    """KB's sweep in one pass: x' from the input x alone on a halo of the
    tile, then the second colour from x' alone, equals the two-colour plain
    versions bit for bit (fields; the block-summed reductions to
    rounding), ragged tiles and wrapped halos included."""
    base, _, kind = mode.partition(".")
    u, b, r, ap = (t(a) for a in fields(shape, 25, 4))
    f = {"u": u, "b": b, "r": r, "ap": ap, "alpha": torch.tensor(0.41, dtype=torch.float64)}
    if kind == "bf16":
        f["u"], f["b"] = u.float().to(torch.bfloat16), b.float().to(torch.bfloat16)
    if kind == "narrow":
        f["r"], f["ap"], f["alpha"] = r.float(), ap.float(), f["alpha"].float()
    out_dtype = torch.bfloat16 if kind == "narrow" else None
    got = tiled_sweep(base, f, deltas, reverse, tile, out_dtype)
    if base in ("sweep", "dots"):
        ref = stencil_cuda.sor_rb_sweep_plain(f["u"], f["b"], deltas, W, reverse,
                                              dots=base == "dots")
    elif base == "zero":
        ref = stencil_cuda.sor_rb_zero_sweep_plain(f["b"], deltas, W, reverse)
    else:
        ref = stencil_cuda.sor_rb_zero_update_plain(f["r"], f["ap"], f["alpha"], deltas,
                                                    W, reverse, out_dtype)
    ref = ref if isinstance(ref, tuple) else (ref,)
    fields_got = got[:-1]
    assert len(ref) == len(fields_got) + len(got[-1])
    for g, e in zip(fields_got, ref):
        assert g.dtype == e.dtype
        assert torch.equal(g, e)
    for g, e in zip(got[-1], ref[len(fields_got):]):
        np.testing.assert_allclose(float(g), float(e), rtol=1e-5 if kind else 1e-12,
                                   atol=1e-12 * float(torch.sum(torch.abs(ref[0]))))
