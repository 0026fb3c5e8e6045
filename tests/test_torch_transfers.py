"""The port's multigrid transfers against the JAX package.

The x-only plain versions of the Pallas K6 (residual + x-restriction) and
K7 (x-prolongation + add) are held to the Pallas kernels in interpret
mode, in f64 and with a bf16 iterate; the fused legs' plain versions (the
whole 3-D transfer, which K6 and K7 compute in one launch each) to JAX's
roll-form restrict and prolong; restrict_mm/prolong_mm to JAX's and to the
roll form; the fused-leg cycle (transfers="matmul", impl="cuda": the card's
call graph on CPU tensors) to JAX's impl="pallas" cycle, without reaching
the contractions; MG-CG with the fused legs to JAX's iteration count; and
the kernels' block decomposition, mirrored on the CPU, to the plain
versions bit for bit. The kernels themselves are held to the plain
versions on the card in tests/test_torch_transfers_card.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops import stencil_pallas as jpallas
from poissbox_tpu.ops.stencil import apply_laplacian as japply_laplacian
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.solvers import mg as jmg
from poissbox_tpu.solvers.cg import cg as jcg
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import stencil_cuda, transfer_cuda
from poissbox_tpu_torch.solvers import mg

# cubic cells at 8^3 (nx/2 = 4: the periodic wrap at I = 0 and I = nx/2-1
# is most of the field), 16^3, 32^3, and three different spacings
GRIDS = [((8, 8, 8), (1.0, 1.0, 1.0)),
         ((16, 16, 16), (1.0, 1.0, 1.0)),
         ((32, 32, 32), (1.0, 1.0, 1.0)),
         ((32, 16, 24), (1.0, 0.75, 1.5))]
GRID_IDS = ["8^3", "16^3", "32^3", "aniso"]
# bf16 iterate: both sides upcast it and compute in float32; the bound is
# the bf16 comparison tier, 2^-7 of the field's max
BF16_TOL = 2.0 ** -7


def fields(shape, seed, k=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape) for _ in range(k)]


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def half(shape):
    return (shape[0] // 2,) + tuple(shape[1:])


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_residual_xrestrict_plain_matches_pallas(shape, length):
    """K6 in f64."""
    u, b = fields(shape, 41, 2)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = jpallas.residual_xrestrict_pallas(jnp.asarray(u), jnp.asarray(b), d)
    got = transfer_cuda.residual_xrestrict_plain(t(u), t(b), d)
    assert tuple(got.shape) == half(shape)
    close(got.numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_residual_xrestrict_bf16_iterate_matches_pallas(shape, length):
    """K6 reading a bf16 iterate with an f32 right-hand side."""
    u, b = fields(shape, 42, 2)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = np.asarray(jpallas.residual_xrestrict_pallas(
        jnp.asarray(u, jnp.bfloat16), jnp.asarray(b, jnp.float32), d))
    got = transfer_cuda.residual_xrestrict_plain(
        t(u).to(torch.bfloat16), t(b).float(), d)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=BF16_TOL * np.abs(ref).max())


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_xprolong_add_plain_matches_pallas(shape, length):
    """K7 in f64."""
    (u,) = fields(shape, 43)
    (e,) = fields(half(shape), 44)
    ref = jpallas.xprolong_add_pallas(jnp.asarray(u), jnp.asarray(e))
    close(transfer_cuda.xprolong_add_plain(t(u), t(e)).numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_xprolong_add_bf16_iterate_matches_pallas(shape, length):
    """K7 adding into a bf16 iterate; the output takes e's dtype."""
    (u,) = fields(shape, 45)
    (e,) = fields(half(shape), 46)
    ref = np.asarray(jpallas.xprolong_add_pallas(
        jnp.asarray(u, jnp.bfloat16), jnp.asarray(e, jnp.float32)))
    got = transfer_cuda.xprolong_add_plain(t(u).to(torch.bfloat16), t(e).float())
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=BF16_TOL * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 4, 6), (32, 16, 24)])
@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2)])
def test_transfer_contractions_match_jax_and_roll(shape, axes):
    (f,) = fields(shape, 47)
    (c,) = fields(tuple(n // 2 for n in shape), 48)
    got_r = mg.restrict_mm(t(f), axes=axes)
    got_p = mg.prolong_mm(t(c), axes=axes)
    assert got_r.is_contiguous() and got_p.is_contiguous()
    close(got_r.numpy(), jmg.restrict_mm(jnp.asarray(f), axes=axes), 1e-13)
    close(got_p.numpy(), jmg.prolong_mm(jnp.asarray(c), axes=axes), 1e-13)
    close(got_r.numpy(), mg.restrict(t(f), axes=axes).numpy(), 1e-13)
    close(got_p.numpy(), mg.prolong(t(c), axes=axes).numpy(), 1e-13)


def test_transfer_wrappers_take_plain_version_on_cpu():
    u, b = (t(a) for a in fields((8, 8, 8), 49, 2))
    (e,) = (t(a) for a in fields((4, 4, 4), 50))
    d = (0.125,) * 3
    stencil_cuda.reset_launches()
    assert torch.equal(transfer_cuda.residual_restrict_cuda(u, b, d),
                       transfer_cuda.residual_restrict_plain(u, b, d))
    assert torch.equal(transfer_cuda.prolong_add_cuda(u, e),
                       transfer_cuda.prolong_add_plain(u, e))
    assert not any(stencil_cuda.LAUNCHES.values())


# the fused legs' plain versions against JAX's roll form: cubic cells at
# 8^3 and 16^3, anisotropic cells, and uneven even extents
FUSED_GRIDS = [((8, 8, 8), (1.0, 1.0, 1.0)), ((16, 16, 16), (1.0, 1.0, 1.0)),
               ((32, 16, 24), (1.0, 0.75, 1.5)), ((12, 20, 6), (0.5, 1.0, 0.25))]
FUSED_IDS = ["8^3", "16^3", "aniso", "12x20x6"]


@pytest.mark.parametrize("shape,length", FUSED_GRIDS, ids=FUSED_IDS)
def test_residual_restrict_plain_matches_jax_roll(shape, length):
    """K6's plain version is JAX's restrict(b - A u), in f64."""
    u, b = fields(shape, 54, 2)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = jmg.restrict(jnp.asarray(b) - japply_laplacian(jnp.asarray(u), d))
    got = transfer_cuda.residual_restrict_plain(t(u), t(b), d)
    assert tuple(got.shape) == tuple(n // 2 for n in shape)
    close(got.numpy(), ref, 1e-13)


@pytest.mark.parametrize("shape,length", FUSED_GRIDS, ids=FUSED_IDS)
def test_prolong_add_plain_matches_jax_roll(shape, length):
    """K7's plain version is JAX's u + prolong(e), in f64."""
    (u,) = fields(shape, 55)
    (e,) = fields(tuple(n // 2 for n in shape), 56)
    ref = jnp.asarray(u) + jmg.prolong(jnp.asarray(e))
    got = transfer_cuda.prolong_add_plain(t(u), t(e))
    assert tuple(got.shape) == shape
    close(got.numpy(), ref, 1e-13)


@pytest.mark.parametrize("pre_dtype", ["", "bfloat16"])
def test_fused_branch_never_contracts(monkeypatch, pre_dtype):
    """A cycle whose every transfer goes through the fused legs (the card's
    call graph on CPU tensors, f32, with and without the bf16 pre-smooth)
    reaches neither restrict_mm nor prolong_mm, and gives the cycle of
    the roll transfers to f32 rounding (the roll form prolongs along x
    first, the fused leg last)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fused leg reached the banded contractions")

    n = 16
    shape, d = (n,) * 3, (1.0 / n,) * 3
    kw = dict(impl="cuda", pre_smooth=1, post_smooth=1, pre_dtype=pre_dtype)
    r = t(fields(shape, 57)[0]).float()
    roll = mg.make_mg_preconditioner(shape, d, mg.MGConfig(transfers="roll", **kw),
                                     torch.float32, device="cpu")
    monkeypatch.setattr(mg, "_contract", refuse)
    M = mg.make_mg_preconditioner(shape, d, mg.MGConfig(transfers="matmul", **kw),
                                  torch.float32, device="cpu")
    levels = M.levels
    assert all(mg._fused_leg(levels, M.config, i, "cpu")
               for i in range(len(levels) - 1))
    got, ref = M(r), roll(r)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_transfers_resolve_by_device():
    """'auto' is matmul on a CUDA device (the JAX package's choice on its
    accelerator) and roll on the CPU; the fused legs need kernel levels."""
    levels = mg._build_levels((16,) * 3, (1 / 16,) * 3, mg.MGConfig())
    auto, roll = mg.MGConfig(), mg.MGConfig(impl="roll")
    assert mg._transfers(auto, "cuda") == "matmul"
    assert mg._transfers(auto, "cpu") == "roll"
    assert [mg._fused_leg(levels, auto, i, "cuda") for i in range(3)] == \
        [True, True, False]
    assert not mg._fused_leg(levels, auto, 0, "cpu")
    assert not mg._fused_leg(levels, roll, 0, "cuda")
    card_graph = mg.MGConfig(impl="cuda", transfers="matmul")
    assert mg._fused_leg(levels, card_graph, 0, "cpu")


@pytest.fixture(scope="module")
def fused32():
    """The 32^3 hierarchy with the fused legs both ways: the port's
    impl='cuda', transfers='matmul' on CPU tensors, and JAX's
    impl='pallas', transfers='matmul' in interpret mode (f64)."""
    n = 32
    shape, d = (n,) * 3, (1.0 / n,) * 3
    M = mg.make_mg_preconditioner(shape, d, mg.MGConfig(impl="cuda",
                                                        transfers="matmul"), device="cpu")
    jM = jmg.make_mg_preconditioner(
        shape, d, jmg.MGConfig(impl="pallas", transfers="matmul"),
        dtype=jnp.float64)
    r, ap = fields(shape, 51, 2)
    return M, jM, r - r.mean(), ap


def test_fused_leg_cycle_matches_pallas_path(fused32):
    M, jM, r, ap = fused32
    assert M.resolved == {"transfers": "matmul", "pre_dtype": "float64"}
    close(M(t(r)).numpy(), jax.jit(jM)(jnp.asarray(r)))
    got = M.apply_update_dots(t(r), t(ap), torch.tensor(0.37, dtype=torch.float64))
    ref = jax.jit(jM.apply_update_dots)(jnp.asarray(r), jnp.asarray(ap), 0.37)
    for g, f in zip(got[:2], ref[:2]):        # v, b
        close(g.numpy(), f)
    for g, f in zip(got[2:], ref[2:]):        # ||b||^2, sum b, <b, v>, sum v
        np.testing.assert_allclose(float(g), float(f), rtol=1e-11,
                                   atol=1e-12 * abs(float(ref[2])))


def test_fused_leg_bf16_pre_smooth_matches_pallas_path():
    """The 512^3-class cycle shape at 16^3 f32: V(1,1), bf16 pre-smooth,
    fused legs. K5 stores x1 in bf16 and K6/K7 read it; the outputs are
    held to JAX's impl='pallas' counterpart at the JAX package's own
    tolerances for this cycle (tests/test_mg.py:246-261)."""
    n = 16
    shape, d = (n,) * 3, (1.0 / n,) * 3
    kw = dict(pre_smooth=1, post_smooth=1, pre_dtype="bfloat16",
              transfers="matmul")
    M = mg.make_mg_preconditioner(shape, d, mg.MGConfig(impl="cuda", **kw),
                                  torch.float32, device="cpu")
    jM = jmg.make_mg_preconditioner(shape, d, jmg.MGConfig(impl="pallas", **kw),
                                    dtype=jnp.float32)
    assert getattr(M, "apply_update_dots", None) is not None
    assert M.resolved == {"transfers": "matmul", "pre_dtype": "bfloat16"}
    r, ap = (a.astype(np.float32) for a in fields(shape, 52, 2))
    alpha = np.float32(0.37)
    v, b, rr, sr, rv, sv = M.apply_update_dots(
        t(r), t(ap), torch.tensor(alpha))
    jv, jb, jrr, jsr, jrv, jsv = jax.jit(jM.apply_update_dots)(
        jnp.asarray(r), jnp.asarray(ap), jnp.asarray(alpha))
    assert v.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(rr), float(jrr), rtol=1e-4)
    scale = float(np.abs(np.asarray(jv)).max())
    assert float(np.abs(v.numpy() - np.asarray(jv)).max()) <= 0.05 * scale
    np.testing.assert_allclose(float(rv), float(jrv), rtol=1e-3)
    np.testing.assert_allclose(float(sv), float(jsv), rtol=1e-2,
                               atol=1e-3 * scale)


def test_mgcg_fused_legs_iteration_parity_32():
    """MG-CG through PoissonSolver on the card's call graph (-mg_impl cuda
    -mg_transfers matmul) against JAX's MG-CG with matmul transfers."""
    n, rtol = 32, 1e-10
    u = np.random.default_rng(53).uniform(-1.0, 1.0, (n,) * 3)
    u -= u.mean()
    grid = JGrid3D((n,) * 3)
    jA = jmake_operator(grid, impl="roll")
    b = np.array(jA(jnp.asarray(u)))
    jM = jmg.make_mg_preconditioner(
        grid.n, grid.deltas, jmg.MGConfig(impl="roll", transfers="matmul"),
        dtype=jnp.float64)
    ref = jax.jit(lambda z: jcg(jA, z, M=jM, rtol=rtol, max_it=60))(b)
    s = PoissonSolver((n,) * 3, dtype=torch.float64, device="cpu", options=Options(
        ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
         "-ksp_max_it", "60", "-mg_impl", "cuda", "-mg_transfers", "matmul"]))
    assert getattr(s._solver.M, "apply_update_dots", None) is not None
    res = s.solve(torch.as_tensor(b))
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.reason) == int(ref.reason) > 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-11)


# ---------------------------------------------------------------------------
# K6 and K7 as csrc/xfer.cu's blocks compute them: their premise on the CPU
# ---------------------------------------------------------------------------

def star_of(uw, ivx, ivy, ivz):
    """The 7-point star at the interior of a window, in K6's grouping."""
    c = uw[1:-1, 1:-1, 1:-1]
    xm, xp = uw[:-2, 1:-1, 1:-1], uw[2:, 1:-1, 1:-1]
    ym, yp = uw[1:-1, :-2, 1:-1], uw[1:-1, 2:, 1:-1]
    zm, zp = uw[1:-1, 1:-1, :-2], uw[1:-1, 1:-1, 2:]
    if ivx == ivy == ivz:
        s = ((xm + xp) + (ym + yp)) + (zm + zp)
        return s * ivx - (6.0 * ivx) * c
    s = (xm + xp) * ivx
    s = s + (ym + yp) * ivy
    s = s + (zm + zp) * ivz
    return s - (2.0 * (ivx + ivy + ivz)) * c


def restrict_in(f, ax):
    """Full weighting along `ax` of a window holding f_{2I-1} .. f_{2I+2}
    of every coarse I, in K6's grouping."""
    n = f.shape[ax]
    dn, even, odd, up = (f.narrow(ax, k, n - 3).unfold(ax, 1, 2).squeeze(-1)
                         for k in range(4))
    return ((3.0 * (even + odd) + up) + dn) * 0.125


def windows(shape, lo, n):
    """Wrapped index vectors of a window starting at `lo` (per axis) and
    `n` long."""
    return [torch.arange(a, a + k) % s for a, k, s in zip(lo, n, shape)]


def take(f, idx):
    return f[idx[0]][:, idx[1]][:, :, idx[2]]


def streamed_restrict(u, b, deltas, tile):
    """R_z R_y R_x (b - A u) as K6's blocks compute it: a block owns a
    coarse (y, z) tile and a chunk of coarse planes, computes each fine
    residual it needs once, over the fine tile and a 1-cell wrapped halo
    from u on a 2-cell halo, restricts along x (planes 2I-1 .. 2I+2), then
    along y and z over the region."""
    nx, ny, nz = u.shape
    nxc, nyc, nzc = nx // 2, ny // 2, nz // 2
    ivx, ivy, ivz = stencil_cuda.inv_squares(deltas)
    out = torch.empty((nxc, nyc, nzc), dtype=b.dtype)
    ch, cy, cz = tile
    for I0 in range(0, nxc, ch):
        m = min(ch, nxc - I0)
        for J0 in range(0, nyc, cy):
            for K0 in range(0, nzc, cz):
                lo = (2 * I0 - 2, 2 * J0 - 2, 2 * K0 - 2)
                uw = take(u, windows(u.shape, lo, (2 * m + 4, 2 * cy + 4, 2 * cz + 4)))
                bw = take(b, windows(u.shape, [a + 1 for a in lo],
                                     (2 * m + 2, 2 * cy + 2, 2 * cz + 2)))
                r = bw - star_of(uw.to(b.dtype), ivx, ivy, ivz)
                rc = restrict_in(restrict_in(restrict_in(r, 0), 1), 2)
                jn, kn = min(cy, nyc - J0), min(cz, nzc - K0)
                out[I0:I0 + m, J0:J0 + jn, K0:K0 + kn] = rc[:, :jn, :kn]
    return out


def streamed_prolong_add(u, e, tile):
    """u + P_x P_z P_y e as K7's blocks compute it: a block owns a coarse
    (y, z) tile and a chunk of coarse planes, stages coarse planes I0-1 ..
    I0+m with a 1-cell wrapped halo, prolongs each along y and z at its
    fine tile, and combines planes I-1, I, I+1 into fine planes 2I, 2I+1."""
    nx, ny, nz = u.shape
    nxc, nyc, nzc = e.shape
    out = torch.empty(u.shape, dtype=e.dtype)
    ch, cy, cz = tile

    def near(n):   # the window cell of each fine index, and its neighbour
        f = torch.arange(2 * n)
        return f // 2 + 1, f // 2 + 1 + torch.where(f % 2 == 1, 1, -1)

    (ry, ryn), (rz, rzn) = near(cy), near(cz)
    for I0 in range(0, nxc, ch):
        m = min(ch, nxc - I0)
        for J0 in range(0, nyc, cy):
            for K0 in range(0, nzc, cz):
                ew = take(e, windows(e.shape, (I0 - 1, J0 - 1, K0 - 1),
                                     (m + 2, cy + 2, cz + 2)))
                ey = 0.75 * ew[:, ry] + 0.25 * ew[:, ryn]
                c = 0.75 * ey[:, :, rz] + 0.25 * ey[:, :, rzn]
                even = 0.75 * c[1:-1] + 0.25 * c[:-2]
                odd = 0.75 * c[1:-1] + 0.25 * c[2:]
                corr = torch.stack([even, odd], 1).reshape((2 * m, 2 * cy, 2 * cz))
                jn, kn = min(2 * cy, ny - 2 * J0), min(2 * cz, nz - 2 * K0)
                sl = (slice(2 * I0, 2 * (I0 + m)), slice(2 * J0, 2 * J0 + jn),
                      slice(2 * K0, 2 * K0 + kn))
                out[sl] = u[sl].to(e.dtype) + corr[:, :jn, :kn]
    return out


def kernel_tile(shape):
    """(chunk, 8, 32): the coarse planes and coarse (y, z) tile of a K6 or
    K7 block, as csrc/xfer.cu xfer_chunk picks them."""
    nxc, nyc, nzc = (n // 2 for n in shape)
    tiles = -(-nzc // 32) * -(-nyc // 8)
    c = 32
    while c > 1 and tiles * -(-nxc // c) < 2048:
        c //= 2
    return c, 8, 32


RESTRICT_CASES = [((8, 8, 8), (1.0, 1.0, 1.0), (1, 2, 4)),
                  ((6, 10, 14), (0.2, 0.25, 0.125), (2, 2, 4)),
                  ((4, 4, 4), (0.25, 0.25, 0.25), kernel_tile((4, 4, 4))),
                  ((40, 36, 52), (1.0, 1.0, 1.0), (3, 8, 32)),   # a ragged chunk too
                  ((64, 32, 48), (1 / 64, 0.75 / 32, 1.5 / 48),
                   kernel_tile((64, 32, 48)))]
RESTRICT_IDS = ["8^3", "odd-aniso", "4^3", "40x36x52", "aniso-64x32x48"]
UDTYPES = ["float64", "float32", "bf16u-float32", "bf16u-float64"]


def typed(fs, udtype):
    """(u, second field) in a dtype pair: u in the pair's iterate dtype."""
    u, v = fs
    vdt = torch.float64 if udtype.endswith("float64") else torch.float32
    v = v.to(vdt)
    return (u.to(torch.bfloat16) if udtype.startswith("bf16u") else u.to(vdt)), v


@pytest.mark.parametrize("udtype", UDTYPES)
@pytest.mark.parametrize("shape,deltas,tile", RESTRICT_CASES, ids=RESTRICT_IDS)
def test_streamed_restrict_matches_plain(shape, deltas, tile, udtype):
    """K6 with each fine residual computed once per block and restricted
    along x, y and z over its region equals residual_restrict_plain bit
    for bit, ragged tiles, wrapped halos and a bf16 iterate included."""
    u, b = typed([t(a) for a in fields(shape, 33, 2)], udtype)
    got = streamed_restrict(u, b, deltas, tile)
    ref = transfer_cuda.residual_restrict_plain(u, b, deltas)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("udtype", UDTYPES)
@pytest.mark.parametrize("shape,deltas,tile", RESTRICT_CASES, ids=RESTRICT_IDS)
def test_streamed_prolong_add_matches_plain(shape, deltas, tile, udtype):
    """K7 prolonging each coarse plane along y and z at its fine tile and
    combining three planes along x equals prolong_add_plain bit for bit,
    ragged tiles, wrapped halos and a bf16 iterate included."""
    (u,) = fields(shape, 34)
    (e,) = fields(tuple(n // 2 for n in shape), 35)
    u, e = typed([t(u), t(e)], udtype)
    got = streamed_prolong_add(u, e, tile)
    ref = transfer_cuda.prolong_add_plain(u, e)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
