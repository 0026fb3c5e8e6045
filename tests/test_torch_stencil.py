"""The port's 7-point stencil against the JAX package.

Inputs are made with numpy from a seed and handed to both. The roll and
pointwise forms are held to the JAX roll and pointwise forms; the plain
versions of the CUDA stencil kernel (K1, K2, K9, K12), of one red-black
colour update (K11) and of CG's fused update (K8) to the Pallas kernels,
and K1/K2's to the streamed K1'/K2', run in interpret mode as the JAX
package's own tests run them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops import assemble as jassemble
from poissbox_tpu.ops import stencil as jstencil
from poissbox_tpu.ops import stencil_pallas as jpallas
from poissbox_tpu.ops import stencil_inplace as jinplace
from poissbox_tpu.ops.coefficients import lapl_star_coeffs as jlapl_star_coeffs
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import assemble, stencil, stencil_cuda
from poissbox_tpu_torch.ops.coefficients import lapl_star_coeffs

# (shape, lengths): cubic cells at 16^3 and 32^3, and a grid whose three
# spacings differ (the non-isotropic grouping of the kernels)
GRIDS = [((16, 16, 16), (1.0, 1.0, 1.0)),
         ((32, 32, 32), (1.0, 1.0, 1.0)),
         ((16, 8, 12), (1.0, 0.75, 1.5))]
GRID_IDS = ["16^3", "32^3", "aniso"]
# the kernel-parity tier of the JAX package's own Pallas tests
RTOL, ATOL = 1e-12, 1e-13


def fields(shape, seed, k=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape) for _ in range(k)]


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_roll_matches_jax(shape, length):
    (u,) = fields(shape, 1)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = np.asarray(jstencil.apply_laplacian(jnp.asarray(u), d))
    got = stencil.apply_laplacian(t(u), d).numpy()
    close(got, ref, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_pointwise_matches_jax(shape, length):
    (u,) = fields(shape, 2)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = np.asarray(jstencil.apply_laplacian_pointwise(jnp.asarray(u), d))
    got = stencil.apply_laplacian_pointwise(t(u), d).numpy()
    close(got, ref, atol=1e-12 * np.abs(ref).max())
    # and the two port forms agree with each other (the demo's check_lapl)
    roll = stencil.apply_laplacian(t(u), d).numpy()
    close(got, roll, atol=1e-12 * np.abs(ref).max())


def test_laplacian_local_matches_jax():
    (up,) = fields((10, 8, 6), 3)
    d = (0.1, 0.2, 0.3)
    ref = np.asarray(jstencil.laplacian_local(jnp.asarray(up), d))
    close(stencil.laplacian_local(t(up), d).numpy(), ref, atol=1e-12)


def test_star_coeffs_match_jax():
    ref = np.asarray(jlapl_star_coeffs(0.1, 0.25, 0.5, dtype=jnp.float64))
    np.testing.assert_array_equal(
        lapl_star_coeffs(0.1, 0.25, 0.5, dtype=torch.float64).numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_apply_plain_matches_pallas(shape, length):
    """K1: y = A u."""
    (u,) = fields(shape, 4)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = np.asarray(jpallas.apply_laplacian_pallas(jnp.asarray(u), d))
    close(stencil_cuda.apply_laplacian_plain(t(u), d).numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_apply_dot_plain_matches_pallas(shape, length):
    """K2: (A u, <u, A u>)."""
    (u,) = fields(shape, 5)
    d = Grid3D(shape, length, device="cpu").deltas
    ref, rdot = jpallas.apply_laplacian_dot_pallas(jnp.asarray(u), d)
    y, dot = stencil_cuda.apply_laplacian_dot_plain(t(u), d)
    close(y.numpy(), ref)
    np.testing.assert_allclose(float(dot), float(rdot), rtol=RTOL)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_residual_plain_matches_pallas(shape, length):
    """K9: r = b - A u."""
    u, b = fields(shape, 6, 2)
    d = Grid3D(shape, length, device="cpu").deltas
    ref = np.asarray(jpallas.residual_pallas(jnp.asarray(u), jnp.asarray(b), d))
    close(stencil_cuda.residual_plain(t(u), t(b), d).numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_cg_fused_update_plain_matches_pallas(shape, length):
    """K8: (x + alpha p, r - alpha Ap, ||r'||^2, sum(r'))."""
    x, p, r, ap = fields(shape, 10, 4)
    ref = jpallas.cg_fused_update(jnp.asarray(0.3), *(jnp.asarray(a)
                                                      for a in (x, p, r, ap)))
    got = stencil_cuda.cg_fused_update_plain(
        torch.tensor(0.3, dtype=torch.float64), *(t(a) for a in (x, p, r, ap)))
    close(got[0].numpy(), ref[0], atol=1e-15)
    close(got[1].numpy(), ref[1], atol=1e-15)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-12)
    # sum(r') of zero-mean noise: relative to the sum of |r'|
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=0,
                               atol=1e-13 * np.abs(np.asarray(ref[1])).sum())


def test_cuda_operator_binds_fused_update():
    u, p, r, ap = (t(a) for a in fields((8, 8, 8), 11, 4))
    grid = Grid3D((8, 8, 8), device="cpu")
    assert stencil.make_laplacian_operator(grid, impl="roll").fused_update is None
    A = stencil.make_laplacian_operator(grid, impl="cuda")
    alpha = torch.tensor(0.7, dtype=torch.float64)
    stencil_cuda.reset_launches()
    for a, c in zip(A.fused_update(alpha, u, p, r, ap),
                    stencil_cuda.cg_fused_update_plain(alpha, u, p, r, ap)):
        assert torch.equal(a, c)
    assert not any(stencil_cuda.LAUNCHES.values())


def test_cuda_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version, bit for bit, and launches
    nothing."""
    u, b = (t(a) for a in fields((8, 8, 8), 7, 2))
    d = (0.125,) * 3
    stencil_cuda.reset_launches()
    assert torch.equal(stencil_cuda.apply_laplacian_cuda(u, d),
                       stencil_cuda.apply_laplacian_plain(u, d))
    y, dot = stencil_cuda.apply_laplacian_dot_cuda(u, d)
    y0, dot0 = stencil_cuda.apply_laplacian_dot_plain(u, d)
    assert torch.equal(y, y0) and torch.equal(dot, dot0)
    assert torch.equal(stencil_cuda.residual_cuda(u, b, d),
                       stencil_cuda.residual_plain(u, b, d))
    assert not any(stencil_cuda.LAUNCHES.values())


@pytest.mark.parametrize("impl", ["roll", "pointwise", "cuda", "auto"])
def test_operator_impls_agree(impl):
    grid = Grid3D((16, 12, 8), (1.0, 0.5, 2.0), device="cpu")
    (u,) = fields(grid.n, 8)
    A = stencil.make_laplacian_operator(grid, impl=impl)
    ref = np.asarray(jstencil.apply_laplacian(jnp.asarray(u), grid.deltas))
    close(A(t(u)).numpy(), ref, atol=1e-12 * np.abs(ref).max())
    assert (A.apply_dot is not None) == (impl == "cuda")
    jA = jstencil.make_laplacian_operator(JGrid3D(grid.n, grid.length), "roll")
    assert A.diagonal() == float(jA.diagonal())
    np.testing.assert_allclose(A.project(t(u)).numpy(),
                               np.asarray(jA.project(jnp.asarray(u))),
                               rtol=0, atol=1e-15)


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        stencil.make_laplacian_operator(Grid3D((8, 8, 8), device="cpu"), impl="pallas")
    with pytest.raises(ValueError):
        stencil.default_impl("meta")


@pytest.mark.parametrize("shape,length", [((6, 4, 8), (1.0, 2.0, 0.5)),
                                          ((2, 3, 4), (1.0, 1.0, 1.0))])
def test_stencil_matrix_matches_jax(shape, length):
    d = Grid3D(shape, length, device="cpu").deltas
    M = assemble.assemble_laplacian(shape, d)
    jM = jassemble.assemble_laplacian(shape, d, jnp.float64)
    np.testing.assert_array_equal(M.to_dense(), jM.to_dense())
    assert M.row(0, 1, 2) == jM.row(0, 1, 2)
    (u,) = fields(shape, 9)
    ref = np.asarray(jM(jnp.asarray(u)))
    close(M(t(u)).numpy(), ref, atol=1e-12 * np.abs(ref).max())
    with pytest.raises(ValueError):
        M(torch.zeros(3, 3, 3, dtype=torch.float64))


def test_pupdate_plain_matches_pallas():
    """K12: (p', A p', <p', A p'>) for p' = (v - zs) + beta p at 16^3 f64,
    to the JAX package's own tiers (tests/test_round3.py)."""
    n = 16
    v, p = fields((n,) * 3, 12, 2)
    d = (1.0 / n,) * 3
    pn, ap, pap = jpallas.pupdate_lapl_dot_pallas(jnp.asarray(v), jnp.asarray(p),
                                                  0.73, 0.031, d)
    f64 = torch.float64
    gpn, gap, gpap = stencil_cuda.pupdate_lapl_dot_plain(
        t(v), t(p), torch.tensor(0.73, dtype=f64), torch.tensor(0.031, dtype=f64), d)
    np.testing.assert_allclose(gpn.numpy(), np.asarray(pn), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(gap.numpy(), np.asarray(ap), rtol=1e-12, atol=1e-8)
    np.testing.assert_allclose(float(gpap), float(pap), rtol=1e-11)


def test_pupdate_plain_matches_stream():
    """K12 against the TPU's aliased streaming form at 32^3 f32, to
    tests/test_stencil_inplace.py's tolerances."""
    n = 32
    u, b = (a.astype(np.float32) for a in fields((n,) * 3, 13, 2))
    d = (1.0 / n,) * 3
    pn, ap, pap = jinplace.pupdate_matvec_stream(jnp.asarray(u), jnp.asarray(b),
                                                 0.7, 0.013, d)
    gpn, gap, gpap = stencil_cuda.pupdate_lapl_dot_plain(
        t(u), t(b), torch.tensor(0.7), torch.tensor(0.013), d)
    assert float(np.abs(gpn.numpy() - np.asarray(pn)).max()) < 1e-6
    scale = float(np.abs(np.asarray(ap)).max())
    assert float(np.abs(gap.numpy() - np.asarray(ap)).max()) < 1e-6 * scale
    assert abs(float(gpap) - float(pap)) <= 1e-4 * abs(float(pap))


@pytest.mark.parametrize("color", [0, 1])
def test_sor_sweep_plain_matches_pallas(color):
    """K11: one red-black colour update at 16^3 f64."""
    n = 16
    u, b = fields((n,) * 3, 14, 2)
    d = (1.0 / n,) * 3
    ref = np.asarray(jpallas.sor_sweep_pallas(jnp.asarray(u), jnp.asarray(b), d,
                                              1.0, color))
    got = stencil_cuda.sor_sweep_plain(t(u), t(b), d, 1.0, color).numpy()
    # KB keeps _rb_halfstep's grouping, Pallas's _upd_sor another: an
    # updated value near zero may differ by an ulp of its O(1) terms
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
    # the other colour is copied
    par = stencil_cuda.colour_parity((n,) * 3, "cpu").numpy()
    assert np.array_equal(got[par != color], u[par != color])


def test_stream_matvec_is_ka():
    """K1'/K2', the TPU's streamed matvec, against K1/K2's plain versions
    at 32^3 f32: fields exact, the dot to rtol 1e-5."""
    n = 32
    (u,) = (a.astype(np.float32) for a in fields((n,) * 3, 15))
    d = (1.0 / n,) * 3
    ref = np.asarray(jinplace.apply_laplacian_stream(jnp.asarray(u), d))
    assert float(np.abs(stencil_cuda.apply_laplacian_plain(t(u), d).numpy()
                        - ref).max()) == 0.0
    rref, rdot = jinplace.apply_laplacian_dot_stream(jnp.asarray(u), d)
    y, dot = stencil_cuda.apply_laplacian_dot_plain(t(u), d)
    assert float(np.abs(y.numpy() - np.asarray(rref)).max()) == 0.0
    assert abs(float(dot) - float(rdot)) <= 1e-5 * abs(float(rdot))


def _ka_stream_mirror(u, deltas):
    """KA's apply_dot as the streamed kernel computes it: each block of
    ka_blocks' grid owns a 32 x 16 (z, y) tile and walks its chunk of x
    planes, the plane at hand as a window with a 1-cell periodic halo, u[x-1]
    carried from the step before, u[x+1] read from the next plane's window;
    the dot summed over the block's points, one partial a block. Returns
    (y, partials)."""
    nx, ny, nz = u.shape
    ivx, ivy, ivz = (1.0 / float(d) ** 2 for d in deltas)
    center = 2.0 * (ivx + ivy + ivz)
    gz, gy, gx, chunk = stencil_cuda.ka_blocks(u.shape)
    y = torch.full_like(u, float("nan"))
    parts = []
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                i0, j0, k0 = bx * chunk, by * stencil_cuda.TILE_Y, bz * stencil_cuda.TILE_Z
                jw = torch.arange(j0 - 1, j0 + stencil_cuda.TILE_Y + 1) % ny
                kw = torch.arange(k0 - 1, k0 + stencil_cuda.TILE_Z + 1) % nz
                oy = min(stencil_cuda.TILE_Y, ny - j0)
                oz = min(stencil_cuda.TILE_Z, nz - k0)
                window = lambda i: u[i % nx][jw][:, kw]
                win = window(i0)
                um = window(i0 - 1)[1:-1, 1:-1]
                dot = torch.zeros((), dtype=u.dtype)
                for t in range(min(chunk, nx - i0)):
                    nxt = window(i0 + t + 1)
                    c = win[1:-1, 1:-1]
                    acc = (um + nxt[1:-1, 1:-1]) * ivx
                    acc = acc + (win[:-2, 1:-1] + win[2:, 1:-1]) * ivy
                    acc = acc + (win[1:-1, :-2] + win[1:-1, 2:]) * ivz
                    out = (acc - center * c)[:oy, :oz]
                    y[i0 + t, j0:j0 + oy, k0:k0 + oz] = out
                    dot = dot + torch.sum(c[:oy, :oz] * out)
                    um, win = c, nxt
                parts.append(dot)
    return y, torch.stack(parts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(64, 32, 48), (40, 36, 52), (5, 6, 7), (4, 4, 4)],
                         ids=["aniso", "ragged", "odd", "4^3"])
def test_streamed_apply_dot_matches_plain(shape, dtype):
    """KA's x walk, mirrored: y bit-equal to K2's plain version, one
    partial per block of the launch (as many as _partials allocates), their
    sum within chip_smoke.py's reduction tolerance of the plain dot."""
    (u,) = fields(shape, 17)
    u = t(u).to(dtype)
    d = Grid3D(shape, (1.0, 0.75, 1.5), device="cpu").deltas
    y, parts = _ka_stream_mirror(u, d)
    y0, dot0 = stencil_cuda.apply_laplacian_dot_plain(u, d)
    assert torch.equal(y, y0)
    assert parts.numel() == stencil_cuda._partials(u).numel()
    red_tol = {torch.float32: 1e-4, torch.float64: 1e-10}[dtype]
    assert abs(float(parts.sum()) - float(dot0)) <= red_tol * abs(float(dot0))


@pytest.mark.parametrize("shape,chunk,blocks", [((256,) * 3, 8, 4096), ((512,) * 3, 64, 4096),
                                                ((64,) * 3, 4, 128), ((4, 4, 4), 4, 1)])
def test_ka_grid_sizes(shape, chunk, blocks):
    """KA's grid: about KA_MIN_BLOCKS blocks at 256^3 and 512^3 (one dot
    partial each, not one per 256 points), the chunk not below 4."""
    gz, gy, gx, c = stencil_cuda.ka_blocks(shape)
    assert (c, gz * gy * gx) == (chunk, blocks)


def test_sweep_goes_through_the_colour_update():
    """A red-black sweep is two K11 colour updates, on the CPU (plain) and
    in the wrappers' call graph; the new wrappers take their plain
    versions on CPU tensors, bit for bit, and launch nothing."""
    u, b, p = (t(a) for a in fields((8, 8, 8), 16, 3))
    d = (0.125,) * 3
    stencil_cuda.reset_launches()
    for rev, (c0, c1) in ((False, (0, 1)), (True, (1, 0))):
        two = stencil_cuda.sor_sweep_cuda(
            stencil_cuda.sor_sweep_cuda(u, b, d, 1.0, c0), b, d, 1.0, c1)
        assert torch.equal(two, stencil_cuda.sor_rb_sweep_cuda(u, b, d, 1.0, rev))
        assert torch.equal(two, stencil_cuda.sor_rb_sweep_plain(u, b, d, 1.0, rev))
    beta, zs = torch.tensor(0.4, dtype=u.dtype), torch.tensor(0.02, dtype=u.dtype)
    for a, c in zip(stencil_cuda.pupdate_lapl_dot_cuda(u, p, beta, zs, d),
                    stencil_cuda.pupdate_lapl_dot_plain(u, p, beta, zs, d)):
        assert torch.equal(a, c)
    assert not any(stencil_cuda.LAUNCHES.values())


def _k11_mirror(x, b, deltas, weight, color):
    """K11's colour kernel, mirrored: each block of ka_blocks' grid owns a
    32 x 16 (z, y) tile and walks its chunk of x planes; the plane at hand
    is a window with a 1-cell periodic halo in y and a 2-cell one in z, in
    a ring of three slots; a thread owns a z-adjacent pair (ok, ok + 1), ok
    even, and updates the cell of the colour, chosen by its address
    ((i + j + ok) & 1), copying the other; x[i-1] at the pair is carried
    from the step before, x[i+1] read from the next plane's slot. An owned
    pair never straddles the z wrap (it starts at an even ok < nz): on an
    odd extent the last one is the lone cell nz - 1, updated or copied by
    its own parity, its z+1 neighbour the wrapped cell 0 of the window.
    bf16 fields stage in float32 and round once at the store."""
    nx, ny, nz = x.shape
    tz, ty = stencil_cuda.TILE_Z, stencil_cuda.TILE_Y
    wide = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    xw, bw = x.to(wide), b.to(wide)
    ivx, ivy, ivz = (1.0 / float(d) ** 2 for d in deltas)
    center, six = 2.0 * (ivx + ivy + ivz), 6.0 * ivx
    winv = float(weight) / -center
    iso = ivx == ivy == ivz
    gz, gy, gx, chunk = stencil_cuda.ka_blocks(x.shape)
    out = torch.full_like(x, float("nan"))
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                i0, j0, k0 = bx * chunk, by * ty, bz * tz
                jw = torch.arange(j0 - 1, j0 + ty + 1) % ny
                kw = torch.arange(k0 - 2, k0 + tz + 2) % nz
                window = lambda i: xw[i % nx][jw][:, kw]
                oj = j0 + torch.arange(ty)
                ok = k0 + 2 * torch.arange(tz // 2)
                own = (oj < ny)[:, None] & (ok < nz)[None, :]
                own_b = own & (ok + 1 < nz)[None, :]
                a_cols, b_cols = slice(2, tz + 2, 2), slice(3, tz + 3, 2)
                slots = [window(i0), None, None]
                prev = window(i0 - 1)[1:-1]
                um = (prev[:, a_cols], prev[:, b_cols])
                staged = window(i0 + 1)
                s0, s1 = 0, 1
                for t in range(min(chunk, nx - i0)):
                    slots[s1] = staged
                    if t + 1 < min(chunk, nx - i0):
                        staged = window(i0 + t + 2)
                    qi = (i0 + t) % nx
                    x0, xn = slots[s0], slots[s1]
                    ca, cb = x0[1:-1, a_cols], x0[1:-1, b_cols]
                    ua = ((qi + oj[:, None] + ok[None, :]) & 1) == color
                    pick = lambda w, r=slice(1, -1): torch.where(ua, w[r, a_cols], w[r, b_cols])
                    zo = torch.where(ua, x0[1:-1, 1:tz + 1:2], x0[1:-1, 4:tz + 4:2])
                    bq = bw[qi][oj % ny][:, torch.stack([ok, ok + 1], 1).reshape(-1) % nz]
                    bv = torch.where(ua, bq[:, 0::2], torch.where(own_b, bq[:, 1::2], 0.0))
                    c = torch.where(ua, ca, cb)
                    xm, xp = torch.where(ua, um[0], um[1]), pick(xn)
                    ym, yp = pick(x0, slice(0, -2)), pick(x0, slice(2, None))
                    zm, zp = torch.where(ua, zo, ca), torch.where(ua, cb, zo)
                    if iso:
                        s = ((xm + xp) + (ym + yp)) + (zm + zp)
                        res = (bv - ivx * s) + six * c
                    else:
                        acc = (xm + xp) * ivx
                        acc = acc + (ym + yp) * ivy
                        acc = acc + (zm + zp) * ivz
                        res = bv - (acc - center * c)
                    upd = c + winv * res
                    va, vb = torch.where(ua, upd, ca), torch.where(ua, cb, upd)
                    for cells, keep, dk in ((va, own, 0), (vb, own_b, 1)):
                        jj, kk = torch.nonzero(keep, as_tuple=True)
                        out[qi, oj[jj], ok[kk] + dk] = cells[jj, kk].to(x.dtype)
                    um = (ca, cb)
                    s0, s1 = s1, 3 - s0 - s1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16],
                         ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("aniso", [False, True], ids=["iso", "aniso"])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", [(6, 5, 7), (4, 4, 8), (9, 6, 5), (40, 36, 52)],
                         ids=["odd", "4x4x8", "odd-x", "ragged"])
def test_colour_update_mirror_matches_plain(shape, color, aniso, dtype):
    """K11's pair schedule, mirrored on the CPU, bit-equal to its plain
    version (sor_sweep_plain, which the wrapper takes on a CPU tensor):
    the cell of each pair updated by its address, the lone cell of an odd
    z extent, the three-slot ring with x[i-1] carried, the chunks of x
    planes of KA's grid; bf16 computed in float32 and rounded once."""
    u, b = fields(shape, 23 + color, 2)
    u, b = t(u).to(dtype), t(b).to(dtype)
    length = (1.0, 0.75, 1.5) if aniso else (1.0, 1.0, 1.0)
    d = Grid3D(shape, length if aniso else tuple(float(n) for n in shape),
               device="cpu").deltas
    assert (len(set(d)) > 1) == aniso
    got = _k11_mirror(u, b, d, 1.0, color)
    want = stencil_cuda.sor_sweep_plain(u, b, d, 1.0, color)
    assert torch.equal(got, want)
    assert torch.equal(stencil_cuda.sor_sweep_cuda(u, b, d, 1.0, color), want)


@pytest.mark.parametrize("shape,chunk,blocks", [((256,) * 3, 8, 4096), ((512,) * 3, 64, 4096),
                                                ((256, 256, 512), 16, 4096),
                                                ((22, 64, 64), 4, 48), ((4, 4, 8), 4, 1)])
def test_colour_update_grid_sizes(shape, chunk, blocks):
    """K11's grid is KA's: about KA_MIN_BLOCKS blocks at 256^3, 512^3 and
    the (2, 2, 1) block of 512^3 (the distributed fine level), the chunk
    not below 4 on the coarse blocks."""
    gz, gy, gx, c = stencil_cuda.ka_blocks(shape)
    assert (c, gz * gy * gx) == (chunk, blocks)
