"""The port's FFT direct solves and the order-6 slice as a whole against
the JAX package (its CPU branch: rfftn for the 7-point solve, fftn for the
compact one), in float64.

  * poisson_solve_fft, compact_poisson_solve_fft and the eigenvalue tables
    to 1e-12 relative;
  * PoissonSolver(order=6) at 16^3: -ksp_type fft to a 1e-10 residual
    (the JAX package's test_poisson_solver_order6_api), CG + GMG and
    FCG + -pc_type fft with the JAX package's iteration counts on the
    smooth field of its test_cg_with_gmg_preconditioner;
  * the one-rank solves' symbol multiply (ops/spectral_cuda.py's plain
    version, from fft.symbol_tables) against the half spectrum of the
    full inverse tables, its kernel-mode mask, the tables' evenness and
    their cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.config import Options as JOptions
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.compact import make_compact_laplacian_operator as jmake_compact
from poissbox_tpu.solvers import fft as jfft
from poissbox_tpu.solvers import ksp as jksp
from poissbox_tpu.solvers.cg import cg as jcg
from poissbox_tpu.solvers.mg import MGConfig as JMGConfig
from poissbox_tpu.solvers.mg import make_mg_preconditioner as jmake_mg
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import spectral_cuda
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers import fft, ksp

SHAPES = [((16, 16, 16), (1.0, 1.0, 1.0)), ((16, 8, 32), (1.0, 0.5, 2.0)),
          ((12, 10, 14), (1.0, 1.0, 1.0))]
SHAPE_IDS = ["16^3", "aniso", "even-uneven"]


def field(shape, seed):
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, shape)
    return u - u.mean()


def deltas(shape, length):
    return tuple(L / n for L, n in zip(length, shape))


def rel_close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("rfft", [True, False])
@pytest.mark.parametrize("shape,length", SHAPES, ids=SHAPE_IDS)
def test_inv_eigenvalues_match_jax(shape, length, rfft):
    d = deltas(shape, length)
    rel_close(fft._inv_eigenvalues(shape, d, torch.float64, rfft).numpy(),
              jfft._inv_eigenvalues(shape, d, jnp.float64, rfft))


@pytest.mark.parametrize("shape,length", SHAPES, ids=SHAPE_IDS)
def test_compact_inv_eigenvalues_match_jax(shape, length):
    d = deltas(shape, length)
    got = fft.compact_inv_eigenvalues(shape, d, torch.float64)
    assert got.dtype == torch.complex128
    rel_close(got.numpy(), jfft.compact_inv_eigenvalues(shape, d, jnp.float64))


@pytest.mark.parametrize("shape,length", SHAPES, ids=SHAPE_IDS)
def test_poisson_solve_fft_matches_jax(shape, length):
    d = deltas(shape, length)
    b = field(shape, 1)
    got = fft.poisson_solve_fft(torch.as_tensor(b), d)
    rel_close(got.numpy(), jfft.poisson_solve_fft(jnp.asarray(b), d))
    # the inverse itself: A x = b - mean(b)
    A = make_laplacian_operator(Grid3D(shape, length, device="cpu"))
    rel_close(A(got).numpy(), b, 1e-12)


@pytest.mark.parametrize("shape,length", SHAPES, ids=SHAPE_IDS)
def test_compact_poisson_solve_fft_matches_jax(shape, length):
    """The rfft-layout solve against the JAX CPU branch's full fftn."""
    d = deltas(shape, length)
    b = field(shape, 2)
    rel_close(fft.compact_poisson_solve_fft(torch.as_tensor(b), d).numpy(),
              jfft.compact_poisson_solve_fft(jnp.asarray(b), d))


def smooth_field(n):
    """test_fft.py's smooth manufactured field (sin/cos modes 1-3), mean
    removed: the Krylov path takes smooth right-hand sides (the staggered
    interpolation annihilates Nyquist modes)."""
    g = Grid3D((n,) * 3, device="cpu")
    x, y, z = g.coords(dtype=torch.float64)
    k = 2 * np.pi
    u = (torch.sin(k * x) * torch.cos(2 * k * y) + torch.sin(3 * k * z)
         + torch.cos(k * (x + z)))
    return (u - u.mean()).numpy()


@pytest.fixture(scope="module")
def order6_problem():
    n = 16
    g, jg = Grid3D((n,) * 3, device="cpu"), JGrid3D((n,) * 3)
    jA = jmake_compact(jg)
    u = smooth_field(n)
    b = np.array(jax.jit(jA.apply)(jnp.asarray(u)))
    return g, jg, jA, b


def test_order6_fft_direct_solve(order6_problem):
    g, _, _, b = order6_problem
    s = PoissonSolver(g.n, dtype=torch.float64, device="cpu", order=6,
                      options=SolverOptions(ksp_type="fft"))
    res = s.solve(torch.as_tensor(b))
    assert int(res.iterations) == 1 and bool(res.converged)
    assert s.residual_norm(res.x, torch.as_tensor(b)) <= 1e-10
    rel_close(res.x.numpy(), jfft.compact_poisson_solve_fft(jnp.asarray(b), g.deltas))


def test_order6_cg_gmg_iterations_match_jax(order6_problem):
    g, jg, jA, b = order6_problem
    rtol = 1e-8
    jM = jmake_mg(jg.n, jg.deltas, JMGConfig(), dtype=jnp.float64)
    ref = jax.jit(lambda z: jcg(jA, z, M=jM, rtol=rtol, max_it=80))(jnp.asarray(b))
    s = PoissonSolver(g.n, dtype=torch.float64, device="cpu", order=6,
                      options=SolverOptions(ksp_type="cg", pc_type="mg",
                                            ksp_rtol=rtol, ksp_max_it=80))
    res = s.solve(torch.as_tensor(b))
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged)
    assert s.residual_norm(res.x, torch.as_tensor(b)) <= rtol * 1.01
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(ref.x)).max())


def test_order6_fcg_fft_preconditioner_iterations_match_jax(order6_problem):
    g, jg, jA, b = order6_problem
    argv = ["-ksp_type", "fcg", "-pc_type", "fft", "-ksp_rtol", "1e-10"]
    ref = jax.jit(jksp.make_solver(jA, JOptions(argv), jg.n, jg.deltas,
                                   jnp.float64))(jnp.asarray(b))
    s = PoissonSolver(g.n, dtype=torch.float64, device="cpu", order=6,
                      options=Options(argv))
    res = s.solve(torch.as_tensor(b))
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.iterations) <= 20 and bool(res.converged)


def test_fft_preconditioner_and_monitor(capsys):
    """-pc_type fft on the 7-point operator is its exact inverse (CG
    converges at once); -ksp_type fft prints its residual history after
    the solve."""
    n = 16
    grid = Grid3D((n,) * 3, device="cpu")
    A = make_laplacian_operator(grid)
    u = torch.as_tensor(field((n,) * 3, 3))
    b = A(u)
    res = ksp.solve(A, b, Options(["-ksp_type", "cg", "-pc_type", "fft",
                                   "-ksp_rtol", "1e-12"]), grid=grid)
    assert bool(res.converged) and int(res.iterations) <= 2
    np.testing.assert_allclose(res.x.numpy(), u.numpy(), atol=1e-11)
    assert torch.equal(A.direct_solve(b), fft.poisson_solve_fft(b, grid.deltas))
    capsys.readouterr()
    res = ksp.solve(A, b, Options(["-ksp_type", "fft", "-ksp_monitor",
                                   "-ksp_converged_reason"]), grid=grid)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("  0 KSP Residual norm")
    assert out[1].startswith("  1 KSP Residual norm")
    assert "CONVERGED_ATOL" in out[2]


# the symbol multiply: SHAPES and one odd length along z (no Nyquist plane)
SCALE_SHAPES = SHAPES + [((10, 12, 15), (1.0, 1.5, 0.75))]
SCALE_IDS = SHAPE_IDS + ["odd-z"]


def half_inverse(form, shape, d):
    """The inverse on the rfft half spectrum as the full tables give it."""
    if form == "compact":
        full = fft.compact_inv_eigenvalues(shape, d, torch.float64)
        return full.real[..., : shape[2] // 2 + 1]
    return fft._inv_eigenvalues(shape, d, torch.float64, rfft=True)


@pytest.mark.parametrize("form", ["compact", "sum"])
@pytest.mark.parametrize("shape,length", SCALE_SHAPES, ids=SCALE_IDS)
def test_symbol_scale_equals_the_half_inverse(shape, length, form):
    """symbol_scale on a CPU tensor (the plain version) multiplies each
    half-spectrum value by the full inverse's entry, to 1e-12 relative,
    and zeroes exactly the modes that inverse zeroes."""
    d = deltas(shape, length)
    ref = half_inverse(form, shape, d)
    tables, peak, rel = fft.symbol_tables(shape, d, torch.float64, "cpu", form)
    ones = torch.ones(ref.shape, dtype=torch.complex128) * (1 + 1j)
    got = spectral_cuda.symbol_scale(ones, tables, peak, rel, form)
    assert got is ones
    assert torch.equal(got.real, got.imag)
    rel_close(got.real.numpy(), ref.numpy())
    assert torch.equal(got.real == 0, ref == 0)
    b = torch.as_tensor(field(shape, 5))
    xhat = torch.fft.rfftn(b)
    want = xhat * ref
    spectral_cuda.symbol_scale(xhat, tables, peak, rel, form)
    rel_close(torch.view_as_real(xhat).numpy(), torch.view_as_real(want).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["compact", "sum"])
@pytest.mark.parametrize("shape,length", SCALE_SHAPES, ids=SCALE_IDS)
def test_symbol_tables_are_even(shape, length, form, dtype):
    """Every axis table has t[n - k] == t[k] bit for bit, so the symbol is
    exactly even and the kz = 0 and kz = nz/2 planes of the product stay
    Hermitian; the tables are the float64 ones rounded once."""
    d = deltas(shape, length)
    tables, peak, _ = fft.symbol_tables(shape, d, dtype, "cpu", form)
    wide, _, _ = fft.symbol_tables(shape, d, torch.float64, "cpu", form)
    assert tables.dtype == peak.dtype == dtype and peak.dim() == 0
    assert tables.shape == (spectral_cuda.ROWS[form], sum(shape))
    assert torch.equal(tables, wide.to(dtype))
    for row in tables:
        for t in spectral_cuda.axis_tables(row, shape):
            assert torch.equal(t[1:], t[1:].flip(0))


@pytest.mark.parametrize("form", ["compact", "sum"])
def test_symbol_peak_is_the_full_spectrum_peak(form):
    """The kernel-mode tolerance's peak, from the half spectrum, against
    the largest |S| of the full complex symbol (compact); the 7-point
    form drops only S = 0 (rel 0)."""
    shape, length = SCALE_SHAPES[1]
    d = deltas(shape, length)
    _, peak, rel = fft.symbol_tables(shape, d, torch.float64, "cpu", form)
    if form == "sum":
        assert rel == 0.0 and float(peak) == 0.0
        return
    want = float(torch.max(torch.abs(fft._compact_symbol(shape, d, torch.float64))))
    assert rel == 1e-12 and abs(float(peak) - want) <= 1e-14 * want


@pytest.mark.parametrize("solve,form", [(fft.compact_poisson_solve_fft, "compact"),
                                        (fft.poisson_solve_fft, "sum")])
def test_symbol_tables_built_once_a_key(solve, form):
    """Two solves of one shape build the tables once (SYMBOL_TABLES counts
    builds against applies); another spacing builds them again; the
    cache keeps only its last few keys."""
    fft._TABLES.clear()
    for k in fft.SYMBOL_TABLES:
        fft.SYMBOL_TABLES[k] = 0
    shape = (8, 6, 10)
    b = torch.as_tensor(field(shape, 6))
    x1, x2 = solve(b, (1.0, 1.0, 1.0)), solve(b, (1.0, 1.0, 1.0))
    assert torch.equal(x1, x2)
    assert fft.SYMBOL_TABLES == {"builds": 1, "applies": 2}
    solve(b, (1.0, 0.5, 1.0))
    assert fft.SYMBOL_TABLES == {"builds": 2, "applies": 3}
    assert all(key[4] == form for key in fft._TABLES)
    for k in range(2 * fft._TABLES_KEPT):
        fft.symbol_tables(shape, (1.0, 1.0, 1.0 + k), torch.float64, "cpu", form)
    assert len(fft._TABLES) == fft._TABLES_KEPT
