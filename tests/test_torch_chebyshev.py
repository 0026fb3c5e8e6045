"""CG over multigrid with Chebyshev level smoothing (`-mg_levels_ksp_type
chebyshev -mg_levels_pc_type jacobi`, PETSc GAMG's level smoother) against
the benchmark's plain V-cycle and PCG (`perfbench/reference/multigrid.py`)
and the JAX package; the options' mapping to the cycle at 512^3, built
without a solve.

Right-hand sides are b = A u for u uniform(-1, 1) from a numpy seed, the
mean removed, applied by the reference operator in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perfbench.reference import multigrid, operators
from poissbox_tpu.config import SolverOptions as JSolverOptions
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.solvers import ksp as jksp
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.solvers import ksp
from poissbox_tpu_torch.solvers.mg import chebyshev_degree

CHEB = ["-ksp_type", "cg", "-pc_type", "mg", "-mg_levels_ksp_type", "chebyshev",
        "-mg_levels_pc_type", "jacobi", "-ksp_max_it", "100"]
# the kernel path's plain versions: every level's stencil, and the fused
# transfer legs, as the card runs them
IMPLS = {"roll": [], "kernels": ["-mg_impl", "cuda", "-mg_transfers", "matmul"]}
SHAPES = [(32, 32, 32), (24, 16, 40)]


def rhs(shape, seed, dtype=torch.float64):
    u = torch.as_tensor(np.random.default_rng(seed).uniform(-1.0, 1.0, shape))
    return operators.lapl7(u - u.mean(), deltas(shape)).to(dtype)


def deltas(shape):
    return tuple(1.0 / n for n in shape)


def solver(shape, extra=(), rtol=1e-8, dtype=torch.float64):
    return PoissonSolver(shape, options=Options(CHEB + ["-ksp_rtol", repr(rtol), *extra]),
                         dtype=dtype, device="cpu")


def reference_cycle(shape, M):
    """The reference V-cycle with the port's resolved degrees."""
    levels = multigrid.hierarchy(shape, deltas(shape))
    assert [lv[0] for lv in levels] == [lv.shape for lv in M.levels]
    pre, post = (chebyshev_degree(s) for s in (M.config.pre_smooth, M.config.post_smooth))
    return lambda r: multigrid.v_cycle(r, levels, pre, post)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("shape", SHAPES, ids=["32^3", "24x16x40"])
def test_one_cycle_is_the_reference_cycle(shape, impl):
    """One M(r) of the port, f64, against the reference V-cycle on the
    same r, to 1e-12 relative: the same polynomial, transfers and exact
    coarse solve, the port's Chebyshev in Saad's two-term (d, rho) form
    and the reference's in the three-term form; they differ by rounding,
    5e-16 here."""
    s = solver(shape, IMPLS[impl])
    M = s._solver.M
    assert M.config.smoother == "chebyshev" and len(M.levels) >= 3
    r = rhs(shape, 5)
    e, ref = M(r), reference_cycle(shape, M)(r)
    assert float(torch.linalg.vector_norm(e - ref)) <= 1e-12 * float(torch.linalg.vector_norm(ref))


@pytest.mark.parametrize("shape", SHAPES, ids=["32^3", "24x16x40"])
def test_cg_is_the_reference_pcg(shape):
    """The port's CG + Chebyshev MG and the reference PCG over the
    reference V-cycle, to rtol 1e-8: equal iterations, and x to 1e-12
    relative. Each cycle agrees to rounding (5e-16), and over the 4-5
    iterations x does too (8e-16 here): 1e-12 leaves three orders of room
    for the two CGs' different order of reductions."""
    s = solver(shape)
    b = rhs(shape, 7)
    res = s.solve(b)
    ref = multigrid.pcg(lambda v: operators.lapl7(v, deltas(shape)), b,
                        reference_cycle(shape, s._solver.M), rtol=1e-8)
    assert int(res.reason) > 0 and int(res.iterations) == ref.iterations >= 3
    assert float(torch.linalg.vector_norm(res.x - ref.x)) <= \
        1e-12 * float(torch.linalg.vector_norm(ref.x))


def test_iterations_are_the_jax_packages():
    """The same options in the JAX package (16^3, f64, rtol 1e-8): equal
    iterations and x to 1e-8 relative (the tolerance of the port's other
    options tests against it)."""
    shape = (16, 16, 16)
    b = rhs(shape, 3)
    grid = JGrid3D(shape)
    jopts = JSolverOptions(ksp_type="cg", pc_type="mg", mg_levels_ksp_type="chebyshev",
                           mg_levels_pc_type="jacobi", ksp_rtol=1e-8, ksp_max_it=100)
    ref = jax.jit(jksp.make_solver(jmake_operator(grid, impl="roll"), jopts, grid.n,
                                   grid.deltas, jnp.float64))(b.numpy())
    res = solver(shape).solve(b)
    assert int(res.iterations) == int(ref.iterations) > 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n,extra,degree,levels", [
    (512, [], 2, 8),
    (512, ["-mg_levels_ksp_max_it", "2"], 4, 8),
    (64, [], 6, 5),
], ids=["512-default", "512-max_it-2", "64-default"])
def test_the_options_resolve_to_the_cycle(n, extra, degree, levels):
    """`make_preconditioner`'s resolved cycle, built with no solve (the
    hierarchy and a 4^3 pseudo-inverse): at 512^3 f32 PETSc's 2
    Chebyshev iterations a side are the size-aware default's one sweep,
    degree 2, with the bf16 pre-smooth and 8 levels; passing
    -mg_levels_ksp_max_it 2 builds degree 4 (the port counts two degrees
    a sweep)."""
    shape = (n,) * 3
    opts = SolverOptions.from_options(Options(CHEB + ["-ksp_rtol", "1e-6", *extra]))
    A = make_laplacian_operator(Grid3D(shape, device="cpu"))
    M = ksp.make_preconditioner(A, opts, shape, deltas(shape), torch.float32, "cpu")
    cfg = M.config
    assert cfg.smoother == "chebyshev" and cfg.cycle == "v" and len(M.levels) == levels
    assert chebyshev_degree(cfg.pre_smooth) == chebyshev_degree(cfg.post_smooth) == degree
    assert M.resolved["pre_dtype"] == ("bfloat16" if n >= 512 else "float32")
    view = ksp.view(opts, shape, M)
    sweeps = degree // 2
    assert f"cycle: V({sweeps},{sweeps}) x1" in view and "smoother: chebyshev\n" in view
