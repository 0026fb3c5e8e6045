"""The port's mixed-precision iterative refinement against the JAX
package's: float32 MG-CG corrections, float64 true residuals, at 16^3
(the JAX package's own refinement tests run at 32^3 and are slow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.api import PoissonSolver as JPoissonSolver
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.solvers.cg import cg as jcg
from poissbox_tpu.solvers.mg import MGConfig as JMGConfig
from poissbox_tpu.solvers.mg import make_mg_preconditioner as jmake_mg
from poissbox_tpu.solvers.refine import refine as jrefine
from poissbox_tpu_torch import interop
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner
from poissbox_tpu_torch.solvers.refine import RefineResult, refine

N = 16


def rhs(seed):
    """b = A u (float64) for u uniform(-1, 1) from a numpy seed, mean
    removed, formed by the JAX roll operator."""
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, (N,) * 3)
    u -= u.mean()
    return np.array(jmake_operator(JGrid3D((N,) * 3), impl="roll")(jnp.asarray(u)))


def check_against(res: RefineResult, ref, b):
    """Equal outer and inner counts, both final true residuals <= 1e-12
    ||b||, and the two solutions to the refinement's own accuracy."""
    assert isinstance(res, RefineResult) and res.x.dtype == torch.float64
    assert res.outer_iterations == ref.outer_iterations
    assert res.inner_iterations == ref.inner_iterations
    bnorm = float(np.linalg.norm(b))
    assert float(res.residual_norm) <= 1e-12 * bnorm
    assert float(ref.residual_norm) <= 1e-12 * bnorm
    got = interop.refine_result_to_numpy(res)
    want = interop.refine_result_to_numpy(interop.refine_result_from_numpy(ref))
    assert got.keys() == want.keys()
    assert got["history"].shape == want["history"].shape
    np.testing.assert_allclose(got["history"][0], want["history"][0], rtol=1e-12)
    # later entries are float32 rounding noise of each package's inner
    # solve: the same order, not the same digits
    ratio = got["history"][1:] / want["history"][1:]
    assert (ratio > 0.5).all() and (ratio < 2.0).all(), ratio
    np.testing.assert_allclose(got["x"], want["x"], rtol=0,
                               atol=1e-9 * np.abs(want["x"]).max())


@pytest.mark.parametrize("mg_impl", ["roll", "cuda"])
def test_refine_matches_jax(mg_impl):
    """refine() with an explicit float32 MG-CG inner solve; with mg_impl
    cuda the inner solve walks the card's call graph (K5 in the cycle)."""
    grid = JGrid3D((N,) * 3)
    b = rhs(1)
    jA = jmake_operator(grid)
    jM = jmake_mg(grid.n, grid.deltas, JMGConfig(), dtype=jnp.float32)
    jinner = jax.jit(lambda r: jcg(jA, r, M=jM, rtol=1e-6, max_it=50))
    ref = jrefine(jA, jinner, jnp.asarray(b), rtol=1e-12, max_outer=4)
    tgrid = Grid3D((N,) * 3, device="cpu")
    A = make_laplacian_operator(tgrid, impl="cuda")
    M = make_mg_preconditioner(tgrid.n, tgrid.deltas, MGConfig(impl=mg_impl),
                               dtype=torch.float32, device="cpu")
    inner = lambda r: cg(A, r, M=M, rtol=1e-6, max_it=50)
    res = refine(A, inner, torch.as_tensor(b), rtol=1e-12, max_outer=4)
    check_against(res, ref, b)


def test_solve_refined_matches_jax():
    b = rhs(2)
    ref = JPoissonSolver((N,) * 3).solve_refined(jnp.asarray(b))
    s = PoissonSolver((N,) * 3, dtype=torch.float64, device="cpu")
    res = s.solve_refined(torch.as_tensor(b))
    check_against(res, ref, b)
    assert s.residual_norm(res.x, torch.as_tensor(b)) <= 1e-12


def test_refine_casts_and_stops():
    """b arrives in float32 and is refined in float64; the inner solve sees
    float32 residuals; a b already solved by x0 stops with no inner
    solve."""
    grid = Grid3D((8,) * 3, device="cpu")
    A = make_laplacian_operator(grid)
    M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(),
                               dtype=torch.float32, device="cpu")
    seen = []

    def inner(r):
        seen.append(r.dtype)
        return cg(A, r, M=M, rtol=1e-6, max_it=50)

    u = A.project(torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (8,) * 3)))
    b = A(u)
    res = refine(A, inner, b.float(), rtol=1e-10)
    assert res.x.dtype == torch.float64 and set(seen) == {torch.float32}
    # as in the JAX package, the outer count includes the pass that finds
    # the residual converged
    assert res.outer_iterations == len(res.history) - 1 == len(seen) + 1
    done = refine(A, inner, b, x0=u, rtol=1e-10)
    assert done.outer_iterations == 1 and done.inner_iterations == 0
    assert len(seen) == res.outer_iterations - 1
