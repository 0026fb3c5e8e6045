"""The port's Krylov layer against the JAX package: PIPECG, GMRES (the
default KSP) and Richardson through the options entry points, GMRES's
restart clamp and view, and CG's deferred search-direction update (K12).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs jitted on the CPU, its Pallas kernels in interpret mode.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.config import SolverOptions as JSolverOptions
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.ops.stencil_pallas import pupdate_lapl_dot_pallas
from poissbox_tpu.solvers import ksp as jksp
from poissbox_tpu.solvers.cg import cg as jcg
from poissbox_tpu.solvers.gmres import clamp_restart as jclamp_restart
from poissbox_tpu.solvers.mg import MGConfig as JMGConfig
from poissbox_tpu.solvers.mg import make_mg_preconditioner as jmake_mg
from poissbox_tpu_torch.config import SolverOptions
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import stencil_cuda
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers import ksp
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.gmres import _basis_budget_bytes, clamp_restart
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner


def rhs(n, seed):
    """b = A u for u uniform(-1, 1) from a numpy seed, mean removed, formed
    by the JAX roll operator (a writable numpy array)."""
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, (n,) * 3)
    u -= u.mean()
    return np.array(jmake_operator(JGrid3D((n,) * 3), impl="roll")(jnp.asarray(u)))


def history(res):
    h = np.asarray(res.history)
    return h[~np.isnan(h)]


def check_against(res, ref, rtol=1e-8, atol=1e-10):
    """Equal iterations and reason, history and x to rtol."""
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.reason) == int(ref.reason)
    np.testing.assert_allclose(history(res), history(ref), rtol=rtol)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=rtol,
                               atol=atol)


def both(opts, n=16, seed=3):
    """The same options through both packages' make_solver on one b."""
    grid = JGrid3D((n,) * 3)
    b = rhs(n, seed)
    ref = jax.jit(jksp.make_solver(jmake_operator(grid, impl="roll"),
                                   JSolverOptions(**opts), grid.n, grid.deltas,
                                   jnp.float64))(b)
    A = make_laplacian_operator(Grid3D((n,) * 3, device="cpu"))
    res = ksp.make_solver(A, SolverOptions(**opts), (n,) * 3, grid.deltas,
                          torch.float64, device="cpu")(torch.as_tensor(b))
    return res, ref


KSP_CASES = {
    "pipecg-none": dict(ksp_type="pipecg", pc_type="none"),
    "pipecg-jacobi": dict(ksp_type="pipecg", pc_type="jacobi"),
    "pipecg-mg": dict(ksp_type="pipecg", pc_type="mg"),
    "pipecg-mg-natural": dict(ksp_type="pipecg", pc_type="mg",
                              ksp_norm_type="natural"),
    "gmres-none": dict(ksp_type="gmres", pc_type="none"),
    "gmres-jacobi": dict(ksp_type="gmres", pc_type="jacobi"),
    "gmres-mg": dict(ksp_type="gmres", pc_type="mg"),
    "gmres-none-restart5": dict(ksp_type="gmres", pc_type="none", gmres_restart=5),
    "gmres-mg-restart5": dict(ksp_type="gmres", pc_type="mg", gmres_restart=5),
    # undamped Richardson: without a preconditioner it diverges, with
    # Jacobi the checkerboard mode never decays; both run to max_it
    "richardson-none": dict(ksp_type="richardson", pc_type="none", ksp_max_it=20),
    "richardson-jacobi": dict(ksp_type="richardson", pc_type="jacobi",
                              ksp_max_it=30),
    "richardson-mg": dict(ksp_type="richardson", pc_type="mg"),
}


@pytest.mark.parametrize("case", list(KSP_CASES), ids=list(KSP_CASES))
def test_ksp_types_match_jax(case):
    opts = {"ksp_rtol": 1e-8, "ksp_max_it": 300, **KSP_CASES[case]}
    res, ref = both(opts)
    check_against(res, ref)
    if int(ref.reason) > 0:
        assert int(res.reason) > 0


def test_gmres_fused_apply_dot_matches_jax():
    """Unpreconditioned GMRES on the kernel operator takes <V_j, A V_j>
    from K2 (`use_fused`, here K2's plain version) in place of the j-th
    Gram-Schmidt product; against JAX's Pallas operator, which does the
    same, to the same tiers."""
    n = 16
    grid = JGrid3D((n,) * 3)
    b = rhs(n, 19)
    jA = jmake_operator(grid, impl="pallas")
    opts = dict(ksp_type="gmres", pc_type="none", ksp_rtol=1e-8, ksp_max_it=300)
    ref = jax.jit(jksp.make_solver(jA, JSolverOptions(**opts), grid.n,
                                   grid.deltas, jnp.float64))(b)
    A = make_laplacian_operator(Grid3D((n,) * 3, device="cpu"), impl="cuda")
    assert A.apply_dot is not None
    res = ksp.make_solver(A, SolverOptions(**opts), (n,) * 3, grid.deltas,
                          torch.float64, device="cpu")(torch.as_tensor(b))
    check_against(res, ref)


def test_gmres_keeps_a_linear_presmooth():
    """At 512^3 f32 the JAX package's MG default is a bf16 pre-smooth, a
    nonlinear M under which GMRES's residual estimate converges while the
    true residual does not. The port's GMRES keeps that pre-smooth in
    float32 (CG keeps the default) and warns on a bf16 one asked for."""
    A = make_laplacian_operator(Grid3D((8,) * 3, device="cpu"))
    shape, deltas = (512,) * 3, (1.0 / 512,) * 3
    pre = {}
    for ksp_type in ("gmres", "cg", "pipecg"):
        M = ksp.make_preconditioner(A, SolverOptions(ksp_type=ksp_type, pc_type="mg"),
                                    shape, deltas, torch.float32, device="cpu")
        pre[ksp_type] = M.resolved["pre_dtype"]
    assert pre == {"gmres": "float32", "cg": "bfloat16", "pipecg": "bfloat16"}
    with pytest.warns(UserWarning, match="not a linear preconditioner"):
        M = ksp.make_preconditioner(
            A, SolverOptions(ksp_type="gmres", pc_type="mg", mg_pre_dtype="bfloat16"),
            shape, deltas, torch.float32, device="cpu")
    assert M.resolved["pre_dtype"] == "bfloat16"


def test_pipecg_true_residual_follows_the_recurrence():
    """PIPECG keeps r by recurrence one step further from the truth than
    CG: its true residual must still meet the rtol it reports."""
    n = 16
    A = make_laplacian_operator(Grid3D((n,) * 3, device="cpu"))
    b = torch.as_tensor(rhs(n, 5))
    res = ksp.make_solver(A, SolverOptions(ksp_type="pipecg", pc_type="mg",
                                           ksp_rtol=1e-10), (n,) * 3,
                          (1.0 / n,) * 3, torch.float64, device="cpu")(b)
    true = float(torch.linalg.vector_norm(A(res.x) - b) / torch.linalg.vector_norm(b))
    assert int(res.reason) > 0 and true <= 1e-10 * 1.01


def test_default_is_gmres():
    """No options: GMRES(30), no preconditioner, rtol 1e-5 — PETSc's
    default, and the JAX package's (its test_default_is_gmres)."""
    n = 8
    grid = JGrid3D((n,) * 3)
    b = rhs(n, 7)
    ref = jax.jit(lambda z: jksp.solve(jmake_operator(grid), z))(b)
    A = make_laplacian_operator(Grid3D((n,) * 3, device="cpu"))
    res = ksp.solve(A, torch.as_tensor(b))
    assert bool(res.converged) and bool(ref.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-8)
    assert ksp.make_solver(A, device="cpu").opts.ksp_type == "gmres"


class _B:
    """Size and dtype of a 512^3 float32 field, without the field."""
    shape = (512,) * 3
    dtype = torch.float32
    device = torch.device("cpu")

    def numel(self):
        return 512 ** 3

    def element_size(self):
        return 4


class _JB:
    size = 512 ** 3
    dtype = jnp.dtype(jnp.float32)


def test_clamp_restart_matches_jax():
    """4 GiB of basis at 512^3 f32 holds 8 fields: restart 30 -> 7, with
    the JAX package's warning; a small field passes through silently."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = clamp_restart(30, _B(), budget_bytes=4 << 30)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jm = jclamp_restart(30, _JB(), budget_bytes=4 << 30)
    assert m == jm == 7
    assert [str(x.message) for x in w] == [str(x.message) for x in jw]
    assert "shrunk to restart=7" in str(w[0].message)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert clamp_restart(30, torch.zeros(8, 8, 8)) == 30
    assert not w
    # off the card the budget is the JAX package's 4 GiB fallback
    assert _basis_budget_bytes(torch.device("cpu")) == 4 << 30


def test_view_gmres_matches_jax():
    opts = dict(ksp_type="gmres", pc_type="mg", gmres_restart=12)
    jM = jmake_mg((32,) * 3, (1.0,) * 3, JMGConfig(), dtype=jnp.float64)
    M = make_mg_preconditioner((32,) * 3, (1.0,) * 3, MGConfig(), device="cpu")
    lines = ksp.view(SolverOptions(**opts), (32,) * 3, M).splitlines()
    assert "  restart: 12" in lines
    assert "\n".join(lines[:-1]) == jksp.view(JSolverOptions(**opts), (32,) * 3, jM)


# -- deferred search-direction update (K12) ----------------------------------

def _deferred(A, deltas):
    return dataclasses.replace(
        A, pupdate_apply_dot=lambda v, p, beta, zs:
        stencil_cuda.pupdate_lapl_dot_cuda(v, p, beta, zs, deltas))


@pytest.mark.parametrize("precond", ["none", "mg"])
def test_deferred_cg_matches_jax(precond):
    """The JAX package's TestDeferredPUpdate operator (the Pallas K12 bound
    with dataclasses.replace) against the port's (K12's plain version on
    the CPU), with M=None and with the default MG."""
    n = 16
    grid = JGrid3D((n,) * 3)
    deltas = grid.deltas
    jA = dataclasses.replace(
        jmake_operator(grid, impl="pallas"), pupdate_apply_dot=lambda v, p, beta, zs:
        pupdate_lapl_dot_pallas(v, p, beta, zs, deltas))
    A = _deferred(make_laplacian_operator(Grid3D((n,) * 3, device="cpu"),
                                          impl="cuda"), deltas)
    jM = M = None
    if precond == "mg":
        jM = jmake_mg(grid.n, deltas, JMGConfig(), dtype=jnp.float64)
        M = make_mg_preconditioner(grid.n, deltas, MGConfig(), device="cpu")
    b = rhs(n, 11)
    ref = jax.jit(lambda z: jcg(jA, z, M=jM, rtol=1e-10, max_it=400))(b)
    stencil_cuda.reset_launches()
    res = cg(A, torch.as_tensor(b), M=M, rtol=1e-10, max_it=400)
    assert not any(stencil_cuda.LAUNCHES.values())
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-11)


@pytest.mark.parametrize("mg_impl", ["roll", "cuda"])
def test_deferred_cg_matches_eager(mg_impl):
    """Deferred against eager in the port, on the card's call graph (the
    kernel operator; with mg_impl cuda, CG's update rides K5 and the
    x-update uses the p' K12 returned): equal iterations, x to rounding."""
    n = 16
    grid = Grid3D((n,) * 3, device="cpu")
    A = make_laplacian_operator(grid, impl="cuda")
    M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(impl=mg_impl),
                               device="cpu")
    assert (getattr(M, "apply_update_dots", None) is not None) == (mg_impl == "cuda")
    b = torch.as_tensor(rhs(n, 13))
    eager = cg(A, b, M=M, rtol=1e-10, max_it=50)
    deferred = cg(_deferred(A, grid.deltas), b, M=M, rtol=1e-10, max_it=50)
    assert int(deferred.iterations) == int(eager.iterations)
    assert int(deferred.reason) == int(eager.reason) > 0
    np.testing.assert_allclose(deferred.x.numpy(), eager.x.numpy(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(history(deferred), history(eager), rtol=1e-8)


def test_deferred_first_direction_is_z():
    """The first direction forms from p_old = 0, v = z, beta = zshift = 0:
    p' equals v exactly."""
    v = torch.as_tensor(np.random.default_rng(17).uniform(-1, 1, (8, 8, 8)))
    zero = torch.zeros((), dtype=v.dtype)
    pn, ap, pap = stencil_cuda.pupdate_lapl_dot_cuda(
        v, torch.zeros_like(v), zero, zero, (0.125,) * 3)
    assert torch.equal(pn, v)
    y, dot = stencil_cuda.apply_laplacian_dot_cuda(v, (0.125,) * 3)
    assert torch.equal(ap, y) and torch.equal(pap, dot)
