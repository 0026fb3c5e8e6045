"""The port's slice as a whole against the JAX package: MG-preconditioned
CG through PoissonSolver and the options entry points.

At 32^3 the port's kernel path (-mg_impl cuda; on CPU tensors every level
runs the kernels' plain versions) is held to JAX's Pallas path in
interpret mode; at 64^3 the port's default CPU path to JAX's default path
(6 iterations to rtol 1e-8).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.config import SolverOptions as JSolverOptions
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.solvers import ksp as jksp
from poissbox_tpu.solvers.cg import cg as jcg
from poissbox_tpu.solvers.mg import MGConfig as JMGConfig
from poissbox_tpu.solvers.mg import make_mg_preconditioner as jmake_mg
from poissbox_tpu_torch import checkpoint, demo
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers import ksp
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner


def rhs_field(n, seed=1):
    """The Motivation's right-hand-side recipe: u uniform(-1, 1) from a
    numpy seed, mean removed (b = A u is formed by each side)."""
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, (n,) * 3)
    return u - u.mean()


def jax_rhs(u, n):
    A = jmake_operator(JGrid3D((n,) * 3), impl="roll")
    return np.array(A(jnp.asarray(u)))   # writable, for torch.as_tensor


def history(res):
    h = np.asarray(res.history)
    return h[~np.isnan(h)]


@pytest.fixture(scope="module")
def pallas_ref32():
    """JAX CG with the Pallas operator and MG(impl=pallas, roll transfers)
    in interpret mode, at 32^3 to rtol 1e-10."""
    n = 32
    grid = JGrid3D((n,) * 3)
    A = jmake_operator(grid, impl="pallas")
    M = jmake_mg(grid.n, grid.deltas,
                 JMGConfig(impl="pallas", transfers="roll"), dtype=jnp.float64)
    b = jax_rhs(rhs_field(n), n)
    res = jax.jit(lambda z: jcg(A, z, M=M, rtol=1e-10, max_it=60))(b)
    return b, res


def check_against(res, ref):
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.reason) == int(ref.reason) > 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(history(res), history(ref), rtol=1e-8)


def test_poisson_solver_kernel_path_matches_pallas(pallas_ref32):
    b, ref = pallas_ref32
    s = PoissonSolver((32,) * 3, dtype=torch.float64, device="cpu", options=Options(
        ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-10",
         "-ksp_max_it", "60", "-mg_impl", "cuda"]))
    assert getattr(s._solver.M, "apply_update_dots", None) is not None
    check_against(s.solve(torch.as_tensor(b)), ref)


def test_kernel_operator_and_mg_match_pallas(pallas_ref32):
    """The whole kernel call graph: A.apply_dot (K2) as CG's matvec, and
    the fused update (K5) in the cycle, as the card runs it."""
    b, ref = pallas_ref32
    grid = Grid3D((32,) * 3, device="cpu")
    A = make_laplacian_operator(grid, impl="cuda")
    M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(impl="cuda"), device="cpu")
    res = cg(A, torch.as_tensor(b), M=M, rtol=1e-10, max_it=60)
    check_against(res, ref)


def test_default_path_64_matches_jax_six_iterations():
    n = 64
    grid = JGrid3D((n,) * 3)
    A = jmake_operator(grid)
    M = jmake_mg(grid.n, grid.deltas, JMGConfig(), dtype=jnp.float64)
    b = jax_rhs(rhs_field(n), n)
    ref = jax.jit(lambda z: jcg(A, z, M=M, rtol=1e-8, max_it=50))(b)
    s = PoissonSolver((n,) * 3, dtype=torch.float64, device="cpu", options=SolverOptions(
        ksp_type="cg", pc_type="mg", ksp_rtol=1e-8, ksp_max_it=50))
    res = s.solve(torch.as_tensor(b))
    assert int(ref.iterations) == int(res.iterations) == 6
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(history(res), history(ref), rtol=1e-8)
    assert s.residual_norm(res.x, torch.as_tensor(b)) <= 1e-8 * 1.01


@pytest.mark.parametrize("opts", [
    {"ksp_type": "fcg", "pc_type": "mg"},
    {"ksp_type": "cg", "pc_type": "mg", "ksp_norm_type": "natural"},
    {"ksp_type": "cg", "pc_type": "none"},
    {"ksp_type": "cg", "pc_type": "jacobi"},
    {"ksp_type": "cg", "pc_type": "mg", "mg_levels_pc_type": "jacobi",
     "mg_levels_ksp_max_it": 2},
    {"ksp_type": "cg", "pc_type": "mg", "mg_levels_ksp_type": "chebyshev",
     "mg_cycle": "w"},
], ids=["fcg", "natural", "none", "jacobi", "mg-jacobi", "mg-chebyshev-w"])
def test_options_match_jax(opts):
    n, rtol = 8, 1e-9
    opts = {**opts, "ksp_rtol": rtol, "ksp_max_it": 200}
    grid = JGrid3D((n,) * 3)
    jA = jmake_operator(grid, impl="roll")
    b = jax_rhs(rhs_field(n, 3), n)
    ref = jax.jit(jksp.make_solver(jA, JSolverOptions(**opts), grid.n,
                                   grid.deltas, jnp.float64))(b)
    A = make_laplacian_operator(Grid3D((n,) * 3, device="cpu"))
    res = ksp.make_solver(A, SolverOptions(**opts), (n,) * 3, grid.deltas,
                          torch.float64, device="cpu")(torch.as_tensor(b))
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-7,
                               atol=1e-10)
    # unpreconditioned CG at 8^3 ends in rounding noise: atol for that
    np.testing.assert_allclose(history(res), history(ref), rtol=1e-7,
                               atol=1e-12 * history(ref)[0])


def test_warm_start_and_max_it():
    n = 16
    A = make_laplacian_operator(Grid3D((n,) * 3, device="cpu"))
    u = torch.as_tensor(rhs_field(n, 4))
    b = A(u)
    cold = cg(A, b, rtol=1e-10, max_it=3)
    assert int(cold.iterations) == 3 and int(cold.reason) == -3
    assert len(cold.history) == 4 and not torch.isnan(cold.history).any()
    warm = cg(A, b, x0=cold.x, rtol=1e-10, max_it=200)
    assert int(warm.reason) > 0
    assert float(torch.linalg.vector_norm(A(warm.x) - b)) <= \
        1e-10 * 1.01 * float(torch.linalg.vector_norm(b))


def test_ksp_solve_prints(capsys):
    n = 8
    grid = Grid3D((n,) * 3, device="cpu")
    A = make_laplacian_operator(grid)
    b = A(torch.as_tensor(rhs_field(n, 5)))
    res = ksp.solve(A, b, Options(["-ksp_type", "cg", "-pc_type", "mg",
                                   "-ksp_monitor", "-ksp_converged_reason",
                                   "-ksp_view"]), grid=grid)
    out = capsys.readouterr().out
    assert "KSP Residual norm" in out and "CONVERGED_RTOL" in out
    assert "cycle: V(3,3) x1" in out and "levels: 8x8x8 -> 4x4x4" in out
    assert len(res.monitor_lines()) == int(res.iterations) + 1


def test_view_matches_jax():
    """The JAX package's view, line for line, plus the port's line with
    the transfer form and pre-smooth dtype the device resolved."""
    opts = dict(ksp_type="cg", pc_type="mg", mg_cycle="w")
    jM = jmake_mg((64, 64, 32), (1.0,) * 3, JMGConfig(cycle="w"),
                  dtype=jnp.float64)
    M = make_mg_preconditioner((64, 64, 32), (1.0,) * 3, MGConfig(cycle="w"), device="cpu")
    lines = ksp.view(SolverOptions(**opts), (64, 64, 32), M).splitlines()
    assert lines[-1] == "  resolved: transfers roll, pre-smooth float64"
    assert "\n".join(lines[:-1]) == \
        jksp.view(JSolverOptions(**opts), (64, 64, 32), jM)
    M = make_mg_preconditioner((512,) * 3, (1.0,) * 3,
                               MGConfig(impl="cuda", transfers="matmul"),
                               torch.float32, device="cpu")
    assert ksp.view(SolverOptions(**opts), None, M).splitlines()[-1] == \
        "  resolved: transfers matmul, pre-smooth bfloat16"


def test_mg_impl_pallas_runs_as_cuda():
    """A reference command line that says -mg_impl pallas runs unchanged,
    on the kernel path."""
    n = 16
    grid = Grid3D((n,) * 3, device="cpu")
    b = make_laplacian_operator(grid)(torch.as_tensor(rhs_field(n, 6)))
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-9",
            "-mg_transfers", "matmul", "-mg_impl"]
    res = {}
    for impl in ("pallas", "cuda"):
        s = PoissonSolver((n,) * 3, dtype=torch.float64, device="cpu",
                          options=Options(argv + [impl]))
        assert getattr(s._solver.M, "apply_update_dots", None) is not None
        res[impl] = s.solve(b)
    assert int(res["pallas"].iterations) == int(res["cuda"].iterations)
    assert torch.equal(res["pallas"].x, res["cuda"].x)


def test_jacobi_mgcg_iteration_parity_32():
    """MG-CG with Jacobi-smoothed levels on the card's call graph: K10 on
    every level, no fused M-side entry, so CG takes the operator's fused
    update (K8) and apply_dots. Same iteration count as the JAX package
    (roll operators, matmul transfers)."""
    n, rtol = 32, 1e-10
    grid = JGrid3D((n,) * 3)
    jA = jmake_operator(grid, impl="roll")
    b = jax_rhs(rhs_field(n, 7), n)
    kw = dict(smoother="jacobi", transfers="matmul")
    jM = jmake_mg(grid.n, grid.deltas, JMGConfig(impl="roll", **kw),
                  dtype=jnp.float64)
    ref = jax.jit(lambda z: jcg(jA, z, M=jM, rtol=rtol, max_it=80))(b)
    tgrid = Grid3D((n,) * 3, device="cpu")
    A = make_laplacian_operator(tgrid, impl="cuda")
    M = make_mg_preconditioner(tgrid.n, tgrid.deltas, MGConfig(impl="cuda", **kw), device="cpu")
    assert A.fused_update is not None and M.apply_dots is not None
    assert getattr(M, "apply_update_dots", None) is None
    res = cg(A, torch.as_tensor(b), M=M, rtol=rtol, max_it=80)
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.reason) == int(ref.reason) > 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(history(res), history(ref), rtol=1e-8)


def test_demo_runs_on_cpu(capsys):
    rel = demo.run(Options(["-n", "16", "-ksp_rtol", "1e-8", "-device", "cpu"]))
    assert rel <= 1e-8 * 1.01
    out = capsys.readouterr().out
    for line in ("check_lapl", "check_matrices[assembled]", "verification"):
        assert line in out


@pytest.mark.parametrize("ksp_type", ["gmres", "pipecg", "richardson", "fft"])
def test_unported_ksp_types_raise(ksp_type):
    """Every ksp_type that raised before its slice now builds and
    converges: the Krylov methods with the MG preconditioner to rtol 1e-8
    (tests/test_torch_krylov.py holds them to the JAX package); `fft`
    builds the direct solve: one iteration, u back to rounding (the JAX
    package's test_ksp_dispatch_fft)."""
    A = make_laplacian_operator(Grid3D((8, 8, 8), device="cpu"))
    if ksp_type != "fft":
        solver = ksp.make_solver(A, SolverOptions(ksp_type=ksp_type, pc_type="mg",
                                                  ksp_rtol=1e-8), (8,) * 3,
                                 (0.125,) * 3, device="cpu")
        u = torch.as_tensor(rhs_field(8, 7))
        b = A(u)
        res = solver(b)
        assert bool(res.converged) and int(res.iterations) > 0
        assert float(torch.linalg.vector_norm(A(res.x) - b)) <= \
            1e-6 * float(torch.linalg.vector_norm(b))
        return
    solver = ksp.make_solver(A, SolverOptions(ksp_type="fft"), (8,) * 3,
                             (0.125,) * 3, device="cpu")
    assert solver.M is None
    u = torch.as_tensor(rhs_field(8, 7))
    res = solver(A(u))
    assert int(res.iterations) == 1 and bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), u.numpy(), atol=1e-12)


def test_unported_facade_entries_raise(tmp_path):
    """Every facade entry that raised before its slice now works: order=6
    builds the compact operator; solve_refined reaches 1e-12 and
    solve_checkpointed converges and leaves its checkpoint
    (tests/test_torch_refine.py and test_torch_checkpoint.py hold them to
    the JAX package)."""
    s6 = PoissonSolver((8, 8, 8), order=6, dtype=torch.float64, device="cpu",
                       options=SolverOptions(ksp_type="fft"))
    u = s6.A.project(torch.as_tensor(rhs_field(8, 8)))
    b6 = s6.A(u)
    assert s6.residual_norm(s6.solve(b6).x, b6) < 1e-12
    s = PoissonSolver((8, 8, 8), dtype=torch.float64, device="cpu")
    b = s.rhs_for(torch.as_tensor(rhs_field(8, 9)))
    ref = s.solve_refined(b)
    assert float(ref.residual_norm) <= 1e-12 * float(torch.linalg.vector_norm(b))
    res, total = s.solve_checkpointed(b, str(tmp_path / "ckpt"), every=2)
    assert bool(res.converged) and total >= int(res.iterations) > 0
    assert (tmp_path / "ckpt.npz").is_file()


def test_entry_points_default_to_the_card(tmp_path):
    """PoissonSolver (and with it solve_refined and solve_checkpointed),
    the demo, Grid3D, the ksp/mg constructors (every ksp_type) and
    checkpoint.load run on the card unless the caller asks for the CPU;
    without a card a CUDA request raises and never falls back."""
    assert Grid3D((4, 4, 4)).device.type == "cuda"
    for fn in (ksp.make_solver, ksp.make_preconditioner, make_mg_preconditioner,
               checkpoint.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    for order in (2, 6):
        with pytest.raises(RuntimeError, match="CUDA"):
            PoissonSolver((8, 8, 8), order=order)
    with pytest.raises(RuntimeError, match="cuda"):
        demo.run(Options(["-n", "8"]))
    A = make_laplacian_operator(Grid3D((8, 8, 8), device="cpu"))
    with pytest.raises((RuntimeError, AssertionError)):
        ksp.make_solver(A, SolverOptions(), (8,) * 3, (0.125,) * 3)
    for ksp_type in ("gmres", "pipecg", "richardson"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ksp.make_solver(A, SolverOptions(ksp_type=ksp_type), (8,) * 3,
                            (0.125,) * 3)
    path = checkpoint.save(str(tmp_path / "ckpt"), {"x": torch.zeros(2)})
    with pytest.raises((RuntimeError, AssertionError)):
        checkpoint.load(path)
