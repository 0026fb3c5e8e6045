"""The port's flexible GMRES (`-ksp_type fgmres`, solvers/gmres.py with
`flexible`) against the benchmark's plain FGMRES
(`perfbench/reference/krylov.py`) and, without a preconditioner, against
the JAX package's GMRES; its true-residual guarantee under the bf16
pre-smooth; the restart clamp over two bases; `-ksp_view`.

Right-hand sides are b = A u for u uniform(-1, 1) from a numpy seed, the
mean removed, applied by the reference operator in float64.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perfbench.reference import krylov, operators
from poissbox_tpu.config import SolverOptions as JSolverOptions
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.solvers import ksp as jksp
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options, SolverOptions
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.solvers import ksp
from poissbox_tpu_torch.solvers.gmres import _basis_budget_bytes, clamp_restart


def rhs(n, seed, dtype=torch.float64):
    u = torch.as_tensor(np.random.default_rng(seed).uniform(-1.0, 1.0, (n,) * 3))
    return operators.apply(2, u - u.mean(), (1.0 / n,) * 3).to(dtype)


def history(res):
    h = res.history.numpy()
    return h[~np.isnan(h)]


def fgmres_solver(n, pc, rtol=1e-8, max_it=400, dtype=torch.float64, extra=()):
    argv = ["-ksp_type", "fgmres", "-pc_type", pc, "-ksp_rtol", repr(rtol),
            "-ksp_max_it", str(max_it), *extra]
    return PoissonSolver((n,) * 3, options=Options(argv), dtype=dtype, device="cpu")


@pytest.mark.parametrize("pc", ["mg", "jacobi", "none"])
@pytest.mark.parametrize("n", [16, 32])
def test_fgmres_matches_the_plain_reference(n, pc):
    """The port's FGMRES(30) and the reference's, handed the port's own
    preconditioner (mean removed, as the port applies it; MG's pre-smooth
    is the field's float64 here) and the reference operator: equal
    iterations, histories and x to 1e-10 relative. The two orthogonalise
    differently (classical Gram-Schmidt over the built rows against
    modified Gram-Schmidt), which in float64 over these steps stays under
    2e-11."""
    s = fgmres_solver(n, pc)
    b = rhs(n, n + 7)
    res = s.solve(b)
    M, A = s._solver.M, s.A
    d = (1.0 / n,) * 3
    ref = krylov.fgmres(lambda v: operators.apply(2, v, d), b,
                        (lambda v: A.project(M(v))) if M is not None else None,
                        rtol=1e-8, max_it=400)
    assert int(res.reason) > 0
    assert int(res.iterations) == ref.iterations
    np.testing.assert_allclose(history(res), ref.history.numpy(), rtol=1e-10)
    assert float(torch.linalg.vector_norm(res.x - ref.x)) <= \
        1e-10 * float(torch.linalg.vector_norm(ref.x))
    # the reported norm is the true residual's (to rounding of ||b||)
    assert abs(float(res.residual_norm) - ref.residual_norm) <= \
        1e-14 * float(torch.linalg.vector_norm(b))


@pytest.mark.parametrize("restart", [30, 5])
def test_fgmres_without_a_preconditioner_is_jax_gmres(restart):
    """With M = I the flexible and the left-preconditioned method build the
    same Krylov space and stop on the same norm, relative to ||b||: the
    JAX package's GMRES gives the iterations, history and x."""
    n = 16
    b = rhs(n, 3)
    grid = JGrid3D((n,) * 3)
    jopts = JSolverOptions(ksp_type="gmres", pc_type="none", ksp_rtol=1e-8,
                           ksp_max_it=300, gmres_restart=restart)
    ref = jax.jit(jksp.make_solver(jmake_operator(grid, impl="roll"), jopts, grid.n,
                                   grid.deltas, jnp.float64))(b.numpy())
    A = make_laplacian_operator(Grid3D((n,) * 3, device="cpu"))
    opts = SolverOptions(ksp_type="fgmres", pc_type="none", ksp_rtol=1e-8,
                         ksp_max_it=300, gmres_restart=restart)
    res = ksp.make_solver(A, opts, (n,) * 3, grid.deltas, torch.float64, device="cpu")(b)
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.reason) == int(ref.reason) > 0
    np.testing.assert_allclose(history(res), np.asarray(ref.history)[:len(history(res))],
                               rtol=1e-8)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8, atol=1e-10)


def test_fgmres_meets_the_true_residual_under_a_bf16_presmooth():
    """At 32^3 f32 with the bf16 pre-smooth (a nonlinear M) FGMRES stops
    converged with a true residual under the rtol, and reports that true
    residual; GMRES under the same M stops with a true residual over 100x
    the rtol (why GMRES keeps a float32 pre-smooth)."""
    n, rtol = 32, 1e-6
    b = rhs(n, 1, torch.float32)
    true = {}
    for ksp_type in ("fgmres", "gmres"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s = PoissonSolver((n,) * 3, dtype=torch.float32, device="cpu", options=Options(
                ["-ksp_type", ksp_type, "-pc_type", "mg", "-ksp_rtol", "1e-6",
                 "-ksp_max_it", "40", "-mg_pre_dtype", "bfloat16"]))
        assert s._solver.M.resolved["pre_dtype"] == "bfloat16"
        res = s.solve(b)
        assert int(res.reason) > 0
        true[ksp_type] = s.residual_norm(res.x, b)
        if ksp_type == "fgmres":
            bnorm = float(torch.linalg.vector_norm(b))
            assert float(res.residual_norm) / bnorm == pytest.approx(true["fgmres"], rel=1e-3)
    assert true["fgmres"] <= rtol
    assert true["gmres"] > 100 * rtol


class _B:
    """Size and dtype of a 512^3 float32 field, without the field."""
    shape = (512,) * 3
    dtype = torch.float32
    device = torch.device("cpu")

    def numel(self):
        return 512 ** 3

    def element_size(self):
        return 4


def test_clamp_restart_counts_both_bases(monkeypatch):
    """FGMRES(30) with a preconditioner holds 61 fields: 32.7 GB at 512^3
    f32, within the budget of one 80-GB card (half its memory, 81559 MiB
    as the card reports it); a budget one byte under 61 fields shrinks it
    to 29, with a warning; GMRES on the same budget keeps 30."""
    field = 512 ** 3 * 4
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (0, 81559 << 20))
    card = _basis_budget_bytes(torch.device("cuda", 0))
    assert card == (81559 << 20) // 2 > 61 * field
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert clamp_restart(30, _B(), budget_bytes=card, flexible=True) == 30
        assert clamp_restart(30, _B(), budget_bytes=61 * field - 1) == 30
    assert not w
    with pytest.warns(RuntimeWarning, match=r"fgmres: restart 30 needs 30\.5 GiB.*restart=29"):
        assert clamp_restart(30, _B(), budget_bytes=61 * field - 1, flexible=True) == 29


def test_clamp_restart_over_ranks_counts_both_bases():
    """Over a process grid the ranks take the largest box against the
    smallest budget for the flexible count too: a budget just under 61
    fields of the largest of 64^3's (3, 1, 1) boxes gives 29 on every
    rank, where each rank's own block alone would give 29 or 30."""
    from poissbox_tpu_torch.parallel.decomp import owned_boxes
    blocks = [torch.zeros(c, dtype=torch.float64)
              for _, (_, c) in sorted(owned_boxes((64,) * 3, (3, 1, 1)).items())]
    big = 61 * 90112 * 8 - 1
    with pytest.warns(RuntimeWarning):
        alone = [clamp_restart(30, b, budget_bytes=big, flexible=True) for b in blocks]
    assert alone == [29, 30, 30]
    vectors = [torch.tensor([b.numel() * 8, -big], dtype=torch.float64) for b in blocks]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        agreed = [clamp_restart(30, b, budget_bytes=big, flexible=True,
                                allreduce_max=lambda t: torch.stack(vectors).max(0).values)
                  for b in blocks]
    assert agreed == [29, 29, 29] and len(w) == 3


def test_view_fgmres_keeps_the_bf16_presmooth():
    """At 512^3 f32 FGMRES takes the automatic bf16 pre-smooth (CG's; GMRES
    and PIPECG keep float32), without a warning, and `-ksp_view` shows
    its type and restart."""
    A = make_laplacian_operator(Grid3D((8,) * 3, device="cpu"))
    opts = SolverOptions(ksp_type="fgmres", pc_type="mg", ksp_rtol=1e-6)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        M = ksp.make_preconditioner(A, opts, (512,) * 3, (1.0 / 512,) * 3, torch.float32,
                                    device="cpu")
    assert not w
    assert M.resolved["pre_dtype"] == "bfloat16"
    lines = ksp.view(opts, None, M).splitlines()
    assert "  type: fgmres" in lines and "  restart: 30" in lines
    assert lines[-1].endswith("pre-smooth bfloat16")


def test_fgmres_restarts_from_the_true_residual():
    """A restart of 3 at 16^3 with Jacobi: cycles of three steps, each
    ending in x's true residual, and the last cycle's norm reported is
    the true one."""
    s = fgmres_solver(16, "jacobi", extra=("-gmres_restart", "3"))
    b = rhs(16, 5)
    res = s.solve(b)
    assert int(res.reason) > 0 and int(res.iterations) > 3
    bnorm = float(torch.linalg.vector_norm(b))
    assert float(res.residual_norm) / bnorm == pytest.approx(s.residual_norm(res.x, b), rel=1e-6)
    assert s.residual_norm(res.x, b) <= 1e-8
