"""The port's auxiliary subsystems (poissbox_tpu_torch.utils: logging and
debugging) against the JAX package's (poissbox_tpu.utils), on the same
inputs made with numpy: the ported cases of tests/test_utils.py, a
one-rank gloo process group for the rank-aware logging, and the NaN
checks of the Krylov loops on an 8^3 MG-CG solve whose b holds a NaN."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import poissbox_tpu.utils as jutils
from poissbox_tpu.api import PoissonSolver as JPoissonSolver
from poissbox_tpu.config import Options as JOptions
from poissbox_tpu_torch import utils
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.result import ConvergedReason
from poissbox_tpu_torch.utils import debugging, logging

MGCG = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8"]


def test_exports_match_jax():
    assert utils.__all__ == jutils.__all__
    for name in utils.__all__:
        assert callable(getattr(utils, name))


# ---------------------------------------------------------------------------
# check_field
# ---------------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64)}
# (field, keyword arguments with dtype by name, exception or None, match)
FIELD_CASES = {
    "passes": (np.ones((4, 4)), dict(shape=(4, 4), dtype="float64"), None, None),
    "shape": (np.ones((4, 4)), dict(shape=(8, 8)), ValueError, "shape"),
    "nan": (np.array([1.0, np.nan]), {}, FloatingPointError, "NaN"),
    "inf": (np.array([1.0, -np.inf]), {}, FloatingPointError, "NaN/Inf"),
    "dtype": (np.ones(3, np.float32), dict(dtype="float64"), TypeError, "dtype"),
    "nan, finite off": (np.array([np.nan, 2.0]), dict(finite=False), None, None),
    "named": (np.ones(2), dict(shape=(3,), name="rhs"), ValueError, "^rhs: shape"),
}


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_check_field_matches_jax(case):
    """Both packages pass the same fields and refuse the others with the
    same exception type and message."""
    f, kw, exc, match = FIELD_CASES[case]
    for pkg, to in ((utils, torch.as_tensor), (jutils, jnp.asarray)):
        dt = kw.get("dtype")
        args = dict(kw, dtype=DTYPES[dt][pkg is jutils]) if dt else kw
        x = to(f)
        if exc is None:
            assert pkg.check_field(x, **args) is x
        else:
            with pytest.raises(exc, match=match):
                pkg.check_field(x, **args)


def test_check_field_passes():
    f = torch.ones((4, 4))
    assert utils.check_field(f, shape=(4, 4), dtype=f.dtype) is f


def test_check_field_dtype_takes_a_torch_dtype():
    with pytest.raises(TypeError, match="torch.float64"):
        utils.check_field(torch.ones(3, dtype=torch.float32), dtype=torch.float64)


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

def test_log0_matches_jax(capsys):
    for pkg in (jutils, utils):
        assert pkg.is_process0()
        pkg.log0("hello", 42)
        pkg.log0("x", all_processes=True)
        pkg.log0("y", 1.5, sep="|", end="!\n")
    out = capsys.readouterr().out.splitlines(keepends=True)
    assert out[:3] == out[3:]
    assert out[:3] == ["hello 42\n", "[p0] x\n", "y|1.5!\n"]


def test_log0_to_a_file(capsys):
    buf = io.StringIO()
    utils.log0("to", "file", file=buf)
    assert buf.getvalue() == "to file\n" and capsys.readouterr().out == ""


@pytest.fixture
def one_rank_group():
    """A one-process gloo group on an in-memory store, destroyed after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_rank_from_a_process_group(one_rank_group, capsys, monkeypatch):
    """Under an initialised group the rank is torch.distributed's: rank 0
    prints, with [p0] for all_processes; a rank 1 prints only with
    all_processes, prefixed [p1]."""
    assert dist.get_rank() == 0 and utils.is_process0()
    utils.log0("a")
    utils.log0("b", all_processes=True)
    assert capsys.readouterr().out == "a\n[p0] b\n"
    monkeypatch.setattr(logging.dist, "get_rank", lambda: 1)
    assert not utils.is_process0()
    utils.log0("c")
    utils.log0("d", all_processes=True)
    assert capsys.readouterr().out == "[p1] d\n"


# ---------------------------------------------------------------------------
# NaN checks
# ---------------------------------------------------------------------------

@pytest.fixture
def nan_flags():
    """Restores both packages' NaN switches after the test."""
    prev = (debugging.nan_checks_enabled(), jax.config.jax_debug_nans)
    yield
    utils.enable_nan_checks(prev[0])
    jax.config.update("jax_debug_nans", prev[1])


def nan_rhs(n=8):
    """b = A u (u uniform(-1, 1) from numpy seed 1, mean removed) with one
    NaN, as a numpy array."""
    u = np.random.default_rng(1).uniform(-1.0, 1.0, (n,) * 3)
    u -= u.mean()
    s = PoissonSolver((n,) * 3, dtype=torch.float64, device="cpu")
    b = s.rhs_for(torch.as_tensor(u)).numpy().copy()
    b[3, 2, 1] = np.nan
    return b


def test_nan_b_raises_like_jax(nan_flags):
    """8^3 MG-CG with a NaN in b: with the checks on, the port raises
    FloatingPointError naming CG and iteration 0, as the JAX package does
    under jax_debug_nans; with them off, both stop at once with
    DIVERGED_NAN."""
    b = nan_rhs()
    s = PoissonSolver((8,) * 3, options=Options(MGCG), dtype=torch.float64, device="cpu")
    js = JPoissonSolver((8,) * 3, options=JOptions(MGCG))
    for res in (s.solve(torch.as_tensor(b)), js.solve(jnp.asarray(b))):
        assert int(res.iterations) == 0
        assert int(res.reason) == int(ConvergedReason.DIVERGED_NAN)
    utils.enable_nan_checks()
    with pytest.raises(FloatingPointError, match="^cg: .* iteration 0 "):
        s.solve(torch.as_tensor(b))
    # a solver built with the switch on: a jitted function already called
    # with it off may take the dispatch path that does not check
    jutils.enable_nan_checks()
    with pytest.raises(FloatingPointError):
        JPoissonSolver((8,) * 3, options=JOptions(MGCG)).solve(jnp.asarray(b))
    utils.enable_nan_checks(False)
    assert int(s.solve(torch.as_tensor(b)).iterations) == 0


@pytest.mark.parametrize("ksp", ["cg", "fcg", "pipecg", "gmres", "richardson"])
def test_every_krylov_loop_checks(nan_flags, ksp):
    b = torch.as_tensor(nan_rhs())
    s = PoissonSolver((8,) * 3, options=Options(["-ksp_type", ksp, "-pc_type", "mg"]),
                      dtype=torch.float64, device="cpu")
    utils.enable_nan_checks()
    with pytest.raises(FloatingPointError, match=f"^{ksp}: .* iteration 0 "):
        s.solve(b)
    utils.enable_nan_checks(False)
    assert int(s.solve(b).reason) == int(ConvergedReason.DIVERGED_NAN)


def test_nan_mid_solve_names_the_iteration(nan_flags):
    """A preconditioner that turns to NaN on its third application: the
    checks raise at the iteration where the unchecked solve stops."""
    grid = Grid3D((8,) * 3, device="cpu")
    A = make_laplacian_operator(grid, impl="roll")
    b = torch.as_tensor(np.nan_to_num(nan_rhs()))
    b = b - b.mean()

    def run():
        calls = [0]

        def M(r):
            calls[0] += 1
            return r * float("nan") if calls[0] == 3 else r
        return cg(A, b, M=M, rtol=1e-12, max_it=50)

    res = run()
    k = int(res.iterations)
    assert k > 0 and int(res.reason) == int(ConvergedReason.DIVERGED_NAN)
    utils.enable_nan_checks()
    with pytest.raises(FloatingPointError, match=f"^cg: .* iteration {k} "):
        run()


@pytest.mark.parametrize("ksp", ["cg", "pipecg", "richardson", "gmres"])
def test_nan_checks_add_no_read(nan_flags, monkeypatch, ksp):
    """The checks ride on the one value a loop reads each step: a solve
    takes as many host reads (.item()) with them on as off."""
    b = torch.as_tensor(np.nan_to_num(nan_rhs()))
    s = PoissonSolver((8,) * 3, options=Options(["-ksp_type", ksp, "-pc_type", "mg",
                                                 "-ksp_rtol", "1e-8"]),
                      dtype=torch.float64, device="cpu")
    s.solve(b)
    reads = [0]
    item = torch.Tensor.item

    def counted(self):
        reads[0] += 1
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", counted)
    counts = []
    for on in (False, True):
        utils.enable_nan_checks(on)
        reads[0] = 0
        res = s.solve(b)
        counts.append((reads[0], int(res.iterations)))
    assert counts[0] == counts[1] and counts[0][0] > 0
