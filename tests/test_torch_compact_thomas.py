"""K17 and the method="pallas" compact stack against the JAX package, in
float64 on the CPU.

  * the fused entries (solve_compact, compact_dual, compact_chain,
    compact_sum: CudaTridiagFactor's plain versions of K17) against the
    Pallas kernels of the same names in interpret mode, to 1e-12 relative;
  * compact.lapl, grad, div, interp and interp_div with method="pallas"
    against the JAX package's method="pallas" at 32^3, where every sweep of
    its layout-cycled pipeline takes the fused kernels (f.size // n >=
    1024), to 1e-12 (lapl 1e-11, the JAX package's own tolerance for it);
  * the order-6 operator with method="pallas" solved by CG + GMG against
    the JAX package's PoissonSolver(order=6): equal iterations, x to 1e-8
    of max|x|;
  * the "pallas" path never reaches K15 (compact_pcr's sweeps), and CPU
    tensors launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.api import PoissonSolver as JPoissonSolver
from poissbox_tpu.config import Options as JOptions
from poissbox_tpu.ops import compact as jcompact
from poissbox_tpu.ops import tridiag_pallas as jtp
from poissbox_tpu_torch.config import SolverOptions
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import compact, compact_pcr, stencil_cuda, tridiag_cuda
from poissbox_tpu_torch.ops.coefficients import compact_grad_coeffs, compact_interp_coeffs
from poissbox_tpu_torch.solvers import ksp

TOL = 1e-12
LAPL_TOL = 1e-11
DX = 0.3


def field(shape, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape)


def rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


# the operators of the compact Laplacian, as (coefficients, stagger)
OPS = {"i-": (compact_interp_coeffs(), -1), "i+": (compact_interp_coeffs(), +1),
       "g-": (compact_grad_coeffs(DX), -1), "g+": (compact_grad_coeffs(DX), +1)}


def _both(name, n):
    """(port factor, port spec, JAX factor, JAX spec) of one operator."""
    alpha, spec = compact._op(*OPS[name])
    jalpha, jspec = jcompact._op(*OPS[name])
    assert (alpha, spec) == (jalpha, jspec)
    return (compact._pfac(n, alpha, torch.float64), spec,
            jcompact._pfac(n, jalpha, jnp.float64), jspec)


SHAPE = (16, 8, 16)


@pytest.mark.parametrize("mode,ops", [("compact", ("g-",)), ("compact", ("i+",)),
                                      ("dual", ("i-", "g-")), ("chain", ("g-", "g+")),
                                      ("chain", ("i-", "i+")), ("sum", ("i+", "g+"))],
                         ids=["compact-g-", "compact-i+", "dual", "chain-g",
                              "chain-i", "sum"])
def test_fused_entries_match_pallas(mode, ops):
    n = SHAPE[0]
    fs = [field(SHAPE, k) for k in range(3)]
    pt, jx = [torch.as_tensor(f) for f in fs], [jnp.asarray(f) for f in fs]
    if mode == "compact":
        fac, spec, jfac, jspec = _both(ops[0], n)
        got = fac.solve_compact(pt[0], *spec)
        ref = jfac.solve_compact(jx[0], *jspec)
    else:
        (f1, s1, j1, js1), (f2, s2, j2, js2) = (_both(o, n) for o in ops)
        if mode == "sum":
            got = tridiag_cuda.compact_sum(*pt, f1, s1, f2, s2)
            ref = jtp.compact_sum(*jx, j1, js1, j2, js2)
        else:
            got = getattr(tridiag_cuda, f"compact_{mode}")(pt[0], f1, s1, f2, s2)
            ref = getattr(jtp, f"compact_{mode}")(jx[0], j1, js1, j2, js2)
    for g, r in zip(got if mode == "dual" else (got,), ref if mode == "dual" else (ref,)):
        rel_close(g.numpy(), r)


def test_fused_entries_reject_bad_layouts():
    fac, spec, _, _ = _both("g-", 16)
    f = torch.as_tensor(field(SHAPE, 3))
    with pytest.raises(ValueError, match="axis=0"):
        fac.solve_compact(f, *spec, axis=1)
    with pytest.raises(ValueError, match="axis=0"):
        fac.solve_compact(f[0], *spec)
    with pytest.raises(ValueError, match="rows"):
        tridiag_cuda.compact_dual(f[:8], fac, spec, fac, spec)
    with pytest.raises(ValueError, match="opsign"):
        fac.solve_compact(f, 1.0, 0.5, 0, 0)


CUBE = (32, 32, 32)


@pytest.fixture(scope="module")
def jax_pallas_cube():
    f, F = field(CUBE, 4), field(CUBE + (3,), 5)
    d = tuple(1.0 / n for n in CUBE)
    jf, jF = jnp.asarray(f), jnp.asarray(F)
    ref = {"lapl": jcompact.lapl(jf, d, method="pallas"),
           "grad": jcompact.grad(jf, d, method="pallas"),
           "div": jcompact.div(jF, d, method="pallas"),
           "interp": jcompact.interp(jf, method="pallas"),
           "interp_div": jcompact.interp_div(jf, method="pallas")}
    return f, F, d, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("op", ["lapl", "grad", "div", "interp", "interp_div"])
def test_pallas_ops_match_jax_pallas(jax_pallas_cube, op):
    f, F, d, ref = jax_pallas_cube
    if op == "div":
        got = compact.div(torch.as_tensor(F), d, method="pallas")
    elif op.startswith("interp"):
        got = getattr(compact, op)(torch.as_tensor(f), method="pallas")
    else:
        got = getattr(compact, op)(torch.as_tensor(f), d, method="pallas")
    rel_close(got.numpy(), ref[op], LAPL_TOL if op == "lapl" else TOL)


@pytest.mark.parametrize("fn", ["grad_1d", "div_1d", "interp_1d", "interp_1d_div"])
def test_pallas_1d_ops_on_lower_rank_fields(fn):
    """1-D and 2-D fields: the RHS built with rolls, then the operator's
    CudaTridiagFactor solve (K14's plain version; the JAX package, below
    its batch gate, takes pscan here)."""
    args = (DX,) if fn in ("grad_1d", "div_1d") else ()
    for shape, axis in (((24,), 0), ((20, 12), 0), ((20, 12), 1)):
        f = field(shape, 6)
        got = getattr(compact, fn)(torch.as_tensor(f), *args, axis=axis, method="pallas")
        ref = jax.jit(lambda v: getattr(jcompact, fn)(v, *args, axis=axis,
                                                      method="pallas"))(jnp.asarray(f))
        rel_close(got.numpy(), ref, 1e-11)


def test_pallas_path_never_reaches_k15(monkeypatch):
    """method="pallas" runs the Thomas pipeline (K17): with K15's sweeps
    made to raise, every 3-D operator still runs; "auto" does not."""
    f = torch.as_tensor(field((12, 10, 16), 7))
    F = torch.as_tensor(field((12, 10, 16, 3), 8))
    d = (0.1, 0.2, 0.3)
    ref = {m: compact.lapl(f, d, method=m) for m in ("pallas", "pscan")}

    def k15(*args, **kw):
        raise AssertionError("K15 reached")

    monkeypatch.setattr(compact_pcr, "sweep", k15)
    monkeypatch.setattr(compact_pcr, "sweep_plain", k15)
    got = compact.lapl(f, d, method="pallas")
    compact.grad(f, d, method="pallas")
    compact.div(F, d, method="pallas")
    compact.interp(f, method="pallas")
    rel_close(got.numpy(), ref["pallas"].numpy(), 0.0)
    rel_close(got.numpy(), ref["pscan"].numpy(), LAPL_TOL)
    with pytest.raises(AssertionError, match="K15 reached"):
        compact.lapl(f, d, method="auto")


def test_cpu_tensors_launch_nothing():
    f = torch.as_tensor(field((8, 12, 16), 9))
    F = torch.as_tensor(field((8, 12, 16, 3), 10))
    d = (0.125, 0.1, 0.2)
    fac, spec, _, _ = _both("g-", 8)
    stencil_cuda.reset_launches()
    compact.lapl(f, d, method="pallas")
    compact.div(F, d, method="pallas")
    fac.solve_compact(f, *spec)
    tridiag_cuda.compact_sum(f, f, f, fac, spec, fac, spec)
    assert not any(stencil_cuda.LAUNCHES.values())


def test_pallas_cg_gmg_matches_jax_order6():
    """The compact operator with method="pallas" solved by CG + GMG, on
    the CPU, against the JAX package's PoissonSolver(order=6) on the same
    b (the smooth field of its compact Krylov test)."""
    n, rtol = 16, 1e-8
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
            "-ksp_max_it", "80"]
    js = JPoissonSolver((n,) * 3, options=JOptions(argv), dtype=jnp.float64, order=6)
    x, y, z = (np.asarray(v) for v in js.grid.coords())
    k = 2 * np.pi
    u = np.sin(k * x) * np.cos(2 * k * y) + np.sin(3 * k * z) + np.cos(k * (x + z))
    b = np.array(js.rhs_for(jnp.asarray(u - u.mean())))
    ref = js.solve(jnp.asarray(b))
    grid = Grid3D((n,) * 3, device="cpu")
    A = compact.make_compact_laplacian_operator(grid, method="pallas")
    solver = ksp.make_solver(A, SolverOptions(ksp_type="cg", pc_type="mg", ksp_rtol=rtol,
                                              ksp_max_it=80),
                             dtype=torch.float64, grid=grid)
    bt = torch.as_tensor(b)
    res = solver(bt)
    assert int(res.iterations) == int(ref.iterations) and bool(res.converged)
    rel = float(torch.linalg.vector_norm(A(res.x) - bt) / torch.linalg.vector_norm(bt))
    assert rel <= rtol * 1.01
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(ref.x)).max())


# K17's strip kernel, mirrored on the CPU: (opsign, shift) of op1 and op2,
# every opsign and shift, the two shifts of a pair equal and not
STRIP_PAIRS = [((1, 0), (-1, 0)), ((-1, 1), (1, 1)), ((1, 1), (-1, 0)), ((-1, 0), (1, 1))]
STRIP_Q = 37   # ragged for every block width (32 and 16 lines)


def _strip_case(n, dtype, seed):
    """Fields (n, STRIP_Q) and two operators' factors on them: a periodic
    (alpha, 1, alpha) system and a non-periodic general one (no correction)."""
    g = np.random.default_rng(seed)
    fs = [torch.as_tensor(g.uniform(-1.0, 1.0, (n, STRIP_Q)), dtype=dtype) for _ in range(3)]
    per = compact._pfac(n, 0.3, dtype)
    a, c = g.uniform(-0.3, 0.3, n), g.uniform(-0.3, 0.3, n)
    gen = tridiag_cuda.CudaTridiagFactor(
        *(torch.as_tensor(v, dtype=dtype) for v in (a, g.uniform(1.0, 2.0, n), c)),
        periodic=False, algorithm="thomas")
    return fs, [fac._on("cpu", "thomas") for fac in (per, gen)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [8, 33, 64, 96])
@pytest.mark.parametrize("mode", ["compact", "dual", "chain", "sum"])
def test_strip_mirror_matches_plain(mode, n, dtype):
    """The strip kernel's algorithm (compact_strip_mirror: chunked loads,
    the tap window, rows 0 and 1 held for the wrapped taps, dmod written
    over its input row, chain's op2 reading op1's line from the strip,
    dual's second load of f, sum's fb and op2 in a second column) at 32
    and 16 lanes, bit for bit equal to the plain version, for every opsign
    and shift and a ragged last block; n = 33 and 96 end in a partial
    chunk."""
    fs, (per, gen) = _strip_case(n, dtype, n)
    a, b = 0.7, 0.15
    for (s1, sh1), (s2, sh2) in STRIP_PAIRS:
        specs = [(a, b, s1, sh1), (-b, 1.3 * a, s2, sh2)]
        for facs in ([per, per], [per, gen], [gen, per]):
            if mode == "compact":
                facs, specs_m = facs[:1], specs[:1]
            else:
                specs_m = specs
            ins = fs if mode == "sum" else fs[:1]
            ref = tridiag_cuda.compact_thomas_plain(mode, ins, facs, specs_m)
            for lanes in (32, 16):
                got = tridiag_cuda.compact_strip_mirror(mode, ins, facs, specs_m, lanes=lanes)
                for g_, r_ in zip(got if mode == "dual" else (got,),
                                  ref if mode == "dual" else (ref,)):
                    assert g_.dtype == r_.dtype and torch.equal(g_, r_), (lanes, specs_m)


def test_strip_mirror_catches_a_short_wait(monkeypatch):
    """The mirror shows the fault it is there for: a sweep that waits for
    one group fewer (group c, not c and c+1) reads rows that have not
    landed, and the result differs from the plain version."""
    fs, (per, _) = _strip_case(64, torch.float64, 3)
    spec = (0.7, 0.15, -1, 1)
    ref = tridiag_cuda.compact_thomas_plain("compact", fs[:1], [per], [spec])
    assert torch.equal(tridiag_cuda.compact_strip_mirror("compact", fs[:1], [per], [spec]), ref)
    wait = tridiag_cuda._Feed.wait
    monkeypatch.setattr(tridiag_cuda._Feed, "wait", lambda self, k: wait(self, k and k + 1))
    got = tridiag_cuda.compact_strip_mirror("compact", fs[:1], [per], [spec])
    assert not torch.equal(got, ref)
