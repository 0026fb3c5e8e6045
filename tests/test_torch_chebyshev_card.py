"""The fused Chebyshev step (`stencil_cuda.chebyshev_first_cuda`,
`chebyshev_step_cuda`; KA's Chebyshev epilogues in `csrc/stencil7.cu`) on
the card.

Each kind of step (the first from a given x, a middle one, the last, the
last two also with d the very tensor x) is held bit for bit to its plain
version in float32, float64 and bfloat16, with cubic and anisotropic
cells, at 512^3, 256^3, the ragged (40, 36, 52), the odd (6, 5, 7) and the
small levels 8^3 and 4^3; a whole smoothing of degree 2 and 4 on a kernel
level is held bit for bit to the chain it replaces (K9, then torch's
elementwise ops); and a Chebyshev MG-CG solve launches the step once for
every Chebyshev step but the closed-form ones from zero, and K9 never.
Every test is marked ``card`` and skips without a CUDA card. This file
imports no JAX, so on the card it runs without the suite's conftest:

    python -m pytest tests/test_torch_chebyshev_card.py --noconftest -q
"""

import pytest
import torch

from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.ops import stencil_cuda
from poissbox_tpu_torch.solvers import mg
from poissbox_tpu_torch.utils import profiling

SHAPES = [(512, 512, 512), (256, 256, 256), (40, 36, 52), (6, 5, 7), (8, 8, 8), (4, 4, 4)]
SHAPE_IDS = ["512^3", "256^3", "40x36x52", "6x5x7", "8^3", "4^3"]
CELLS = {"cubic": (1.0, 1.0, 1.0), "aniso": (1.0, 0.75, 1.5)}
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
KINDS = ["first", "middle", "last", "middle-alias", "last-alias"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def deltas(shape, cells):
    return tuple(c / n for c, n in zip(CELLS[cells], shape))


def rand(shape, dtype, g):
    return (torch.rand(shape, generator=g, dtype=torch.float64, device="cuda") * 2
            - 0.75).to(dtype)


def coefficients(d):
    """(theta, c1, c2) of the smoother's first middle step on spacing d,
    as `mg._smooth_impl` computes them."""
    m = 4.0 * sum(1.0 / dd**2 for dd in d)
    theta, delta = 0.5 * (-m - 0.1 * m), 0.5 * (-0.1 * m + m)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    rho_new = 1.0 / (2.0 * sigma1 - rho)
    return theta, rho_new * rho, 2.0 * rho_new / delta


def key(dtype):
    return "stencil7.cheb" + (".bf16" if dtype == torch.bfloat16 else "")


def assert_equal(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), float((got.double() - ref.double()).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cells", CELLS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_step_kernel_equals_plain(shape, cells, dtype, kind):
    """One launch a step, bit for bit with the plain version; no input is
    written."""
    _need_card()
    dt, d = DTYPES[dtype], deltas(shape, cells)
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x, b = rand(shape, dt, g), rand(shape, dt, g)
    dd = x if kind.endswith("alias") else rand(shape, dt, g) * 1e-6
    x0, dd0 = x.clone(), dd.clone()
    theta, c1, c2 = coefficients(d)
    before = stencil_cuda.LAUNCHES[key(dt)]
    if kind == "first":
        got = stencil_cuda.chebyshev_first_cuda(x, b, d, theta)
        ref = stencil_cuda.chebyshev_first_plain(x, b, d, theta)
    else:
        store = kind.startswith("middle")
        got = stencil_cuda.chebyshev_step_cuda(x, b, dd, d, c1, c2, store_d=store)
        ref = stencil_cuda.chebyshev_step_plain(x, b, dd, d, c1, c2, store_d=store)
    torch.cuda.synchronize()
    assert stencil_cuda.LAUNCHES[key(dt)] == before + 1
    got, ref = (got, ref) if isinstance(ref, tuple) else ((got,), (ref,))
    assert len(got) == len(ref) == (1 if kind.startswith("last") else 2)
    for gt, rf in zip(got, ref):
        assert_equal(gt, rf)
    assert torch.equal(x, x0) and torch.equal(dd, dd0)


def parent_chebyshev(x, b, lvl, sweeps):
    """The kernel level's Chebyshev smoothing as it ran before the fused
    step: K9, then torch's elementwise ops."""
    m = 4.0 * sum(1.0 / dd**2 for dd in lvl.deltas)
    a_lo, b_hi = -m, -0.1 * m
    theta = 0.5 * (a_lo + b_hi)
    delta = 0.5 * (b_hi - a_lo)
    sigma1 = theta / delta
    if x is None:
        d = b / theta
        x = d
    else:
        r = stencil_cuda.residual_cuda(x, b, lvl.deltas)
        d = r / theta
        x = x + d
    rho = 1.0 / sigma1
    for _ in range(mg.chebyshev_degree(sweeps) - 1):
        r = stencil_cuda.residual_cuda(x, b, lvl.deltas)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    return x


@pytest.mark.card
@pytest.mark.parametrize("start", ["zero", "given"])
@pytest.mark.parametrize("sweeps", [1, 2], ids=["degree2", "degree4"])
@pytest.mark.parametrize("n,dtype", [(512, "f32"), (512, "bf16"), (64, "f64"), (40, "f32")],
                         ids=["512^3-f32", "512^3-bf16", "64^3-f64", "40^3-f32"])
def test_smoothing_equals_the_parents_chain(n, dtype, sweeps, start):
    """A whole Chebyshev smoothing of a one-device kernel level, degree 2
    (the cell's) and 4 (middle steps), from zero (the pre-smooth) and from
    a given x (the post-smooth), bit for bit against K9 and torch's ops;
    one launch a step after the closed-form one, and no K9."""
    _need_card()
    dt = DTYPES[dtype]
    shape = (n,) * 3
    d = (1.0 / n,) * 3
    lvl = mg._Level(shape, d, -2.0 * sum(1.0 / v**2 for v in d))
    cfg = mg.MGConfig(smoother="chebyshev", impl="cuda")
    g = torch.Generator(device="cuda").manual_seed(n + sweeps)
    b = rand(shape, dt, g)
    x = None if start == "zero" else rand(shape, dt, g)
    ref = parent_chebyshev(x, b, lvl, sweeps)
    stencil_cuda.reset_launches()
    got = mg._smooth_impl(x, b, lvl, cfg, sweeps, reverse=False)
    torch.cuda.synchronize()
    steps = mg.chebyshev_degree(sweeps) - (start == "zero")
    assert dict(stencil_cuda.LAUNCHES) == {key(dt): steps}
    assert_equal(got, ref)


@pytest.mark.card
@pytest.mark.parametrize("n,extra", [(512, []), (64, ["-mg_levels_ksp_max_it", "2"])],
                         ids=["512^3-f32-bf16pre", "64^3-f64-degree4"])
def test_solve_launches_one_step_kernel_a_step(n, extra):
    """Chebyshev MG-CG on the card: `stencil7.cheb` (and `.bf16`, the
    512^3 pre-smooth) launched once for every counted Chebyshev step less
    the closed-form ones from zero, one for each pre-smoothing of each
    level and V-cycle; K9 never; converged to the true residual."""
    _need_card()
    dtype = torch.float32 if n == 512 else torch.float64
    rtol = 1e-6 if n == 512 else 1e-8
    solver = PoissonSolver((n,) * 3, options=Options(
        ["-ksp_type", "cg", "-pc_type", "mg", "-mg_levels_ksp_type", "chebyshev",
         "-mg_levels_pc_type", "jacobi", "-ksp_rtol", repr(rtol), *extra]),
        dtype=dtype, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(n)
    u = rand((n,) * 3, torch.float64, g)
    b = solver.rhs_for((u - u.mean()).to(dtype))
    solver.solve(b)
    stencil_cuda.reset_launches()
    profiling.reset()
    try:
        with profiling.recording():
            res = solver.solve(b)
        torch.cuda.synchronize()
        recs = profiling.spans()
        per = profiling.counts()[next(s["id"] for s in recs if s["parent"] is None)]
    finally:
        profiling.reset()
    M = solver._solver.M
    cycles = sum(1 for s in recs if s["name"] == "PCApply")
    zero = cycles * (len(M.levels) - 1)
    launches = stencil_cuda.LAUNCHES
    assert launches["stencil7.cheb"] + launches["stencil7.cheb.bf16"] == \
        per["MGSmooth.cheb_steps"] - zero
    assert (launches["stencil7.cheb.bf16"] > 0) == (n == 512)
    assert launches["stencil7.residual"] == launches["stencil7.residual.bf16"] == 0
    assert int(res.reason) > 0
    assert solver.residual_norm(res.x, b) <= 1.01 * rtol
