"""The fused Chebyshev step (`stencil_cuda.chebyshev_first_cuda`,
`chebyshev_step_cuda`; KA's Chebyshev epilogues in `csrc/stencil7.cu`) on
the CPU, where the wrappers take their plain versions.

The plain versions are held bit for bit to the chain the smoother ran
before the step was one launch (K9's residual, then torch's elementwise
recurrence), for each kind of step, in float32, float64 and bfloat16, with
x aliasing d; the smoother's branch is held to that chain's smoothing and
cycle with K9 refusing; roll and distributed levels keep the chain; and a
solve calls the fused step once for every Chebyshev step but the closed-form
ones from zero. The kernel itself is held to the plain versions on the card
(`tests/test_torch_chebyshev_card.py`).
"""

import math

import numpy as np
import pytest
import torch

from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.ops import stencil_cuda
from poissbox_tpu_torch.parallel import dist_stencil
from poissbox_tpu_torch.solvers import mg
from poissbox_tpu_torch.utils import profiling

SHAPES = [(16, 16, 16), (24, 16, 40)]
CELLS = {"cubic": (1.0, 1.0, 1.0), "aniso": (1.0, 0.75, 1.5)}
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
KINDS = ["first", "middle", "last", "middle-alias", "last-alias"]
CHEB = ["-ksp_type", "cg", "-pc_type", "mg", "-mg_levels_ksp_type", "chebyshev",
        "-mg_levels_pc_type", "jacobi"]


def deltas(shape, cells):
    return tuple(c / n for c, n in zip(CELLS[cells], shape))


def field(shape, seed, dtype):
    return torch.as_tensor(np.random.default_rng(seed).uniform(-0.75, 1.25, shape)).to(dtype)


def coefficients(d):
    """(theta, c1, c2) of the smoother's first middle step on spacing d,
    computed as `mg._smooth_impl` computes them."""
    m = 4.0 * sum(1.0 / dd**2 for dd in d)
    theta, delta = 0.5 * (-m - 0.1 * m), 0.5 * (-0.1 * m + m)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    rho_new = 1.0 / (2.0 * sigma1 - rho)
    return theta, rho_new * rho, 2.0 * rho_new / delta


def bits(t):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype])


def same_bits(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(bits(got), bits(ref)), float((got.double() - ref.double()).abs().max())


def parent_chebyshev(x, b, lvl, cfg, sweeps, residual):
    """The smoother's Chebyshev branch as it ran before the fused step:
    `residual` (K9 on kernel levels), then torch's ops on each step."""
    m = 4.0 * sum(1.0 / dd**2 for dd in lvl.deltas)
    a_lo, b_hi = -m, -0.1 * m
    theta = 0.5 * (a_lo + b_hi)
    delta = 0.5 * (b_hi - a_lo)
    sigma1 = theta / delta
    if x is None:
        d = b / theta
        x = d
    else:
        r = residual(x, b, lvl, cfg)
        d = r / theta
        x = x + d
    rho = 1.0 / sigma1
    for _ in range(mg.chebyshev_degree(sweeps) - 1):
        r = residual(x, b, lvl, cfg)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    return x


def plain_residual(x, b, lvl, cfg):
    return stencil_cuda.residual_plain(x, b, lvl.deltas)


def refuse(*args, **kw):
    raise AssertionError("this path must not be taken")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cells", CELLS)
@pytest.mark.parametrize("shape", SHAPES, ids=["16^3", "24x16x40"])
def test_plain_step_is_the_parents_chain(shape, cells, dtype, kind):
    """Each kind of step bit for bit against K9's plain residual and the
    torch ops the smoother applied to it: the first step from x
    (d' = r / theta), a middle step (d' = c1 d + c2 r, d' kept) and the
    last (x' alone), the last two also with d the very tensor x."""
    dt, d = DTYPES[dtype], deltas(shape, cells)
    x, b = field(shape, 1, dt), field(shape, 2, dt)
    dd = x if kind.endswith("alias") else field(shape, 3, dt) * 1e-6
    theta, c1, c2 = coefficients(d)
    r = stencil_cuda.residual_plain(x, b, d)
    if kind == "first":
        ref_d = r / theta
        got = stencil_cuda.chebyshev_first_cuda(x, b, d, theta)
    else:
        ref_d = c1 * dd + c2 * r
        got = stencil_cuda.chebyshev_step_cuda(x, b, dd, d, c1, c2,
                                               store_d=kind.startswith("middle"))
    ref = (x + ref_d, ref_d) if kind in ("first", "middle", "middle-alias") else (x + ref_d,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, rf in zip(got, ref):
        same_bits(g, rf)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sweeps", [1, 2, 3], ids=["degree2", "degree4", "degree6"])
@pytest.mark.parametrize("start", ["zero", "given"])
def test_kernel_branch_is_the_parents_smoothing(monkeypatch, start, sweeps, dtype):
    """A one-device kernel level's Chebyshev smoothing with K9 refusing:
    every step but the closed-form one from zero goes through the fused
    step, and the smoothed iterate is the parent's chain's bit for bit, at
    degrees 2, 4 and 6 (middle steps from degree 4)."""
    dt = DTYPES[dtype]
    shape, d = (24, 16, 40), deltas((24, 16, 40), "aniso")
    lvl = mg._Level(shape, d, -2.0 * sum(1.0 / v**2 for v in d))
    cfg = mg.MGConfig(smoother="chebyshev", impl="cuda")
    x = None if start == "zero" else field(shape, 4, dt)
    b = field(shape, 5, dt)
    ref = parent_chebyshev(x, b, lvl, cfg, sweeps, plain_residual)
    monkeypatch.setattr(mg, "residual_cuda", refuse)
    same_bits(mg._smooth_impl(x, b, lvl, cfg, sweeps, reverse=False), ref)


@pytest.mark.parametrize("pre_dtype", ["", "bfloat16"], ids=["f32", "bf16-presmooth"])
@pytest.mark.parametrize("sweeps", [1, 2], ids=["V(1,1)", "V(2,2)"])
def test_kernel_cycle_is_the_parents_cycle(monkeypatch, sweeps, pre_dtype):
    """One M(r) on the card's call graph (impl cuda, the fused legs) at
    32^3 float32: with K9 refusing, it equals bit for bit the same cycle
    whose Chebyshev smoothings run the parent's chain (K9 and torch's ops,
    the fused step refusing), with and without the bf16 pre-smooth."""
    shape = (32, 32, 32)
    cfg = mg.MGConfig(smoother="chebyshev", impl="cuda", transfers="matmul",
                      pre_smooth=sweeps, post_smooth=sweeps, pre_dtype=pre_dtype)
    M = mg.make_mg_preconditioner(shape, deltas(shape, "cubic"), cfg, torch.float32, "cpu")
    r = field(shape, 6, torch.float32)
    r -= r.mean()
    with monkeypatch.context() as mp:
        mp.setattr(mg, "residual_cuda", refuse)
        got = M(r)
    smooth = mg._smooth_impl

    def parents(x, b, lvl, cfg, sweeps, reverse, dots=False):
        if cfg.smoother == "chebyshev":
            return parent_chebyshev(x, b, lvl, cfg, sweeps, mg._residual)
        return smooth(x, b, lvl, cfg, sweeps, reverse, dots)
    monkeypatch.setattr(mg, "_smooth_impl", parents)
    monkeypatch.setattr(mg, "chebyshev_first_cuda", refuse)
    monkeypatch.setattr(mg, "chebyshev_step_cuda", refuse)
    same_bits(got, M(r))


@pytest.mark.parametrize("start", ["zero", "given"])
def test_roll_and_distributed_levels_keep_the_chain(monkeypatch, start):
    """impl='roll' levels smooth by the roll residual and torch's ops, and
    a distributed level by the sharded residual (`residual_sharded`, one a
    step after the closed-form one), never by the fused step; both give
    the parent's chain bit for bit."""
    shape, d = (16, 16, 16), deltas((16, 16, 16), "cubic")
    monkeypatch.setattr(mg, "chebyshev_first_cuda", refuse)
    monkeypatch.setattr(mg, "chebyshev_step_cuda", refuse)
    x = None if start == "zero" else field(shape, 7, torch.float64)
    b = field(shape, 8, torch.float64)
    roll = mg.MGConfig(smoother="chebyshev", impl="roll")
    lvl = mg._Level(shape, d, -2.0 * sum(1.0 / v**2 for v in d))
    same_bits(mg._smooth_impl(x, b, lvl, roll, 2, reverse=True),
              parent_chebyshev(x, b, lvl, roll, 2, mg._residual))
    calls = []

    def sharded(x, b, grid, local_impl):
        calls.append(local_impl)
        return stencil_cuda.residual_plain(x, b, d)
    monkeypatch.setattr(dist_stencil, "residual_sharded", sharded)
    kern = mg.MGConfig(smoother="chebyshev", impl="cuda")
    dist = mg._Level(shape, d, lvl.diag, grid=object())
    got = mg._smooth_impl(x, b, dist, kern, 2, reverse=True)
    same_bits(got, parent_chebyshev(x, b, lvl, kern, 2, plain_residual))
    assert len(calls) == mg.chebyshev_degree(2) - (start == "zero")


@pytest.mark.parametrize("impl,fused", [("cuda", True), ("roll", False)])
def test_fused_steps_are_the_steps_after_the_zero_ones(monkeypatch, impl, fused):
    """A Chebyshev MG-CG solve at 32^3 float64, V(2,2) (degree 4: middle
    steps run): the fused step is called once for each counted step
    (`MGSmooth.cheb_steps`) less the closed-form first steps from zero,
    one for each pre-smoothing of each level and V-cycle; on the roll path
    never. On the card those calls are the `stencil7.cheb` launches."""
    calls = []

    def spy(fn):
        def wrapped(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped
    for name in ("chebyshev_first_cuda", "chebyshev_step_cuda"):
        monkeypatch.setattr(mg, name, spy(getattr(mg, name)))
    solver = PoissonSolver((32,) * 3, options=Options(
        CHEB + ["-ksp_rtol", "1e-8", "-mg_levels_ksp_max_it", "2", "-mg_impl", impl,
                "-mg_transfers", "matmul"]), dtype=torch.float64, device="cpu")
    u = field((32,) * 3, 9, torch.float64)
    b = solver.rhs_for(u - u.mean())
    profiling.reset()
    try:
        with profiling.recording():
            res = solver.solve(b)
        recs = profiling.spans()
        per = profiling.counts()[next(s["id"] for s in recs if s["parent"] is None)]
    finally:
        profiling.reset()
    M = solver._solver.M
    cycles = sum(1 for s in recs if s["name"] == "PCApply")
    zero = cycles * (len(M.levels) - 1)
    assert int(res.reason) > 0 and mg.chebyshev_degree(M.config.pre_smooth) == 4
    assert per["MGSmooth.cheb_steps"] == 2 * 4 * zero
    assert len(calls) == (per["MGSmooth.cheb_steps"] - zero if fused else 0)
    assert calls.count("chebyshev_first_cuda") == (zero if fused else 0)
    pts = sum(math.prod(lv.shape) for lv in M.levels[:-1])
    assert per["MGSmooth.cheb_points.zero.float64"] == cycles * pts


def test_the_step_takes_every_field_dtype():
    """stencil7.cheb takes float32, float64 and bfloat16 (the bf16
    pre-smooth), and refuses float16."""
    for dt in DTYPES.values():
        stencil_cuda.check_dtype("stencil7.cheb", dt)
    with pytest.raises(TypeError, match="stencil7.cheb"):
        stencil_cuda.check_dtype("stencil7.cheb", torch.float16)
