"""The port's 6th-order compact stack (K15's plain versions, the PCR
schedule, the pscan path) against the JAX package, in float64.

The plain PCR operators are held to two references: the JAX Pallas
kernels in interpret mode (ops.compact_pcr) at 16^3 and (16, 8, 32), and
the JAX package's Thomas path (ops.compact, method="pscan") at (12, 20,
24), which the TPU kernels never take. Tolerances are the JAX package's
own (tests/test_compact_pcr.py): relative to max|ref|, interp 1e-12,
grad/div 1e-11, lapl 1e-10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.ops import compact as jcompact
from poissbox_tpu.ops import compact_pcr as jpcr
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import compact, compact_pcr, stencil_cuda

TOL = {"interp": 1e-12, "grad": 1e-11, "div": 1e-11, "lapl": 1e-10,
       "op_1d": 1e-11}
EPS32, EPS64 = float(np.finfo(np.float32).eps), float(np.finfo(np.float64).eps)


def field(shape, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape)


def rel_close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rtol", [0.0, EPS32 / 4, EPS64 / 4],
                         ids=["exact", "eps32", "eps64"])
@pytest.mark.parametrize("n", [8, 48, 64, 128, 640])
@pytest.mark.parametrize("alpha", [9.0 / 62.0, 3.0 / 10.0], ids=["grad", "interp"])
def test_pcr_schedule_matches_jax(alpha, n, rtol):
    """Bit for bit where the JAX package returns a schedule; a ValueError
    where it raises (an exact schedule at non-power-of-two n)."""
    try:
        ref = jpcr.pcr_schedule(alpha, n, rtol)
    except ValueError:
        with pytest.raises(ValueError):
            compact_pcr.pcr_schedule(alpha, n, rtol)
        return
    assert compact_pcr.pcr_schedule(alpha, n, rtol) == ref


@pytest.mark.parametrize("n", [48, 64])
def test_pcr_schedule_raises_without_truncation(n):
    """A truncating schedule that never truncates (alpha = 1/2, not
    diagonally dominant) would close on the (i, i+n/2) pairing at the
    wrong stride: the port raises (the JAX package returns it; no test
    encodes that)."""
    with pytest.raises(ValueError, match="did not truncate"):
        compact_pcr.pcr_schedule(0.5, n, EPS32 / 4)


# ---------------------------------------------------------------------------
# plain PCR operators against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

PALLAS_SHAPES = [(16, 16, 16), (16, 8, 32)]


def _deltas(shape):
    return tuple(1.0 / n for n in shape)


@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=["16^3", "16x8x32"])
@pytest.mark.parametrize("op", ["lapl", "grad", "interp", "interp_div"])
def test_pcr_ops_match_pallas(shape, op):
    f = field(shape, 1)
    d = _deltas(shape)
    if op == "lapl":
        got, ref = compact_pcr.lapl(torch.as_tensor(f), d), jpcr.lapl(jnp.asarray(f), d)
    elif op == "grad":
        got, ref = compact_pcr.grad(torch.as_tensor(f), d), jpcr.grad(jnp.asarray(f), d)
    else:
        st = -1 if op == "interp" else +1
        got = compact_pcr.interp(torch.as_tensor(f), stagger=st)
        ref = jpcr.interp(jnp.asarray(f), stagger=st)
    rel_close(got.numpy(), ref, TOL[op.split("_")[0]])


@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=["16^3", "16x8x32"])
def test_pcr_div_matches_pallas(shape):
    F = field(shape + (3,), 2)
    d = _deltas(shape)
    rel_close(compact_pcr.div(torch.as_tensor(F), d).numpy(),
              jpcr.div(jnp.asarray(F), d), TOL["div"])


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("kind", ["grad-", "grad+", "interp-", "interp+"])
def test_pcr_op_1d_matches_pallas(kind, axis):
    shape = (16, 8, 32)
    f = field(shape, 3)
    n = shape[axis]
    st = -1 if kind.endswith("-") else +1
    rt32 = EPS32 / 4       # the kernels' f32 truncation; exact in f64 terms
    if kind.startswith("grad"):
        spec, jspec = (m.grad_spec(0.25, st, n, rt32) for m in (compact_pcr, jpcr))
    else:
        spec, jspec = (m.interp_spec(st, n, rt32) for m in (compact_pcr, jpcr))
    assert spec == jspec
    got = compact_pcr.op_1d(torch.as_tensor(f), spec, axis)
    rel_close(got.numpy(), jpcr.op_1d(jnp.asarray(f), jspec, axis), TOL["op_1d"])


# ---------------------------------------------------------------------------
# against the JAX Thomas path (method="pscan") at unaligned extents
# ---------------------------------------------------------------------------

ODD = (12, 20, 24)


@pytest.fixture(scope="module")
def jax_pscan_odd():
    f = field(ODD, 4)
    F = field(ODD + (3,), 5)
    d = _deltas(ODD)
    jf, jF = jnp.asarray(f), jnp.asarray(F)
    ref = {
        "lapl": jax.jit(lambda v: jcompact.lapl(v, d, method="pscan"))(jf),
        "grad": jax.jit(lambda v: jcompact.grad(v, d, method="pscan"))(jf),
        "div": jax.jit(lambda v: jcompact.div(v, d, method="pscan"))(jF),
        "interp": jax.jit(lambda v: jcompact.interp(v, method="pscan"))(jf),
    }
    return f, F, d, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("method", ["auto", "pcr", "cuda", "pscan", "seq"])
@pytest.mark.parametrize("op", ["lapl", "grad", "div", "interp"])
def test_compact_ops_match_jax_pscan(jax_pscan_odd, op, method):
    """Every method of the port's compact.* (the PCR path's plain versions,
    and the port's own Thomas path) against the JAX package's pscan."""
    f, F, d, ref = jax_pscan_odd
    if op == "div":
        got = compact.div(torch.as_tensor(F), d, method=method)
    elif op == "interp":
        got = compact.interp(torch.as_tensor(f), method=method)
    else:
        got = getattr(compact, op)(torch.as_tensor(f), d, method=method)
    rel_close(got.numpy(), ref[op], TOL[op])


@functools.lru_cache(maxsize=None)
def _jax_1d(fn, shape, axis):
    """The JAX package's pscan result, shared by the port's methods."""
    args = (0.3,) if fn in ("grad_1d", "div_1d") else ()
    return np.asarray(getattr(jcompact, fn)(jnp.asarray(field(shape, 6)), *args,
                                            axis=axis, method="pscan"))


@pytest.mark.parametrize("method", ["auto", "pscan"])
@pytest.mark.parametrize("fn", ["grad_1d", "div_1d", "interp_1d", "interp_1d_div"])
def test_1d_ops_on_lower_rank_fields(fn, method):
    """The 1-D operators on 1-D and 2-D fields, any axis."""
    for shape, axis in (((24,), 0), ((20, 12), 0), ((20, 12), 1)):
        f = field(shape, 6)
        args = (0.3,) if fn in ("grad_1d", "div_1d") else ()
        got = getattr(compact, fn)(torch.as_tensor(f), *args, axis=axis,
                                   method=method)
        rel_close(got.numpy(), _jax_1d(fn, shape, axis), 1e-11)


def test_compact_rhs_matches_jax():
    f = field((6, 8, 10), 7)
    for stagger in (-1, 1):
        for opsign in (-1, 1):
            got = compact.compact_rhs(torch.as_tensor(f), 0.7, 0.2, opsign,
                                      stagger, axis=1)
            ref = jcompact.compact_rhs(jnp.asarray(f), 0.7, 0.2, opsign,
                                       stagger, axis=1)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-15)
    with pytest.raises(ValueError):
        compact.compact_rhs(torch.as_tensor(f), 1.0, 1.0, 1, 0)


# ---------------------------------------------------------------------------
# the kernel's programs and wrapper, on the CPU
# ---------------------------------------------------------------------------

def test_sweep_on_cpu_runs_plain_and_launches_nothing():
    f = torch.as_tensor(field((8, 12, 16), 8))
    d = _deltas(f.shape)
    stencil_cuda.reset_launches()
    got = compact_pcr.lapl(f, d)
    assert not any(stencil_cuda.LAUNCHES.values())
    # the regrouped three-sweep form equals div(grad) to rounding
    ref = compact_pcr.div(compact_pcr.grad(f, d), d)
    rel_close(got.numpy(), ref.numpy(), 1e-10)


def test_program_encoding():
    """The flat layout csrc/compact.cu parses: nin, nout, per output
    nterms, per term input and nops, per operator taps, a, b, opsign,
    shift, nsteps, the factors, pair, c1, c2."""
    sched = compact_pcr.pcr_schedule(0.3, 16, EPS32 / 4)
    spec = (0.75, 0.05, 1, 0, sched)
    fs, bF, _ = sched
    code = compact_pcr._encode((((0, (spec,)), (1, (spec, spec))),), 2)
    head = [2, 1, 2, 0, 1, 1, 0.75, 0.05, 1, 0, len(fs), *fs, 0, 1.0 / bF, 0.0]
    assert code[:len(head)] == head
    assert len(code) == 3 + 2 * 2 + 3 * (9 + len(fs))
    exact = compact_pcr.pcr_schedule(0.3, 16)
    code = compact_pcr._encode((((0, (compact_pcr.solve_spec(0.5, exact),)),),), 1)
    fs, bF, aF = exact
    inv = 1.0 / (bF * bF - 4.0 * aF * aF)
    assert code[5:7] == [0, 0.5] and code[-3:] == [1, bF * inv, 2.0 * aF * inv]


def test_tile_width_limits():
    """Two blocks to an SM where the tiles allow it, else one; lines of
    up to 1024 points fit in float32 and in float64."""
    assert compact_pcr.tile_width(256, torch.float32, 3) == 32
    assert compact_pcr.tile_width(512, torch.float32, 2) == 16
    assert compact_pcr.tile_width(512, torch.float32, 3) == 16
    assert compact_pcr.tile_width(512, torch.float64, 3) == 8
    assert compact_pcr.tile_width(1024, torch.float32, 3) == 8
    assert compact_pcr.tile_width(1024, torch.float64, 3) == 8
    with pytest.raises(ValueError, match="shared memory"):
        compact_pcr.tile_width(4096, torch.float64, 2)


def test_compact_operator_and_unknown_method():
    g = Grid3D((8, 8, 8), device="cpu")
    f = torch.as_tensor(field((8, 8, 8), 9))
    A = compact.make_compact_laplacian_operator(g)
    P = compact.make_compact_laplacian_operator(g, method="pscan")
    rel_close(A(f).numpy(), P(f).numpy(), 1e-10)
    assert A.direct_solve is not None and A.symmetric
    with pytest.raises(ValueError):
        compact.lapl(f, g.deltas, method="thomas")


def test_grid_coords_match_jax():
    g, jg = Grid3D((4, 6, 8), (1.0, 2.0, 0.5), device="cpu"), JGrid3D((4, 6, 8), (1.0, 2.0, 0.5))
    for st in ((False,) * 3, (True, False, True)):
        for a, b in zip(g.coords(st, dtype=torch.float64), jg.coords(st)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
