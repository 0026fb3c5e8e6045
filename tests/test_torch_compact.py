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


# ---------------------------------------------------------------------------
# the register kernel's line layout, mirrored on the CPU
# ---------------------------------------------------------------------------
#
# The register kernel holds a line of n = 32 m points as 32 lanes of m
# registers and reads every shifted point by compact_pcr.reg_source. The
# mirror below runs the kernel's operations on lines reshaped to (32, m),
# each shift a gather by that rule, and must equal the plain version bit for
# bit: only the index algebra differs.

REG_EXTENTS = (64, 96, 128)


def _lanes_shift(v, s, m):
    """Point l*m + j + s for every lane l and register j of lines (..., 32, m)."""
    out = torch.empty_like(v)
    for j in range(m):
        q, r = compact_pcr.reg_source(j, s, m)
        out[..., :, j] = torch.roll(v[..., :, r], -q, dims=-1)   # from lane l + q
    return out


def _mirror_op(d, spec, m):
    a, b, opsign, shift, (fs, bF, aF) = spec
    if b is None:
        d = d * a
    else:
        s = float(opsign)
        at = lambda k: _lanes_shift(d, k, m)
        d = a * (at(shift) + s * at(shift - 1)) + b * (at(shift + 1) + s * at(shift - 2))
    k = 1
    for f in fs:
        d = d - f * (_lanes_shift(d, -k, m) + _lanes_shift(d, k, m))
        k *= 2
    if aF == 0.0:
        return d * (1.0 / bF)
    inv = 1.0 / (bF * bF - 4.0 * aF * aF)
    return (bF * inv) * d - (2.0 * aF * inv) * _lanes_shift(d, 16 * m, m)


def _mirror_sweep(program, inputs, axis, used):
    """compact_pcr.sweep as the register kernel computes it where the line
    length takes that kernel; the plain version elsewhere (the tile
    kernel's lines). `used` counts the register sweeps."""
    axis %= inputs[0].dim()
    n = inputs[0].shape[axis]
    if compact_pcr.route(n) != "registers":
        return compact_pcr.sweep_plain(program, inputs, axis)
    used.append(n)
    m = n // 32
    lines = [t.movedim(axis, -1) for t in inputs]
    outs = []
    for out in program:
        acc = None
        for idx, specs in out:
            d = lines[idx].reshape(*lines[idx].shape[:-1], 32, m)
            for spec in specs:
                d = _mirror_op(d, spec, m)
            acc = d if acc is None else acc + d
        outs.append(acc.reshape(lines[0].shape).movedim(-1, axis).contiguous())
    return outs


@pytest.mark.parametrize("n", [4, 6, 20, 24, 33, 40, 48, 63, 64, 96, 128, 160, 256,
                               384, 512, 640, 672, 1024])
def test_register_route_by_extent(n):
    """n = 32 m with m in REG_M takes the register kernel, every other
    extent the tile kernel (whose width rule still holds)."""
    reg = n in (64, 96, 128, 256, 384, 512, 640)
    assert compact_pcr.route(n) == ("registers" if reg else "tile")
    if not reg and n <= 1024:
        assert compact_pcr.tile_width(n, torch.float64, 3) in compact_pcr.WIDTHS


@pytest.mark.parametrize("m", compact_pcr.REG_M)
def test_reg_source_is_the_periodic_shift(m):
    """Every shift the kernel takes (taps, PCR strides, the n/2 pairing,
    negative and past n) lands on point (l*m + j + s) mod n."""
    n = 32 * m
    for s in (-2, -1, 0, 1, 2, 4, 8, 16, -16, 64, 2048, n // 2, n, n + 3, -n - 1):
        for j in range(m):
            q, r = compact_pcr.reg_source(j, s, m)
            assert 0 <= q < 32 and 0 <= r < m
            for lane in (0, 1, 17, 31):
                assert ((lane + q) % 32) * m + r == (lane * m + j + s) % n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", REG_EXTENTS)
@pytest.mark.parametrize("prog", ["lapl", "grad", "div", "interp-", "interp+", "op_1d"])
def test_register_mirror_matches_plain(monkeypatch, prog, n, dtype):
    """Each public program with its register-kernel lines run by the
    mirror, bit-equal to the plain version, the line of n points along each
    axis in turn (the other extents take the tile kernel's path)."""
    used = []
    monkeypatch.setattr(compact_pcr, "sweep",
                        lambda program, inputs, axis, **kw: _mirror_sweep(
                            program, inputs, axis, used))
    for axis in range(3):
        shape = [8, 12, 6]
        shape[axis] = n
        shape = tuple(shape)
        d = tuple(1.0 / s for s in shape)
        f = torch.as_tensor(field(shape, n + axis), dtype=dtype)
        if prog == "div":
            F = torch.as_tensor(field(shape + (3,), n + axis + 1), dtype=dtype)
            got, ref = compact_pcr.div(F, d), compact_pcr.div(F, d, plain=True)
        elif prog == "op_1d":
            spec = compact_pcr.grad_spec(d[axis], +1, n, compact_pcr._dtype_rtol(dtype))
            got = compact_pcr.op_1d(f, spec, axis)
            ref = compact_pcr.op_1d(f, spec, axis, plain=True)
        elif prog.startswith("interp"):
            st = -1 if prog.endswith("-") else +1
            got, ref = compact_pcr.interp(f, st), compact_pcr.interp(f, st, plain=True)
        else:
            fn = getattr(compact_pcr, prog)
            got, ref = fn(f, d), fn(f, d, plain=True)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (prog, n, axis)
    assert used and set(used) == {n}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,exact", [(64, True), (128, True), (96, False)])
def test_register_mirror_k14_solve(n, exact, dtype):
    """K14's circulant solve on the register kernel: the exact schedule with
    its (i, i+n/2) pairing at power-of-two n, the truncated one at n = 96,
    on (n, Q) lines as tridiag_cuda passes them."""
    rt = 0.0 if exact else compact_pcr._dtype_rtol(dtype)
    sched = compact_pcr.pcr_schedule(9.0 / 62.0, n, rt)
    assert (sched[2] != 0.0) == exact
    program = (((0, (compact_pcr.solve_spec(0.8, sched),)),),)
    d2 = torch.as_tensor(field((n, 40), n), dtype=dtype)
    used = []
    (got,) = _mirror_sweep(program, [d2], 0, used)
    (ref,) = compact_pcr.sweep_plain(program, [d2], 0)
    assert used == [n] and torch.equal(got, ref)


def test_register_route_refuses_a_width():
    """The lane width is the tile kernel's: a register line refuses one
    (before anything is launched)."""
    f = torch.zeros((2, 64, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="register kernel"):
        compact_pcr.sweep((((0, (compact_pcr.interp_spec(-1, 64, 1e-8),)),),), [f], 1,
                          width=16)


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
