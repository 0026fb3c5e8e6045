"""The port's red-black SOR kernels (plain versions) and MG smoothers
against the JAX package.

K3 (zero-guess sweep), K4 (sweep, with and without the dots) and K5 (zero
sweep with CG's update fused in) are held to the Pallas kernels in
interpret mode, both colour orders, at 16^3, 32^3 and a grid with three
different spacings. The roll-path smoothers are held to the JAX roll path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.ops import stencil_pallas as jpallas
from poissbox_tpu.solvers import mg as jmg
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import stencil_cuda
from poissbox_tpu_torch.solvers import mg

GRIDS = [((16, 16, 16), (1.0, 1.0, 1.0)),
         ((32, 32, 32), (1.0, 1.0, 1.0)),
         ((16, 8, 12), (1.0, 0.75, 1.5))]
GRID_IDS = ["16^3", "32^3", "aniso"]
RTOL, ATOL = 1e-12, 1e-13
W = 1.0


def fields(shape, seed, k):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape) for _ in range(k)]


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_zero_sweep_plain_matches_pallas(shape, length, reverse):
    """K3."""
    (b,) = fields(shape, 11, 1)
    d = Grid3D(shape, length).deltas
    ref = jpallas.sor_rb_zero_sweep_pallas(jnp.asarray(b), d, W, reverse=reverse)
    close(stencil_cuda.sor_rb_zero_sweep_plain(t(b), d, W, reverse).numpy(), ref)


@pytest.mark.parametrize("dots", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_sweep_plain_matches_pallas(shape, length, reverse, dots):
    """K4, with and without the <x, b>, sum(x) partials."""
    u, b = fields(shape, 12, 2)
    d = Grid3D(shape, length).deltas
    ref = jpallas.sor_rb_sweep_pallas(jnp.asarray(u), jnp.asarray(b), d, W,
                                      reverse=reverse, dots=dots)
    got = stencil_cuda.sor_rb_sweep_plain(t(u), t(b), d, W, reverse, dots)
    if not dots:
        close(got.numpy(), ref)
        return
    close(got[0].numpy(), ref[0])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-11)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-11)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_zero_update_plain_matches_pallas(shape, length, reverse):
    """K5: b = r - alpha*Ap formed, written, reduced, then swept."""
    r, ap = fields(shape, 13, 2)
    alpha = 0.41
    d = Grid3D(shape, length).deltas
    rb, rx, rrr, rsr = jpallas.sor_rb_zero_update_pallas(
        jnp.asarray(r), jnp.asarray(ap), alpha, d, W, reverse=reverse)
    b, x, rr, sr = stencil_cuda.sor_rb_zero_update_plain(
        t(r), t(ap), torch.tensor(alpha, dtype=torch.float64), d, W, reverse)
    close(b.numpy(), rb)
    close(x.numpy(), rx)
    np.testing.assert_allclose(float(rr), float(rrr), rtol=1e-11)
    # sum(b) of zero-mean noise: relative to the sum of |b|
    np.testing.assert_allclose(float(sr), float(rsr), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(rb)).sum())


@pytest.mark.parametrize("nsweeps", [0, 2])
def test_multisweep_plain_matches_pallas(nsweeps):
    u, b = fields((16, 16, 16), 14, 2)
    d = (1.0 / 16,) * 3
    ref = jpallas.sor_rb_multisweep_pallas(jnp.asarray(u), jnp.asarray(b), d,
                                           W, nsweeps, reverse=True, dots=True)
    got = stencil_cuda.sor_rb_multisweep_plain(t(u), t(b), d, W, nsweeps,
                                               reverse=True, dots=True)
    close(got[0].numpy(), ref[0])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-11)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-11)
    # the wrapper on CPU tensors is the plain version
    wrapped = stencil_cuda.sor_rb_multisweep_cuda(t(u), t(b), d, W, nsweeps,
                                                  reverse=True, dots=True)
    for a, c in zip(wrapped, got):
        assert torch.equal(a, c)


def test_sor_wrappers_take_plain_version_on_cpu():
    r, ap, u = (t(a) for a in fields((8, 8, 8), 15, 3))
    d = (0.125,) * 3
    alpha = torch.tensor(0.3, dtype=torch.float64)
    stencil_cuda.reset_launches()
    assert torch.equal(stencil_cuda.sor_rb_zero_sweep_cuda(r, d, W, True),
                       stencil_cuda.sor_rb_zero_sweep_plain(r, d, W, True))
    for a, c in zip(stencil_cuda.sor_rb_zero_update_cuda(r, ap, alpha, d, W),
                    stencil_cuda.sor_rb_zero_update_plain(r, ap, alpha, d, W)):
        assert torch.equal(a, c)
    for a, c in zip(stencil_cuda.sor_rb_sweep_cuda(u, r, d, W, dots=True),
                    stencil_cuda.sor_rb_sweep_plain(u, r, d, W, dots=True)):
        assert torch.equal(a, c)
    assert not any(stencil_cuda.LAUNCHES.values())


def _levels(shape, length):
    d = Grid3D(shape, length).deltas
    return (mg._build_levels(shape, d, mg.MGConfig()),
            jmg._build_levels(shape, d, jmg.MGConfig()))


@pytest.mark.parametrize("smoother", ["sor", "jacobi", "chebyshev"])
@pytest.mark.parametrize("zero_guess", [True, False])
def test_roll_smoothers_match_jax(smoother, zero_guess):
    shape, length = (16, 8, 12), (1.0, 0.75, 1.5)
    (lvl, *_), (jlvl, *_) = _levels(shape, length)
    x, b = fields(shape, 16, 2)
    cfg = mg.MGConfig(smoother=smoother, impl="roll")
    jcfg = jmg.MGConfig(smoother=smoother, impl="roll")
    got = mg._smooth(None if zero_guess else t(x), t(b), lvl, cfg, 2,
                     reverse=True)
    ref = jax.jit(lambda xx, bb: jmg._smooth(xx, bb, jlvl, jcfg, 2, reverse=True))(
        None if zero_guess else jnp.asarray(x), jnp.asarray(b))
    close(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("impl", ["roll", "cuda"])
def test_zero_sweeps_are_exact_noops(impl):
    shape = (8, 8, 8)
    (lvl, *_), _ = _levels(shape, (1.0, 1.0, 1.0))
    x, b = (t(a) for a in fields(shape, 17, 2))
    cfg = mg.MGConfig(impl=impl)
    assert torch.equal(mg._smooth(None, b, lvl, cfg, 0, False),
                       torch.zeros_like(b))
    assert mg._smooth(x, b, lvl, cfg, 0, True) is x
    with pytest.raises(ValueError):
        mg._smooth(x, b, lvl, cfg, -1, True)


def test_kernel_smoother_matches_pallas_smoother():
    """The impl='cuda' SOR smoother (plain versions on CPU) against the
    JAX impl='pallas' smoother, zero guess and from an iterate, with dots."""
    shape, length = (16, 16, 16), (1.0, 1.0, 1.0)
    (lvl, *_), (jlvl, *_) = _levels(shape, length)
    x, b = fields(shape, 18, 2)
    cfg, jcfg = mg.MGConfig(impl="cuda"), jmg.MGConfig(impl="pallas")
    close(mg._smooth(None, t(b), lvl, cfg, 3, False).numpy(),
          jmg._smooth(None, jnp.asarray(b), jlvl, jcfg, 3, False))
    got = mg._smooth(t(x), t(b), lvl, cfg, 2, True, dots=True)
    ref = jmg._smooth(jnp.asarray(x), jnp.asarray(b), jlvl, jcfg, 2, True,
                      dots=True)
    close(got[0].numpy(), ref[0])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-11)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-11)


def test_jacobi_kernel_not_ported_raises():
    (lvl, *_), _ = _levels((8, 8, 8), (1.0, 1.0, 1.0))
    b = torch.ones(8, 8, 8, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="K10"):
        mg._smooth(None, b, lvl, mg.MGConfig(smoother="jacobi", impl="cuda"),
                   1, False)
