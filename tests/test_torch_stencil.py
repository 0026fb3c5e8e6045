"""The port's 7-point stencil against the JAX package.

Inputs are made with numpy from a seed and handed to both. The roll and
pointwise forms are held to the JAX roll and pointwise forms; the plain
versions of the CUDA stencil kernel (K1, K2, K9) to the Pallas kernels,
run in interpret mode as the JAX package's own tests run them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops import assemble as jassemble
from poissbox_tpu.ops import stencil as jstencil
from poissbox_tpu.ops import stencil_pallas as jpallas
from poissbox_tpu.ops.coefficients import lapl_star_coeffs as jlapl_star_coeffs
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import assemble, stencil, stencil_cuda
from poissbox_tpu_torch.ops.coefficients import lapl_star_coeffs

# (shape, lengths): cubic cells at 16^3 and 32^3, and a grid whose three
# spacings differ (the non-isotropic grouping of the kernels)
GRIDS = [((16, 16, 16), (1.0, 1.0, 1.0)),
         ((32, 32, 32), (1.0, 1.0, 1.0)),
         ((16, 8, 12), (1.0, 0.75, 1.5))]
GRID_IDS = ["16^3", "32^3", "aniso"]
# the kernel-parity tier of the JAX package's own Pallas tests
RTOL, ATOL = 1e-12, 1e-13


def fields(shape, seed, k=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape) for _ in range(k)]


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_roll_matches_jax(shape, length):
    (u,) = fields(shape, 1)
    d = Grid3D(shape, length).deltas
    ref = np.asarray(jstencil.apply_laplacian(jnp.asarray(u), d))
    got = stencil.apply_laplacian(t(u), d).numpy()
    close(got, ref, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_pointwise_matches_jax(shape, length):
    (u,) = fields(shape, 2)
    d = Grid3D(shape, length).deltas
    ref = np.asarray(jstencil.apply_laplacian_pointwise(jnp.asarray(u), d))
    got = stencil.apply_laplacian_pointwise(t(u), d).numpy()
    close(got, ref, atol=1e-12 * np.abs(ref).max())
    # and the two port forms agree with each other (the demo's check_lapl)
    roll = stencil.apply_laplacian(t(u), d).numpy()
    close(got, roll, atol=1e-12 * np.abs(ref).max())


def test_laplacian_local_matches_jax():
    (up,) = fields((10, 8, 6), 3)
    d = (0.1, 0.2, 0.3)
    ref = np.asarray(jstencil.laplacian_local(jnp.asarray(up), d))
    close(stencil.laplacian_local(t(up), d).numpy(), ref, atol=1e-12)


def test_star_coeffs_match_jax():
    ref = np.asarray(jlapl_star_coeffs(0.1, 0.25, 0.5, dtype=jnp.float64))
    np.testing.assert_array_equal(
        lapl_star_coeffs(0.1, 0.25, 0.5, dtype=torch.float64).numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_apply_plain_matches_pallas(shape, length):
    """K1: y = A u."""
    (u,) = fields(shape, 4)
    d = Grid3D(shape, length).deltas
    ref = np.asarray(jpallas.apply_laplacian_pallas(jnp.asarray(u), d))
    close(stencil_cuda.apply_laplacian_plain(t(u), d).numpy(), ref)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_apply_dot_plain_matches_pallas(shape, length):
    """K2: (A u, <u, A u>)."""
    (u,) = fields(shape, 5)
    d = Grid3D(shape, length).deltas
    ref, rdot = jpallas.apply_laplacian_dot_pallas(jnp.asarray(u), d)
    y, dot = stencil_cuda.apply_laplacian_dot_plain(t(u), d)
    close(y.numpy(), ref)
    np.testing.assert_allclose(float(dot), float(rdot), rtol=RTOL)


@pytest.mark.parametrize("shape,length", GRIDS, ids=GRID_IDS)
def test_residual_plain_matches_pallas(shape, length):
    """K9: r = b - A u."""
    u, b = fields(shape, 6, 2)
    d = Grid3D(shape, length).deltas
    ref = np.asarray(jpallas.residual_pallas(jnp.asarray(u), jnp.asarray(b), d))
    close(stencil_cuda.residual_plain(t(u), t(b), d).numpy(), ref)


def test_cuda_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version, bit for bit, and launches
    nothing."""
    u, b = (t(a) for a in fields((8, 8, 8), 7, 2))
    d = (0.125,) * 3
    stencil_cuda.reset_launches()
    assert torch.equal(stencil_cuda.apply_laplacian_cuda(u, d),
                       stencil_cuda.apply_laplacian_plain(u, d))
    y, dot = stencil_cuda.apply_laplacian_dot_cuda(u, d)
    y0, dot0 = stencil_cuda.apply_laplacian_dot_plain(u, d)
    assert torch.equal(y, y0) and torch.equal(dot, dot0)
    assert torch.equal(stencil_cuda.residual_cuda(u, b, d),
                       stencil_cuda.residual_plain(u, b, d))
    assert not any(stencil_cuda.LAUNCHES.values())


@pytest.mark.parametrize("impl", ["roll", "pointwise", "cuda", "auto"])
def test_operator_impls_agree(impl):
    grid = Grid3D((16, 12, 8), (1.0, 0.5, 2.0))
    (u,) = fields(grid.n, 8)
    A = stencil.make_laplacian_operator(grid, impl=impl)
    ref = np.asarray(jstencil.apply_laplacian(jnp.asarray(u), grid.deltas))
    close(A(t(u)).numpy(), ref, atol=1e-12 * np.abs(ref).max())
    assert (A.apply_dot is not None) == (impl == "cuda")
    jA = jstencil.make_laplacian_operator(JGrid3D(grid.n, grid.length), "roll")
    assert A.diagonal() == float(jA.diagonal())
    np.testing.assert_allclose(A.project(t(u)).numpy(),
                               np.asarray(jA.project(jnp.asarray(u))),
                               rtol=0, atol=1e-15)


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        stencil.make_laplacian_operator(Grid3D((8, 8, 8)), impl="pallas")
    with pytest.raises(ValueError):
        stencil.default_impl("meta")


@pytest.mark.parametrize("shape,length", [((6, 4, 8), (1.0, 2.0, 0.5)),
                                          ((2, 3, 4), (1.0, 1.0, 1.0))])
def test_stencil_matrix_matches_jax(shape, length):
    d = Grid3D(shape, length).deltas
    M = assemble.assemble_laplacian(shape, d)
    jM = jassemble.assemble_laplacian(shape, d, jnp.float64)
    np.testing.assert_array_equal(M.to_dense(), jM.to_dense())
    assert M.row(0, 1, 2) == jM.row(0, 1, 2)
    (u,) = fields(shape, 9)
    ref = np.asarray(jM(jnp.asarray(u)))
    close(M(t(u)).numpy(), ref, atol=1e-12 * np.abs(ref).max())
    with pytest.raises(ValueError):
        M(torch.zeros(3, 3, 3, dtype=torch.float64))
