"""The plain reference: the operators against dense matrices built row by
row from their definitions, the exact solve, the traffic generator, and
the control, which has to fail each cell's limit."""

import math

import numpy as np
import pytest
import torch

from perfbench import control, pool
from perfbench.reference import operators as ref
from perfbench_helpers import small_cell


def second_difference(n: int, h: float) -> np.ndarray:
    L = np.zeros((n, n))
    for i in range(n):
        L[i, i] = -2.0
        L[i, (i - 1) % n] += 1.0
        L[i, (i + 1) % n] += 1.0
    return L / h**2


def compact_1d(n: int, a: float, b: float, alpha: float, s: float, shift: int) -> np.ndarray:
    """T^-1 R of the periodic staggered scheme
    alpha g[i-1] + g[i] + alpha g[i+1] = a (f[i+shift] + s f[i-1+shift])
                                       + b (f[i+1+shift] + s f[i-2+shift])."""
    T, R = np.eye(n), np.zeros((n, n))
    for i in range(n):
        T[i, (i - 1) % n] += alpha
        T[i, (i + 1) % n] += alpha
        R[i, (i + shift) % n] += a
        R[i, (i - 1 + shift) % n] += s * a
        R[i, (i + 1 + shift) % n] += b
        R[i, (i - 2 + shift) % n] += s * b
    return np.linalg.solve(T, R)


def compact_pairs(n: int, h: float):
    """(D' D, I' I) of one axis, dense."""
    ga, gb, galpha = 63.0 / 62.0 / h, 17.0 / 62.0 / (3.0 * h), 9.0 / 62.0
    ia, ib, ialpha = 0.75, 1.0 / 20.0, 3.0 / 10.0
    D = compact_1d(n, ga, gb, galpha, -1.0, 0)
    Dp = compact_1d(n, ga, gb, galpha, -1.0, 1)
    I = compact_1d(n, ia, ib, ialpha, 1.0, 0)
    Ip = compact_1d(n, ia, ib, ialpha, 1.0, 1)
    return Dp @ D, Ip @ I


def dense3(mats) -> np.ndarray:
    out = mats[0]
    for m in mats[1:]:
        out = np.kron(out, m)
    return out


@pytest.mark.parametrize("shape,length", [((8, 8, 8), (1.0, 1.0, 1.0)),
                                          ((8, 12, 6), (1.0, 2.0, 0.5))])
def test_lapl7_is_the_dense_stencil(shape, length):
    d = pool.deltas(shape, length)
    eye = [np.eye(n) for n in shape]
    A = sum(dense3([second_difference(n, h) if k == ax else eye[k] for k, (n, h)
                    in enumerate(zip(shape, d))]) for ax in range(3))
    u = np.random.default_rng(0).uniform(-1, 1, shape)
    got = ref.lapl7(torch.from_numpy(u), d).numpy()
    np.testing.assert_allclose(got.ravel(), A @ u.ravel(), rtol=0, atol=1e-9 * np.abs(A @ u.ravel()).max())
    lam = ref.symbol(2, shape, d)
    spectral = torch.fft.irfftn(torch.fft.rfftn(torch.from_numpy(u)) * lam, s=shape).numpy()
    np.testing.assert_allclose(spectral, got, rtol=0, atol=1e-10 * np.abs(got).max())


@pytest.mark.parametrize("shape,length", [((8, 8, 8), (1.0, 1.0, 1.0)),
                                          ((8, 12, 6), (1.0, 2.0, 0.5))])
def test_lapl6_is_the_dense_compact_matrix(shape, length):
    d = pool.deltas(shape, length)
    pairs = [compact_pairs(n, h) for n, h in zip(shape, d)]
    A = sum(dense3([pairs[k][0] if k == ax else pairs[k][1] for k in range(3)])
            for ax in range(3))
    u = np.random.default_rng(1).uniform(-1, 1, shape)
    got = ref.lapl6(torch.from_numpy(u), d).numpy()
    np.testing.assert_allclose(got.ravel(), A @ u.ravel(), rtol=0, atol=1e-10 * np.abs(A @ u.ravel()).max())


def test_lapl6_is_the_compact_matrix_along_each_axis_at_16():
    n, h = 16, 1.0 / 16
    dd, ii = compact_pairs(n, h)
    u = np.random.default_rng(2).uniform(-1, 1, (n, n, n))
    want = (np.einsum("ai,bj,ck,ijk->abc", dd, ii, ii, u) + np.einsum("ai,bj,ck,ijk->abc", ii, dd, ii, u)
            + np.einsum("ai,bj,ck,ijk->abc", ii, ii, dd, u))
    got = ref.lapl6(torch.from_numpy(u), (h, h, h)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_lapl6_agrees_with_the_programs_plain_compact_laplacian():
    from poissbox_tpu_torch.ops import compact
    d = (1 / 16, 1 / 12, 1 / 20)
    u = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (16, 12, 20)))
    got = ref.lapl6(u, d)
    want = compact.lapl(u, d, method="pscan")
    assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max())


@pytest.mark.parametrize("order,kind", [(2, "uniform"), (6, "band")])
def test_solve_inverts_apply(order, kind):
    shape, length = (16, 16, 16), (1.0, 1.0, 1.0)
    d = pool.deltas(shape, length)
    u = pool.field(kind, shape, pool.generator(5, "cpu"), band=1.0)
    b = ref.apply(order, u, d)
    x = ref.solve(order, b, d)
    assert ref.relative_residual(order, x, b, d) < 1e-12
    assert ref.relative_error(order, u, b, d) < 1e-10
    if order == 2:
        assert float((x - u).abs().max()) < 1e-10


def test_relative_error_sees_the_7_point_solve_in_the_compact_ones_place():
    shape = (32, 32, 32)
    d = pool.deltas(shape, (1.0, 1.0, 1.0))
    u = pool.field("band", shape, pool.generator(6, "cpu"), band=2.0)
    b = ref.apply(6, u, d)
    assert ref.relative_error(6, ref.solve(6, b, d), b, d) < 1e-12
    assert ref.relative_error(6, ref.solve(2, b, d), b, d) > 1e-3


def test_the_band_field_has_its_envelope_and_unit_rms():
    shape = (64, 64, 64)
    u = pool.field("band", shape, pool.generator(7, "cpu"), band=4.0)
    assert float(torch.sqrt(torch.mean(u * u))) == pytest.approx(1.0, rel=1e-3)
    power = torch.fft.rfftn(u).abs() ** 2
    k = torch.fft.fftfreq(64, 1 / 64).abs()
    # no content left near the Nyquist modes, most of it within 2 k0
    assert float(power[32].sum() / power.sum()) < 1e-20
    assert float(power[k <= 8].sum() / power.sum()) > 0.9


@pytest.mark.parametrize("name", ["poisson7.512.f32", "compact6.512.fft"])
def test_pool_comes_from_the_seed(name):
    cell = small_cell(name, 8)
    one = list(pool.right_hand_sides(cell, 2**31 + 7, "cpu"))
    two = list(pool.right_hand_sides(cell, 2**31 + 7, "cpu"))
    other = list(pool.right_hand_sides(cell, 2**31 + 8, "cpu"))
    assert len(one) == cell["pool"] and all(b.dtype == torch.float32 for b in one)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert not any(torch.equal(a, b) for a, b in zip(one, other))
    assert len({float(b.abs().sum()) for b in one}) == len(one)
    u = pool.field(cell["field"], cell["grid"], pool.generator(3, "cpu"), cell.get("band"))
    assert abs(float(u.mean())) < 1e-14


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-13, -3.0 - 3 * 2.0**-11], dtype=torch.float32)
    y = control.round_tf32(x)
    assert y.tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, -3.0 - 2.0**-9]


@pytest.mark.parametrize("name,n", [("poisson7.512.f32", 32), ("poisson7.64.f64", 32),
                                    ("compact6.512.fft", 64)])
def test_the_control_fails_and_the_witness_passes(name, n):
    cell = small_cell(name, n, pool=2)
    r = control.readings(cell, 2**31 + 3, torch.device("cpu"))
    assert r and all(v["witness"] < v["limit"] for v in r.values()), r
    assert any(v["limit"] < v["control"] for v in r.values()), r
    assert all(math.isfinite(v["control"]) for v in r.values())
