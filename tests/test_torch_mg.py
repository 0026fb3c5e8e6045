"""The port's multigrid preconditioner against the JAX package: transfers,
hierarchy, coarse pseudo-inverse, and the whole cycle — M(r), apply_dots
and apply_update_dots — on the kernel path (plain versions on the CPU)
against JAX's Pallas path in interpret mode, and on the roll path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.solvers import mg as jmg
from poissbox_tpu_torch.solvers import mg

RTOL_FIELD, RTOL_DOT = 1e-12, 1e-11


def fields(shape, seed, k=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape) for _ in range(k)]


def t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 4, 6)])
def test_transfers_match_jax_exactly(shape):
    # op by op, as the JAX package evaluates them eagerly (a jitted XLA
    # fusion may contract a*b+c and round once less)
    (f,) = fields(shape, 21)
    np.testing.assert_array_equal(mg.restrict(t(f)).numpy(),
                                  np.asarray(jmg.restrict(jnp.asarray(f))))
    np.testing.assert_array_equal(mg.prolong(t(f)).numpy(),
                                  np.asarray(jmg.prolong(jnp.asarray(f))))


@pytest.mark.parametrize("shape,deltas,cfg", [
    ((32, 32, 32), (1 / 32,) * 3, {}),
    ((64, 32, 48), (1 / 64, 0.75 / 32, 1.5 / 48), {}),
    ((24, 24, 24), (0.1,) * 3, {"levels": 2}),
    ((16, 16, 16), (1 / 16,) * 3, {"coarse_size": 2}),
])
def test_levels_and_coarse_pinv_match_jax(shape, deltas, cfg):
    lv = mg._build_levels(shape, deltas, mg.MGConfig(**cfg))
    jlv = jmg._build_levels(shape, deltas, jmg.MGConfig(**cfg))
    assert [(l.shape, l.deltas, l.diag) for l in lv] == \
        [(l.shape, l.deltas, l.diag) for l in jlv]
    if np.prod(lv[-1].shape) <= 512:
        # the only setup state: bit for bit the JAX package's pinv
        pinv = mg._coarse_pinv(lv[-1], mg.MGConfig(), torch.float64)
        jpinv = jmg._coarse_pinv(jlv[-1], jmg.MGConfig(), jnp.float64)
        np.testing.assert_array_equal(pinv.numpy(), np.asarray(jpinv))


@pytest.mark.parametrize("shape", [(64, 64, 64), (256, 256, 256),
                                   (512, 512, 512), (32, 600, 600)])
@pytest.mark.parametrize("pre,post", [(-1, -1), (1, -1), (4, 0)])
def test_resolve_sweeps_matches_jax(shape, pre, post):
    got = mg._resolve_sweeps(mg.MGConfig(pre_smooth=pre, post_smooth=post), shape)
    ref = jmg._resolve_sweeps(jmg.MGConfig(pre_smooth=pre, post_smooth=post), shape)
    assert (got.pre_smooth, got.post_smooth) == (ref.pre_smooth, ref.post_smooth)


@pytest.mark.parametrize("smoother", ["sor", "jacobi", "chebyshev"])
def test_sweeps_for_level_rtol_matches_jax(smoother):
    for rtol, it in [(1e-4, 3), (1e-2, 10), (0.5, 4), (1.0, 5)]:
        assert (mg.sweeps_for_level_rtol(smoother, rtol, it)
                == jmg.sweeps_for_level_rtol(smoother, rtol, it))


def test_512_f32_default_keeps_bf16_pre_smooth_rule():
    M = mg.make_mg_preconditioner((512,) * 3, (1 / 512,) * 3, mg.MGConfig(),
                                  torch.float32, "cpu")
    assert M.config.pre_dtype == "bfloat16"
    assert (M.config.pre_smooth, M.config.post_smooth) == (1, 1)
    # with roll transfers the JAX package binds no fused update here either
    assert getattr(M, "apply_update_dots", None) is None


@pytest.fixture(scope="module")
def mg32():
    """The 32^3 hierarchy both ways: port impl='cuda' on CPU tensors (the
    kernels' plain versions on every level) and JAX impl='pallas' with
    roll transfers in interpret mode."""
    n = 32
    shape, d = (n,) * 3, (1.0 / n,) * 3
    M = mg.make_mg_preconditioner(shape, d, mg.MGConfig(impl="cuda"))
    jM = jmg.make_mg_preconditioner(
        shape, d, jmg.MGConfig(impl="pallas", transfers="roll"),
        dtype=jnp.float64)
    r, ap = fields(shape, 22, 2)
    return M, jM, r - r.mean(), ap


def test_cycle_matches_pallas_path(mg32):
    M, jM, r, _ = mg32
    assert dataclasses.asdict(M.config) == {
        **dataclasses.asdict(jM.config), "impl": "cuda", "transfers": "auto"}
    ref = np.asarray(jax.jit(jM)(jnp.asarray(r)))
    np.testing.assert_allclose(M(t(r)).numpy(), ref, rtol=RTOL_FIELD,
                               atol=1e-12 * np.abs(ref).max())


def test_apply_dots_matches_pallas_path(mg32):
    M, jM, r, _ = mg32
    v, rv, sv = M.apply_dots(t(r))
    jv, jrv, jsv = jax.jit(jM.apply_dots)(jnp.asarray(r))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL_FIELD,
                               atol=1e-12 * np.abs(np.asarray(jv)).max())
    np.testing.assert_allclose(float(rv), float(jrv), rtol=RTOL_DOT)
    # sum(M r) of a mean-free r is rounding noise: relative to sum |M r|
    np.testing.assert_allclose(float(sv), float(jsv), rtol=0,
                               atol=RTOL_DOT * np.abs(np.asarray(jv)).sum())


def test_apply_update_dots_matches_pallas_path(mg32):
    M, jM, r, ap = mg32
    alpha = 0.37
    got = M.apply_update_dots(t(r), t(ap), torch.tensor(alpha, dtype=torch.float64))
    ref = jax.jit(jM.apply_update_dots)(jnp.asarray(r), jnp.asarray(ap), alpha)
    for g, f in zip(got[:2], ref[:2]):        # v, b
        f = np.asarray(f)
        np.testing.assert_allclose(g.numpy(), f, rtol=RTOL_FIELD,
                                   atol=1e-12 * np.abs(f).max())
    for g, f in zip(got[2:], ref[2:]):        # ||b||^2, sum b, <b, v>, sum v
        np.testing.assert_allclose(float(g), float(f), rtol=RTOL_DOT,
                                   atol=1e-12 * abs(float(ref[2])))


@pytest.mark.parametrize("cfg", [
    {},
    {"cycle": "w", "pre_smooth": 0, "post_smooth": 2},
    {"smoother": "jacobi", "pre_smooth": 2, "post_smooth": 2, "cycles": 2,
     "damping": 0.8},
    {"smoother": "chebyshev", "pre_smooth": 1, "post_smooth": 1},
], ids=["V", "W-post-only", "jacobi-2cycles", "chebyshev"])
def test_roll_cycle_matches_jax_roll(cfg):
    shape, d = (16, 16, 16), (1 / 16,) * 3
    M = mg.make_mg_preconditioner(shape, d, mg.MGConfig(impl="roll", **cfg))
    jM = jmg.make_mg_preconditioner(shape, d, jmg.MGConfig(impl="roll", **cfg),
                                    dtype=jnp.float64)
    (r,) = fields(shape, 23)
    ref = np.asarray(jax.jit(jM)(jnp.asarray(r)))
    np.testing.assert_allclose(M(t(r)).numpy(), ref, rtol=RTOL_FIELD,
                               atol=1e-12 * np.abs(ref).max())
    assert (getattr(M, "apply_dots", None) is None) == \
        (getattr(jM, "apply_dots", None) is None)
    # the roll path binds no fused update, as the JAX package off the TPU
    assert getattr(M, "apply_update_dots", None) is None


def test_bf16_cycle_dtype_runs_on_cpu():
    shape, d = (16, 16, 16), (1 / 16,) * 3
    M = mg.make_mg_preconditioner(shape, d, mg.MGConfig(dtype="bfloat16"))
    (r,) = fields(shape, 24)
    v = M(t(r))
    assert v.dtype == torch.float64 and getattr(M, "apply_dots", None) is None
    ref = mg.make_mg_preconditioner(shape, d, mg.MGConfig())(t(r)).numpy()
    # bf16 keeps ~3 digits: the cycle is the f64 cycle to that precision
    np.testing.assert_allclose(v.numpy(), ref, rtol=0,
                               atol=5e-2 * np.abs(ref).max())


def test_unported_options_raise():
    shape, d = (8, 8, 8), (1 / 8,) * 3
    with pytest.raises(NotImplementedError, match="K6/K7"):
        mg.make_mg_preconditioner(shape, d, mg.MGConfig(transfers="matmul"))
    with pytest.raises(ValueError):
        mg.make_mg_preconditioner(shape, d, mg.MGConfig(impl="pallas"))(
            torch.zeros(shape, dtype=torch.float64))
