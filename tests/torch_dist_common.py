"""Shared by tests/test_torch_dist*.py: spawn a gloo group of CPU ranks
(tests/torch_dist_worker.py) for one decomposition, compute the JAX
package's results for the same inputs on the 8 virtual CPU devices while
the ranks run, and collect both. Every rank has a time limit; a rank that
fails or hangs fails the fixture, and every rank is stopped."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.config import Options as JOptions
from poissbox_tpu.config import SolverOptions as JSolverOptions
from poissbox_tpu.mesh import Grid3D as JGrid
from poissbox_tpu.mesh import make_device_mesh
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_op
from poissbox_tpu.parallel import dist_stencil as jds
from poissbox_tpu.parallel import uneven as jue
from poissbox_tpu.solvers.ksp import make_solver as jmake_solver
from poissbox_tpu.solvers.mg import MGConfig as JMGConfig
from poissbox_tpu.solvers.mg import _build_levels as j_build_levels
from poissbox_tpu.solvers.mg import make_mg_preconditioner as jmake_mg
from poissbox_tpu_torch.parallel.decomp import owned_boxes

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_dist_worker as worker  # noqa: E402

RANK_TIMEOUT = 150.0   # s for the whole group; each collective has 120 s
# what a test file takes with `from torch_dist_common import *`: the
# shared checks and the spawn
__all__ = ["run_case", "blocks", "test_dof_counts",
           "test_exchange_pads_equal_the_global_wrap",
           "test_sharded_operator_matches_jax", "test_sharded_reductions_match_jax",
           "test_vcycle_matches_jax", "test_level_stack_matches_jax",
           "test_mgcg_iterations_equal_jax", "test_mgcg_true_residual",
           "test_mgcg_x_matches_jax"]
OPS = ("apply", "apply_padded", "apply_dot", "residual", "jacobi", "sor0", "sor1",
       "cgupd.x", "cgupd.r")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(pgrid, n: int, out_dir: Path, extra=()) -> list:
    world = int(np.prod(pgrid))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    args = [str(world), str(port), ",".join(map(str, pgrid)), str(n), str(out_dir),
            *extra]
    return [subprocess.Popen([sys.executable, str(HERE / "torch_dist_worker.py"),
                              str(r), *args], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(world)]


def collect(procs, out_dir: Path, t_start: float) -> list[dict]:
    """Wait for every rank (within RANK_TIMEOUT of t_start); the ranks'
    npz results in rank order."""
    outs = []
    try:
        for p in procs:
            left = max(1.0, RANK_TIMEOUT - (time.perf_counter() - t_start))
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(len(procs))]


def blocks(a: np.ndarray, n: int, pgrid) -> list[np.ndarray]:
    """The owned boxes of a global field, in rank order."""
    return [a[xs:xs + xn, ys:ys + yn, zs:zs + zn]
            for _, ((xs, ys, zs), (xn, yn, zn))
            in sorted(owned_boxes((n,) * 3, pgrid).items())]


def _run(fn, *args):
    """`fn` jitted and run, compiled with XLA's backend (LLVM) optimisation
    off: the same IEEE arithmetic, compiled in about half the time, which
    is most of this file's cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def jax_reference(pgrid, n: int) -> dict:
    """The JAX package's sharded operators, V-cycle and MG-CG solves on
    the same process grid and inputs, as global numpy fields."""
    jg = JGrid((n,) * 3, mesh=make_device_mesh(pgrid))
    f = worker.fields(n)
    sh = lambda a: jg.shard(jnp.asarray(a))
    un = lambda a: np.asarray(jg.unshard(a))
    u, b, p, r, ap = (sh(f[k]) for k in ("u", "b", "p", "r", "ap"))
    w, wj, alpha = worker.W, worker.WJ, worker.ALPHA

    def ops(u, b, p, r, ap):
        """Every operator in one jitted program (one compile)."""
        if jg.uneven:
            # the padded layout's masked operators (their pads stay zero)
            au = jue.apply_laplacian_uneven(u, jg)
            ro = r - alpha * ap
            return {"apply": au, "apply_padded": au, "apply_dot": au,
                    "apply_dot.dot": jnp.sum(u * au),
                    "residual": jue.residual_uneven(u, b, jg),
                    "jacobi": jue.jacobi_sweep_uneven(u, b, jg, wj),
                    "sor0": jue.sor_sweep_uneven(u, b, jg, w, 0),
                    "sor1": jue.sor_sweep_uneven(u, b, jg, w, 1),
                    "cgupd.x": u + alpha * p, "cgupd.r": ro,
                    "cgupd.rr": jnp.sum(ro * ro), "cgupd.sr": jnp.sum(ro)}
        y, dot = jds.apply_laplacian_dot_sharded(u, jg)
        xo, ro, rr, sr = jds.cg_fused_update_sharded(alpha, u, p, r, ap, jg)
        return {"apply": jds.apply_laplacian_sharded(u, jg),
                "apply_padded": jds.apply_laplacian_sharded(u, jg, overlap=False),
                "apply_dot": y, "apply_dot.dot": dot,
                "residual": jds.residual_sharded(u, b, jg),
                "jacobi": jds.jacobi_sweep_sharded(u, b, jg, wj),
                "sor0": jds.sor_sweep_sharded(u, b, jg, w, 0),
                "sor1": jds.sor_sweep_sharded(u, b, jg, w, 1),
                "cgupd.x": xo, "cgupd.r": ro, "cgupd.rr": rr, "cgupd.sr": sr}

    ref = {k: (float(v) if v.ndim == 0 else un(v))
           for k, v in _run(ops, u, b, p, r, ap).items()}
    M = jmake_mg(jg.n, jg.deltas, JMGConfig(), jnp.float64, grid=jg)
    ref["vcycle"] = un(_run(M, b))
    ref["levels_dist"] = np.array([lv.grid is not None for lv in j_build_levels(
        jg.n, jg.deltas, M.config, grid=jg)])
    A = jmake_op(jg)
    bx = _run(A.apply, sh(f["x_exact"]))
    sopts = JSolverOptions.from_options(JOptions(worker.SOLVE))
    res = _run(jmake_solver(A, sopts, jg.n, jg.deltas, jnp.float64, grid=jg), bx)
    ref["sor.its"] = int(res.iterations)
    ref["sor.x"] = un(res.x)
    ref["dofs"] = jg.dof_counts()
    ref["fields"] = f
    return ref


def run_case(pgrid, n: int, out_dir: Path, jacobi: bool = False):
    """(the ranks' results, the JAX package's): the ranks run while JAX
    computes its side."""
    t0 = time.perf_counter()
    procs = spawn(pgrid, n, out_dir, ["jacobi"] if jacobi else [])
    try:
        ref = jax_reference(pgrid, n)
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return collect(procs, out_dir, t0), ref


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the checks of one spawn, each a test case of its own; a test file
# imports them and defines the module-scoped `dist_run` fixture over its
# decompositions: (pgrid, n, the ranks' results, the JAX package's)
# ---------------------------------------------------------------------------


def test_dof_counts(dist_run):
    pgrid, n, ranks, ref = dist_run
    for r in ranks:
        assert list(r["dofs"]) == list(ref["dofs"])
    assert sum(ref["dofs"]) == n ** 3


def test_exchange_pads_equal_the_global_wrap(dist_run):
    pgrid, n, ranks, ref = dist_run
    padded = np.pad(ref["fields"]["u"], 1, mode="wrap")
    for rk, (_, ((xs, ys, zs), (xn, yn, zn))) in zip(
            ranks, sorted(owned_boxes((n,) * 3, pgrid).items())):
        want = padded[xs:xs + xn + 2, ys:ys + yn + 2, zs:zs + zn + 2]
        np.testing.assert_array_equal(rk["pad"], want)


@pytest.mark.parametrize("op", OPS)
def test_sharded_operator_matches_jax(dist_run, op):
    pgrid, n, ranks, ref = dist_run
    for rk, want in zip(ranks, blocks(ref[op], n, pgrid)):
        assert rk[op].shape == want.shape
        assert rel_err(rk[op], want) <= 1e-12, op


@pytest.mark.parametrize("key", ("apply_dot.dot", "cgupd.rr", "cgupd.sr"))
def test_sharded_reductions_match_jax(dist_run, key):
    _, _, ranks, ref = dist_run
    for rk in ranks:        # every rank holds the all-reduced value
        assert abs(float(rk[key]) - ref[key]) <= 1e-12 * abs(ref[key])


def test_vcycle_matches_jax(dist_run):
    pgrid, n, ranks, ref = dist_run
    for rk, want in zip(ranks, blocks(ref["vcycle"], n, pgrid)):
        assert rel_err(rk["vcycle"], want) <= 1e-10


def test_level_stack_matches_jax(dist_run):
    _, _, ranks, ref = dist_run
    for rk in ranks:
        np.testing.assert_array_equal(rk["levels_dist"], ref["levels_dist"])


def test_mgcg_iterations_equal_jax(dist_run):
    _, _, ranks, ref = dist_run
    assert {int(rk["sor.its"]) for rk in ranks} == {ref["sor.its"]}


def test_mgcg_true_residual(dist_run):
    _, _, ranks, _ = dist_run
    for rk in ranks:
        assert float(rk["sor.rel"]) <= 1.01e-8


def test_mgcg_x_matches_jax(dist_run):
    pgrid, n, ranks, ref = dist_run
    got = np.concatenate([rk["sor.x"].ravel() for rk in ranks])
    want = np.concatenate([b.ravel() for b in blocks(ref["sor.x"], n, pgrid)])
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
