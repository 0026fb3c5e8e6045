"""Shared by tests/test_torch_dist*.py: spawn a gloo group of CPU ranks
(tests/torch_dist_worker.py) for one decomposition, compute the JAX
package's results for the same inputs on the 8 virtual CPU devices while
the ranks run, and collect both. Every rank has a time limit; a rank that
fails or hangs fails the fixture, and every rank is stopped.

The order-6 and FFT references: the JAX package's ``compact_dist`` and
distributed FFT solves on the same process grid, and its order-6 CG + GMG
solve there. Two of its sharded paths fail on its CPU backend, so there
the reference is its one-device path (what the sharded path computes):
on an uneven decomposition every jitted ``_uneven_fallback`` (the compact
Laplacian came out far from the serial one at 32^3 on (3, 1, 1), while
the same code run eagerly matches it), and ``-pc_type fft`` across
devices (XLA's CPU FFT thunk refuses the pencil layout inside the
solver's loop: ``fft_thunk.cc:167`` RET_CHECK).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu import checkpoint as jcheckpoint
from poissbox_tpu.config import Options as JOptions
from poissbox_tpu.config import SolverOptions as JSolverOptions
from poissbox_tpu.mesh import Grid3D as JGrid
from poissbox_tpu.mesh import make_device_mesh
from poissbox_tpu.ops import compact_dist as jcd
from poissbox_tpu.ops.compact import make_compact_laplacian_operator as jmake_op6
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_op
from poissbox_tpu.parallel import dist_stencil as jds
from poissbox_tpu.parallel import uneven as jue
from poissbox_tpu.solvers import fft as jfft
from poissbox_tpu.solvers.cg import cg as jcg
from poissbox_tpu.solvers.ksp import make_solver as jmake_solver
from poissbox_tpu.solvers.mg import MGConfig as JMGConfig
from poissbox_tpu.solvers.mg import _build_levels as j_build_levels
from poissbox_tpu.solvers.mg import make_mg_preconditioner as jmake_mg
from poissbox_tpu.solvers.refine import refine as jrefine
from poissbox_tpu_torch.parallel.decomp import owned_boxes
from poissbox_tpu_torch.parallel.pencil import pencil_ok
from poissbox_tpu_torch.solvers.mg import MGConfig
from poissbox_tpu_torch.utils.census import (Collective, census_by_shape,
                                             pencil_bytes_model)
from poissbox_tpu_torch.utils.scaling import mgcg_iteration_model

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
           "test_mgcg_x_matches_jax", "test_compact_dist_matches_jax",
           "test_compact_dist_matches_one_rank", "test_fft_dist_matches_jax",
           "test_fft_dist_matches_one_rank", "test_pencil_counts_equal_the_model",
           "test_order6_mgcg_iterations_equal_jax", "test_order6_mgcg_true_residual",
           "test_order6_mgcg_x_matches_jax", "test_order6_fcg_fft_matches_jax",
           "test_ksp_fft_residual_within_twice_one_rank", "test_pipecg_matches_jax",
           "test_census_equals_the_iteration_model", "test_max_gather_is_the_coarse_level"]
OPS = ("apply", "apply_padded", "apply_dot", "residual", "jacobi", "sor0", "sor1",
       "cgupd.x", "cgupd.r")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(pgrid, n: int, out_dir: Path, extra=()) -> list:
    """Start one process a rank."""
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


def _compiled(fn, *args):
    """`fn` jitted for arguments like `args`, compiled with XLA's backend
    (LLVM) optimisation off: the same IEEE arithmetic, compiled in about
    half the time, which is most of this file's cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _run(fn, *args):
    """`fn` compiled by :func:`_compiled` and run."""
    return _compiled(fn, *args)(*args)


def jax_krylov(jg, A, bx, krylov: bool) -> dict:
    """The JAX package's PIPECG + MG on the MG-CG system and, with
    `krylov`, the worker's other KRYLOV solves, all in one program (one
    compile)."""
    solvers = {tag: jmake_solver(A, JSolverOptions.from_options(JOptions(argv)), jg.n,
                                 jg.deltas, jnp.float64, grid=jg)
               for tag, (argv, _) in worker.KRYLOV.items() if krylov or tag == "pipecg"}
    ref = {}
    for tag, res in _run(lambda b: {t: s(b) for t, s in solvers.items()}, bx).items():
        ref[f"{tag}.its"] = int(res.iterations)
        ref[f"{tag}.x"] = np.asarray(jg.unshard(res.x))
        ref[f"{tag}.hist"] = np.asarray(res.history)
    return ref


def jax_refine(jg, A, bx) -> dict:
    """solve_refined as the JAX package's facade builds it, on this
    process grid: float32 MG-CG corrections, float64 residuals."""
    M32 = jmake_mg(jg.n, jg.deltas, JMGConfig(), jnp.float32, grid=jg)
    inner = _compiled(lambda r: jcg(A, r, M=M32, rtol=1e-6, max_it=50),
                      bx.astype(jnp.float32))
    # the outer residuals through the compiled operator (an eager sharded
    # apply compiles at every call)
    A64 = dataclasses.replace(A, apply=_compiled(A.apply, bx))
    rr = jrefine(A64, inner, bx, rtol=1e-12, max_outer=4)
    return {"refine.counts": [rr.outer_iterations, rr.inner_iterations],
            "refine.x": np.asarray(jg.unshard(rr.x))}


def jax_checkpointed(jg, A, bx, out_dir: Path) -> dict:
    """solve_checkpointed as the JAX package's facade runs it (MG-CG in
    chunks of worker.EVERY iterations)."""
    M64 = jmake_mg(jg.n, jg.deltas, JMGConfig(), jnp.float64, grid=jg)
    res, total = jcheckpoint.solve_with_checkpoints(
        A, bx, str(out_dir / "jax_ckpt"), M=M64, rtol=1e-8, max_it=50, every=worker.EVERY)
    return {"ckpt.total": total, "ckpt.x": np.asarray(jg.unshard(res.x))}


def jax_reference(pgrid, n: int, out_dir: Path, pool, krylov: bool = False) -> dict:
    """The JAX package's sharded operators, V-cycle and MG-CG solves on
    the same process grid and inputs, as global numpy fields, and its
    other Krylov solves there (:func:`jax_krylov`; with `krylov` also
    :func:`jax_refine` and :func:`jax_checkpointed`), each of those in a
    thread of `pool` (XLA compiles them side by side)."""
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
    parts = [pool.submit(jax_krylov, jg, A, bx, krylov)]
    if krylov:
        parts += [pool.submit(jax_refine, jg, A, bx),
                  pool.submit(jax_checkpointed, jg, A, bx, out_dir)]
    res = _run(jmake_solver(A, sopts, jg.n, jg.deltas, jnp.float64, grid=jg), bx)
    ref["sor.its"] = int(res.iterations)
    ref["sor.x"] = un(res.x)
    for part in parts:
        ref.update(part.result())
    ref["dofs"] = jg.dof_counts()
    ref["fields"] = f
    return ref


def jax_order6(pgrid, n: int) -> dict:
    """The JAX package's compact operators, FFT solves and order-6 solves
    at n^3 for the order-6 checks (see the module docstring for where its
    one-device path stands in)."""
    jg = JGrid((n,) * 3, mesh=make_device_mesh(pgrid))
    one = JGrid((n,) * 3)
    og = one if jg.uneven else jg
    f = worker.fields6(n)
    sh = lambda a: og.shard(jnp.asarray(a)) if og.mesh is not None else jnp.asarray(a)

    def ops(u, F0, F1, F2, smooth):
        """Every operator in one jitted program (one compile); b6 is the
        solves' right-hand side."""
        return {"lapl": jcd.lapl(u, og), "grad": jcd.grad(u, og),
                "div": jcd.div(jnp.stack([F0, F1, F2], -1), og),
                "interp": jcd.interp(u, og, stagger=+1),
                "fft2": jfft.poisson_solve_fft_dist(u, og),
                "fft6": jfft.compact_poisson_solve_fft_dist(u, og),
                "b6": jcd.lapl(smooth, og)}

    ref = {k: np.asarray(v) for k, v in _run(
        ops, sh(f["u"]), *(sh(f["F"][..., k]) for k in range(3)), sh(f["smooth"])).items()}
    for tag, argv, g in (("cg6", ["-ksp_type", "cg", "-pc_type", "mg"], og),
                         ("fcg6", ["-ksp_type", "fcg", "-pc_type", "fft"], one)):
        opts = JSolverOptions.from_options(JOptions(
            argv + ["-ksp_rtol", "1e-8", "-ksp_max_it", "200"]))
        bg = g.shard(jnp.asarray(ref["b6"])) if g.mesh is not None else jnp.asarray(ref["b6"])
        res = _run(jmake_solver(jmake_op6(g), opts, g.n, g.deltas, jnp.float64, grid=g), bg)
        ref[f"{tag}.its"] = int(res.iterations)
        ref[f"{tag}.x"] = np.asarray(res.x)
    return ref


def run_case(pgrid, n: int, out_dir: Path, *, n6: int, jacobi: bool = False,
             mgopts: bool = False, krylov: bool = False):
    """(the ranks' results, the JAX package's): the ranks run while JAX
    computes its side. `n6`: the size of the order-6 and FFT cases;
    `krylov`: the worker's other Krylov and facade cases too."""
    t0 = time.perf_counter()
    extra = ((["jacobi"] if jacobi else []) + (["mgopts"] if mgopts else [])
             + (["krylov"] if krylov else []))
    procs = spawn(pgrid, n, out_dir, extra + [f"n6={n6}"])
    try:
        with ThreadPoolExecutor(4) as pool:
            order6 = pool.submit(jax_order6, pgrid, n6)
            ref = jax_reference(pgrid, n, out_dir, pool, krylov)
            ref["order6"] = order6.result()
        ref["n6"] = n6
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


def _records(text: str) -> collections.Counter:
    """A rank's census records as the worker wrote them (JSON), as a
    multiset."""
    return collections.Counter(
        Collective(op, nbytes, dim, None if shape is None else tuple(shape), ranks)
        for op, nbytes, dim, shape, ranks in json.loads(str(text)))


@pytest.mark.parametrize("cfg", tuple(worker.CENSUS_MG))
def test_census_equals_the_iteration_model(dist_run, cfg):
    """Every rank's census of one MG-CG iteration (a window of 2
    iterations less one of 1) is utils.scaling.mgcg_iteration_model's
    replay for that rank and the solver's MGConfig, record for record:
    every exchange, face, gather and all-reduce with its bytes, dim and
    block shape (V- and W-cycles; SOR, Jacobi and Chebyshev smoothing)."""
    pgrid, n, ranks, _ = dist_run
    for r, rk in enumerate(ranks):
        got = _records(rk[f"census.{cfg}.iteration"])
        mg_cfg = MGConfig(**json.loads(str(rk[f"census.{cfg}.config"])))
        model = mgcg_iteration_model((n,) * 3, pgrid, mg_cfg, itemsize=8, rank=r)
        want = collections.Counter(model.records)
        assert got == want, (r, census_by_shape(got.elements()),
                             census_by_shape(want.elements()))


def test_max_gather_is_the_coarse_level(dist_run):
    """The largest gather of a whole MG-CG solve (the replication
    tripwire) is the field where the replicated tail starts: the first
    level that does not split evenly, or the coarsest (its coarse solve
    gathers); on an uneven grid the fine residual, in buffers of the
    largest box."""
    pgrid, n, ranks, _ = dist_run
    levels = mgcg_iteration_model((n,) * 3, pgrid).levels
    if any(n % p for p in pgrid):
        big = [-(-n // p) for p in pgrid]
        want = 8 * int(np.prod(pgrid)) * int(np.prod(big))
    else:
        shape = next((s for s, dist in levels if not dist), levels[-1][0])
        assert shape != levels[0][0]
        want = 8 * int(np.prod(shape))
    for rk in ranks:
        assert int(rk["census.max_gather"]) == want


# ---------------------------------------------------------------------------
# order 6 and the FFT across ranks (the worker's `n6` cases)
# ---------------------------------------------------------------------------

OPS6 = ("lapl", "grad", "div", "interp", "fft2", "fft6")   # the worker's order6()


def _glued(ranks, key, n, pgrid):
    """The ranks' blocks of `key` in one global field (vector fields by
    component)."""
    first = ranks[0][key]
    out = np.empty((n,) * 3 + first.shape[3:])
    for rk, (_, ((xs, ys, zs), (xn, yn, zn))) in zip(
            ranks, sorted(owned_boxes((n,) * 3, pgrid).items())):
        out[xs:xs + xn, ys:ys + yn, zs:zs + zn] = rk[key]
    return out


@pytest.mark.parametrize("op", ("lapl", "grad", "div", "interp"))
def test_compact_dist_matches_jax(dist_run, op):
    pgrid, _, ranks, ref = dist_run
    n = ref["n6"]
    want = ref["order6"][op]
    assert np.abs(_glued(ranks, op, n, pgrid) - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("op", ("lapl", "grad", "div", "interp"))
def test_compact_dist_matches_one_rank(dist_run, op):
    """Each rank's block against its box of the one-rank operator on the
    global field (the same sweeps on whole lines: no rounding apart)."""
    for rk in dist_run[2]:
        assert float(rk[f"{op}.vs1"]) <= 1e-14


@pytest.mark.parametrize("op", ("fft2", "fft6"))
def test_fft_dist_matches_jax(dist_run, op):
    pgrid, _, ranks, ref = dist_run
    n = ref["n6"]
    want = ref["order6"][op]
    assert np.abs(_glued(ranks, op, n, pgrid) - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("op", ("fft2", "fft6"))
def test_fft_dist_matches_one_rank(dist_run, op):
    for rk in dist_run[2]:
        assert float(rk[f"{op}.vs1"]) <= 1e-14


@pytest.mark.parametrize("op", OPS6)
def test_pencil_counts_equal_the_model(dist_run, op):
    """Rank 0's all-to-alls, their bytes and its gathers against the shape
    model (census.pencil_bytes_model) of the route the call takes on
    this decomposition, f64 fields: a compact operator transposes where
    every layout divides the grid, else gathers its inputs (div: three
    components); an FFT solve takes fft.fft_route's route (the packed one
    gathers the Nyquist plane)."""
    pgrid, _, ranks, ref = dist_run
    n = ref["n6"]
    if op.startswith("fft"):
        route = str(ranks[0]["fft.route"])
        gathers = 0 if route == "complex" else 1
    else:
        route = op if pencil_ok((n,) * 3, pgrid) else "gather"
        gathers = 0 if route != "gather" else (3 if op == "div" else 1)
    calls, nbytes = pencil_bytes_model((n,) * 3, pgrid, 8, route)
    assert list(ranks[0][f"{op}.counts"]) == [calls, nbytes, gathers]


def test_order6_mgcg_iterations_equal_jax(dist_run):
    _, _, ranks, ref = dist_run
    assert {int(rk["cg6.its"]) for rk in ranks} == {ref["order6"]["cg6.its"]}
    assert int(ranks[0]["cg61.its"]) == ref["order6"]["cg6.its"]


def test_order6_mgcg_true_residual(dist_run):
    for rk in dist_run[2]:
        assert float(rk["cg6.rel"]) <= 1.01e-8


def test_order6_mgcg_x_matches_jax(dist_run):
    pgrid, _, ranks, ref = dist_run
    n = ref["n6"]
    want = ref["order6"]["cg6.x"]
    got = _glued(ranks, "cg6.x", n, pgrid)
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    one = ranks[0]["cg61.x"]
    assert np.linalg.norm(got - one) <= 1e-12 * np.linalg.norm(one)


def test_order6_fcg_fft_matches_jax(dist_run):
    pgrid, _, ranks, ref = dist_run
    n = ref["n6"]
    assert {int(rk["fcg6.its"]) for rk in ranks} == {ref["order6"]["fcg6.its"]}
    for rk in ranks:
        assert float(rk["fcg6.rel"]) <= 1.01e-8
    want = ref["order6"]["fcg6.x"]
    got = _glued(ranks, "fcg6.x", n, pgrid)
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


@pytest.mark.parametrize("order", (2, 6))
def test_ksp_fft_residual_within_twice_one_rank(dist_run, order):
    _, _, ranks, _ = dist_run
    one = float(ranks[0][f"kspfft{order}1.rel"])
    for rk in ranks:
        assert int(rk[f"kspfft{order}.its"]) == 1
        assert float(rk[f"kspfft{order}.rel"]) <= 2.0 * one


@pytest.mark.parametrize("opt", tuple(worker.MG_OPTS))
def test_mg_options_match_one_rank(dist_run, opt):
    """MG options across ranks (spawns run with `mgopts`): the one-rank
    iteration count, and x within 1e-12 of the one-rank x."""
    pgrid, n, ranks, _ = dist_run
    one = ranks[0]
    assert {int(r[f"mg.{opt}.its"]) for r in ranks} == {int(one[f"mg1.{opt}.its"])}
    got = np.concatenate([r[f"mg.{opt}.x"].ravel() for r in ranks])
    want = np.concatenate([b.ravel() for b in blocks(one[f"mg1.{opt}.x"], n, pgrid)])
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


# ---------------------------------------------------------------------------
# the rest of the Krylov layer and the facade across ranks (the worker's
# krylov(): PIPECG in every spawn, the rest where a file runs `krylov`)
# ---------------------------------------------------------------------------


def _x_within(ranks, key, want, n, pgrid, tol):
    got = np.concatenate([rk[key].ravel() for rk in ranks])
    want = np.concatenate([b.ravel() for b in blocks(want, n, pgrid)])
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), key


def _krylov_matches_jax(dist_run, tag):
    """JAX's iteration count on every rank, the true residual within the
    method's limit, x within 1e-6 of JAX's x, and the monitored history
    within 1e-8 of JAX's (relative to its first entry)."""
    pgrid, n, ranks, ref = dist_run
    assert {int(rk[f"{tag}.its"]) for rk in ranks} == {ref[f"{tag}.its"]}
    for rk in ranks:
        assert float(rk[f"{tag}.rel"]) <= worker.KRYLOV[tag][1], tag
    _x_within(ranks, f"{tag}.x", ref[f"{tag}.x"], n, pgrid, 1e-6)
    k = ref[f"{tag}.its"] + 1
    want = ref[f"{tag}.hist"][:k]
    for rk in ranks:
        got = rk[f"{tag}.hist"][:k]
        assert np.abs(got - want).max() <= 1e-8 * want[0], tag


def test_pipecg_matches_jax(dist_run):
    _krylov_matches_jax(dist_run, "pipecg")


@pytest.mark.parametrize("tag", ("gmres", "gmresnone", "richardson"))
def test_krylov_matches_jax(dist_run, tag):
    """GMRES(30) + MG, GMRES -pc_type none (the sharded K2's partial dot
    in the Gram-Schmidt all-reduce) and Richardson + MG."""
    _krylov_matches_jax(dist_run, tag)


def test_fgmres_matches_one_rank(dist_run):
    """FGMRES(30) + MG across ranks (the JAX package has no FGMRES) against
    rank 0's one-rank solve of the same system: its iteration count on
    every rank, a true residual <= 1.01 rtol, x and the monitored history
    within 1e-10 of the one-rank ones (the sharded reductions sum in
    another order)."""
    pgrid, n, ranks, _ = dist_run
    one = ranks[0]
    assert {int(rk["fgmres.its"]) for rk in ranks} == {int(one["fgmres1.its"])}
    for rk in ranks:
        assert float(rk["fgmres.rel"]) <= 1.01e-8
    _x_within(ranks, "fgmres.x", one["fgmres1.x"], n, pgrid, 1e-10)
    k = int(one["fgmres1.its"]) + 1
    want = one["fgmres1.hist"][:k]
    for rk in ranks:
        assert np.abs(rk["fgmres.hist"][:k] - want).max() <= 1e-10 * want[0]


def test_solve_refined_matches_jax(dist_run):
    """The outer and inner counts of the JAX package's refinement on the
    same process grid, a true residual <= 1e-12, x within 1e-6."""
    pgrid, n, ranks, ref = dist_run
    for rk in ranks:
        assert list(rk["refine.counts"]) == ref["refine.counts"]
        assert float(rk["refine.rel"]) <= 1e-12
    _x_within(ranks, "refine.x", ref["refine.x"], n, pgrid, 1e-6)


def test_solve_checkpointed_matches_jax(dist_run):
    pgrid, n, ranks, ref = dist_run
    assert {int(rk["ckpt.total"]) for rk in ranks} == {ref["ckpt.total"]}
    for rk in ranks:
        assert float(rk["ckpt.rel"]) <= 1.01e-8
    _x_within(ranks, "ckpt.x", ref["ckpt.x"], n, pgrid, 1e-6)


def test_checkpoint_kill_and_resume_equals_uninterrupted(dist_run):
    """Killed after chunk 0, every rank's file holds its box and EVERY
    iterations; the resumed run starts from the saved iterate and ends
    with the uninterrupted run's total and x, bit for bit."""
    pgrid, n, ranks, _ = dist_run
    for rk, (_, (start, count)) in zip(ranks, sorted(owned_boxes((n,) * 3, pgrid).items())):
        assert list(rk["ckpt.saved"]) == [worker.EVERY, *start, *count]
        assert int(rk["ckpt.resumed.total"]) == int(rk["ckpt.total"])
        np.testing.assert_array_equal(rk["ckpt.resumed.x"], rk["ckpt.x"])
        assert float(rk["ckpt.resumed.r0"]) < 0.1


@pytest.mark.parametrize("case", ("foreign", "other"))
def test_checkpoint_starts_fresh_on_every_rank(dist_run, case):
    """A b that differs on rank 1 alone (one ulp), or a checkpoint written
    on another process grid of the same ranks: every rank starts fresh,
    its first monitored norm ||b||."""
    for rk in dist_run[2]:
        assert abs(float(rk[f"ckpt.{case}.r0"]) - 1.0) <= 1e-12


def test_restart_length_agreed_over_boxes(dist_run):
    """A basis budget just under 31 fields of the largest box: every rank
    takes the largest box's restart (29), where each rank's own block
    alone would give 29 or 30 (uneven boxes)."""
    pgrid, n, ranks, _ = dist_run
    boxes = [int(np.prod(c)) for _, (_, c) in sorted(owned_boxes((n,) * 3, pgrid).items())]
    for rk, cells in zip(ranks, boxes):
        agreed, alone = (int(v) for v in rk["clamp"])
        assert agreed == 29
        assert alone == (29 if cells == max(boxes) else 30)
