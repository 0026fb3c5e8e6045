"""One rank of a spawned gloo group on the CPU, for tests/test_torch_dist*.py.

    python tests/torch_dist_worker.py RANK WORLD PORT PX,PY,PZ N OUT_DIR [jacobi] [mgopts] [krylov] [n6=M]

It imports torch, numpy and poissbox_tpu_torch only (never jax), joins the
group over tcp://127.0.0.1:PORT, and writes OUT_DIR/rank{RANK}.npz: its
halo-padded block from the real exchange, the sharded operators' blocks
(the kernels' plain versions, the card's call graph), one V-cycle's block,
and an MG-CG solve to rtol 1e-8 (with the Jacobi smoother too when asked,
rank 0 then also solving the same system on one rank). With `mgopts`,
solves with other MG options (MG_OPTS), each beside rank 0's one-rank
solve. PIPECG + MG on the MG-CG system always; with `krylov`, the rest of
the Krylov layer and the facade (KRYLOV: GMRES(30) + MG, GMRES with
`-pc_type none`, Richardson + MG; FGMRES(30) + MG, which rank 0 also
solves on one rank; then solve_refined, solve_checkpointed
killed after chunk 0 and resumed, over a b that differs on rank 1 only
and over a checkpoint of another process grid, and the restart length
agreed over uneven boxes). With `n6=M`, at M^3: the compact operators across ranks (and each
rank's error from the one-rank operator), the FFT solves of both orders,
order 6 by CG + GMG, FCG + `-pc_type fft` and `-ksp_type fft`, order 2 by
`-ksp_type fft`, with the pencil counters of each operator and solve.
Always: the census of one MG-CG iteration (a window of 2 iterations less
one of 1) for each MG configuration of CENSUS_MG, and the largest gather
of the default one's 2-iteration solve.
The fields come from numpy seeds, so the test hands the same ones to the
JAX package. Every collective has a 120 s limit; a failure exits nonzero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from poissbox_tpu_torch import mesh  # noqa: E402
from poissbox_tpu_torch.api import PoissonSolver  # noqa: E402
from poissbox_tpu_torch.config import Options  # noqa: E402
from poissbox_tpu_torch.mesh import Grid3D, make_process_grid  # noqa: E402
from poissbox_tpu_torch.ops import compact_dist, compact_pcr  # noqa: E402
from poissbox_tpu_torch.parallel import dist_stencil as ds  # noqa: E402
from poissbox_tpu_torch.parallel import halo  # noqa: E402
from poissbox_tpu_torch.solvers import fft  # noqa: E402
from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner  # noqa: E402
from poissbox_tpu_torch.utils import census  # noqa: E402

W, WJ, ALPHA = 1.0, 0.8, 0.37
SOLVE = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8", "-ksp_max_it", "50"]
# MG options across ranks, each against the one-rank solve
MG_OPTS = {"w": ["-mg_cycle", "w"], "cycles2": ["-mg_cycles", "2"],
           "chebyshev": ["-mg_levels_ksp_type", "chebyshev"],
           "direct": ["-mg_coarse_pc_type", "direct"], "roll": ["-mg_impl", "roll"]}
# the other Krylov types on the MG-CG system: options, and the true
# residual each must reach (GMRES monitors ||M r||: 10 rtol)
MG = ["-pc_type", "mg", "-ksp_rtol", "1e-8", "-ksp_max_it", "50"]
KRYLOV = {"pipecg": (["-ksp_type", "pipecg"] + MG, 1.01e-8),
          "gmres": (["-ksp_type", "gmres", "-gmres_restart", "30"] + MG, 1e-7),
          "gmresnone": (["-ksp_type", "gmres", "-gmres_restart", "30", "-pc_type", "none",
                         "-ksp_rtol", "1e-5", "-ksp_max_it", "100"], 1e-4),
          "richardson": (["-ksp_type", "richardson"] + MG, 1.01e-8)}
# FGMRES, which the JAX package has not: held to rank 0's one-rank solve
FGMRES = ["-ksp_type", "fgmres", "-gmres_restart", "30"] + MG
OTHER_PGRID = {(2, 2, 1): (4, 1, 1), (3, 1, 1): (1, 3, 1)}   # same world, other boxes
EVERY = 2
# the MG configurations whose one-iteration census is held to the model
CENSUS_MG = {"v": [], "w": ["-mg_cycle", "w"], "jacobi": ["-mg_levels_pc_type", "jacobi"],
             "chebyshev": ["-mg_levels_ksp_type", "chebyshev"]}
# order 6 and the FFT: the Krylov solves to rtol 1e-8
SOLVES6 = {"cg6": (6, ["-ksp_type", "cg", "-pc_type", "mg"]),
           "fcg6": (6, ["-ksp_type", "fcg", "-pc_type", "fft"]),
           "kspfft6": (6, ["-ksp_type", "fft"]), "kspfft2": (2, ["-ksp_type", "fft"])}


def fields(n: int) -> dict:
    """The global inputs, from numpy seeds (the test makes the same)."""
    rng = np.random.default_rng(100 + n)
    f = {k: rng.standard_normal((n,) * 3) for k in ("u", "b", "p", "r", "ap")}
    u = np.random.default_rng(1).uniform(-1.0, 1.0, (n,) * 3)
    f["x_exact"] = u - u.mean()
    return f


def fields6(n: int) -> dict:
    """The order-6 inputs: random u and a random vertex field F (3
    components) for the operators, and the smooth manufactured solution
    of tests/test_fft.py:144-146 (the Krylov solves take b = A u of a
    smooth u: the Nyquist modes are in the operator's kernel)."""
    rng = np.random.default_rng(600 + n)
    f = {"u": rng.standard_normal((n,) * 3), "F": rng.standard_normal((n,) * 3 + (3,))}
    x = (np.arange(n) + 0.5) / n * 2.0 * np.pi
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    us = np.sin(X) * np.cos(2 * Y) + np.sin(3 * Z) + np.cos(X + Z)
    f["smooth"] = us - us.mean()
    return f


def _rel_box(got, one, g) -> float:
    """max |got - this rank's box of one| / max |one| (vector fields by
    component)."""
    want = (torch.stack([g.shard(one[..., k]) for k in range(3)], -1)
            if one.dim() == 4 else g.shard(one))
    return float((got - want).abs().max() / one.abs().max())


def order6(pgrid, n: int, out: dict) -> None:
    """The order-6 and FFT cases at n^3 (see the module docstring)."""
    g = Grid3D((n,) * 3, device="cpu", mesh=make_process_grid(pgrid))
    f = {k: torch.as_tensor(v) for k, v in fields6(n).items()}
    ub = g.shard(f["u"])
    Fb = torch.stack([g.shard(f["F"][..., k]) for k in range(3)], -1)
    calls = {"lapl": (lambda: compact_dist.lapl(ub, g),
                      lambda: compact_pcr.lapl(f["u"], g.deltas)),
             "grad": (lambda: compact_dist.grad(ub, g),
                      lambda: compact_pcr.grad(f["u"], g.deltas)),
             "div": (lambda: compact_dist.div(Fb, g),
                     lambda: compact_pcr.div(f["F"], g.deltas)),
             "interp": (lambda: compact_dist.interp(ub, g, +1),
                        lambda: compact_pcr.interp(f["u"], +1)),
             "fft2": (lambda: fft.poisson_solve_fft_dist(ub, g),
                      lambda: fft.poisson_solve_fft(f["u"], g.deltas)),
             "fft6": (lambda: fft.compact_poisson_solve_fft_dist(ub, g),
                      lambda: fft.compact_poisson_solve_fft(f["u"], g.deltas))}
    for name, (dist_fn, one_fn) in calls.items():
        halo.reset_counts()
        got = dist_fn()
        out[f"{name}.counts"] = np.array([halo.COUNTS[k] for k in
                                          ("alltoalls", "alltoall_bytes", "gathers")])
        out[name] = got.numpy()
        out[f"{name}.vs1"] = _rel_box(got, one_fn(), g)
    out["fft.route"] = fft.fft_route(g.n, pgrid)
    for tag, (order, argv) in SOLVES6.items():
        opts = Options(argv + ["-ksp_rtol", "1e-8", "-ksp_max_it", "200"])
        s = PoissonSolver((n,) * 3, options=opts, dtype=torch.float64, device="cpu",
                          order=order, shard=pgrid)
        b = s.rhs_for(g.shard(f["smooth"] if order == 6 else f["u"]))
        res = s.solve(b)
        out[f"{tag}.x"], out[f"{tag}.its"] = res.x.numpy(), int(res.iterations)
        out[f"{tag}.rel"] = s.residual_norm(res.x, b)
        out[f"{tag}.res"] = float(res.residual_norm)
        if g.mesh.rank == 0:   # the same system on one rank
            s1 = PoissonSolver((n,) * 3, options=opts, dtype=torch.float64,
                               device="cpu", order=order)
            b1 = s1.rhs_for(f["smooth"] if order == 6 else f["u"])
            r1 = s1.solve(b1)
            out[f"{tag}1.x"], out[f"{tag}1.its"] = r1.x.numpy(), int(r1.iterations)
            out[f"{tag}1.rel"] = s1.residual_norm(r1.x, b1)


def census_iteration(pgrid, n: int, f: dict, out: dict) -> None:
    """One MG-CG iteration's collectives on this rank, for each MG
    configuration of CENSUS_MG: census windows around solves of 1 and 2
    iterations (SOLVE's options), their difference as JSON records [op,
    bytes, dim, shape, ranks] beside the solver's resolved MGConfig; and
    the largest gather of the default configuration's 2-iteration solve."""
    for tag, opts in CENSUS_MG.items():
        windows = []
        for its in (1, 2):
            s = PoissonSolver((n,) * 3,
                              options=Options(SOLVE + opts + ["-ksp_max_it", str(its)]),
                              dtype=torch.float64, device="cpu", shard=pgrid)
            b = s.rhs_for(f["x_exact"])
            with census.recording() as rec:
                res = s.solve(b)
            if int(res.iterations) != its:
                raise AssertionError(f"census window: {int(res.iterations)} iterations, "
                                     f"asked for {its}")
            windows.append(rec)
        one = census.subtract(windows[1], windows[0])
        out[f"census.{tag}.iteration"] = json.dumps(
            [[c.op, c.bytes, c.dim, None if c.shape is None else list(c.shape), c.ranks]
             for c in one])
        out[f"census.{tag}.config"] = json.dumps(dataclasses.asdict(s._solver.M.config))
        if tag == "v":
            out["census.max_gather"] = census.max_gather_bytes(windows[1])


class Killed(Exception):
    pass


def _kill(chunk, result):
    raise Killed


def krylov(pgrid, n: int, f: dict, out_dir: str, extra, out: dict) -> None:
    """PIPECG (and with `krylov` the rest of KRYLOV and the facade) on the
    MG-CG system across ranks: each solve's block of x, iterations, true
    relative residual and monitored history."""
    from poissbox_tpu_torch import checkpoint
    from poissbox_tpu_torch.solvers.gmres import clamp_restart

    for tag, (argv, _) in KRYLOV.items():
        if tag != "pipecg" and "krylov" not in extra:
            continue
        s = PoissonSolver((n,) * 3, options=Options(argv), dtype=torch.float64,
                          device="cpu", shard=pgrid)
        b = s.rhs_for(f["x_exact"])
        res = s.solve(b)
        out[f"{tag}.x"], out[f"{tag}.its"] = res.x.numpy(), int(res.iterations)
        out[f"{tag}.rel"] = s.residual_norm(res.x, b)
        out[f"{tag}.hist"] = res.history.numpy()
    if "krylov" not in extra:
        return
    s = PoissonSolver((n,) * 3, options=Options(FGMRES), dtype=torch.float64, device="cpu",
                      shard=pgrid)
    b = s.rhs_for(f["x_exact"])
    res = s.solve(b)
    out["fgmres.x"], out["fgmres.its"] = res.x.numpy(), int(res.iterations)
    out["fgmres.rel"], out["fgmres.hist"] = s.residual_norm(res.x, b), res.history.numpy()
    if torch.distributed.get_rank() == 0:
        s1 = PoissonSolver((n,) * 3, options=Options(FGMRES), dtype=torch.float64, device="cpu")
        r1 = s1.solve(s1.rhs_for(torch.as_tensor(fields(n)["x_exact"])))
        out["fgmres1.x"], out["fgmres1.its"] = r1.x.numpy(), int(r1.iterations)
        out["fgmres1.hist"] = r1.history.numpy()
    s = PoissonSolver((n,) * 3, options=Options(SOLVE), dtype=torch.float64, device="cpu",
                      shard=pgrid)
    g, A = s.grid, s.A
    b = s.rhs_for(f["x_exact"])
    ref = s.solve_refined(b)
    out["refine.x"], out["refine.rel"] = ref.x.numpy(), s.residual_norm(ref.x, b)
    out["refine.counts"] = np.array([ref.outer_iterations, ref.inner_iterations])
    # the restart length over uneven boxes: a budget between the largest
    # box's 31 fields and the smallest's
    big = max(int(np.prod(c)) for _, c in
              (g.box_of(r) for r in range(g.mesh.size))) * 8
    out["clamp"] = np.array([clamp_restart(30, b, budget_bytes=31 * big - 1,
                                           allreduce_max=A.allreduce_max),
                             clamp_restart(30, b, budget_bytes=31 * big - 1)])

    # solve_checkpointed: uninterrupted, then killed after chunk 0 and resumed
    ck = os.path.join(out_dir, "ckpt")
    M = make_mg_preconditioner(g.n, g.deltas, MGConfig(), torch.float64, "cpu", grid=g)
    kw = dict(M=M, rtol=1e-8, max_it=50, every=EVERY, grid=g)
    full, total = s.solve_checkpointed(b, os.path.join(ck, "full"), rtol=1e-8, max_it=50,
                                       every=EVERY)
    out["ckpt.x"], out["ckpt.total"] = full.x.numpy(), total
    out["ckpt.rel"] = s.residual_norm(full.x, b)
    killed = os.path.join(ck, "killed")
    try:
        checkpoint.solve_with_checkpoints(A, b, killed, on_chunk=_kill, **kw)
        raise AssertionError("the kill hook did not fire")
    except Killed:
        pass
    saved = checkpoint.load(checkpoint.checkpoint_path(killed, g), device="cpu")
    out["ckpt.saved"] = np.array([int(saved["iterations"]), *saved["offset"].tolist(),
                                  *saved["shape"].tolist()])
    first = []
    on = lambda c, r: first.append(float(r.history[0])) if c == 0 else None
    res, total2 = checkpoint.solve_with_checkpoints(A, b, killed, on_chunk=on, **kw)
    out["ckpt.resumed.x"], out["ckpt.resumed.total"] = res.x.numpy(), total2
    bnorm = math.sqrt(float(A.allreduce(torch.sum(b * b).reshape(1))[0]))
    # a resumed run's first monitored norm is its saved iterate's residual,
    # a fresh run's is ||b|| (x0 = 0)
    out["ckpt.resumed.r0"] = first[0] / bnorm

    # a b that differs on rank 1 alone, one ulp in one element
    foreign = os.path.join(ck, "foreign")
    try:
        checkpoint.solve_with_checkpoints(A, b, foreign, on_chunk=_kill, **kw)
    except Killed:
        pass
    b2 = b.clone()
    if g.mesh.rank == 1:
        b2[0, 0, 0] = torch.nextafter(b2[0, 0, 0], torch.tensor(np.inf, dtype=b.dtype))
    first.clear()
    checkpoint.solve_with_checkpoints(A, b2, foreign, on_chunk=on, **kw)
    out["ckpt.foreign.r0"] = first[0] / math.sqrt(
        float(A.allreduce(torch.sum(b2 * b2).reshape(1))[0]))

    # a checkpoint written on another process grid of the same ranks
    other = os.path.join(ck, "other")
    so = PoissonSolver((n,) * 3, options=Options(SOLVE), dtype=torch.float64, device="cpu",
                       shard=OTHER_PGRID[tuple(pgrid)])
    Mo = make_mg_preconditioner(g.n, g.deltas, MGConfig(), torch.float64, "cpu",
                                grid=so.grid)
    try:
        checkpoint.solve_with_checkpoints(
            so.A, so.rhs_for(so.grid.shard(fields(n)["x_exact"])), other,
            **dict(kw, M=Mo, grid=so.grid, on_chunk=_kill))
    except Killed:
        pass
    first.clear()
    checkpoint.solve_with_checkpoints(A, b, other, on_chunk=on, **kw)
    out["ckpt.other.r0"] = first[0] / bnorm


def main(argv) -> int:
    rank, world, port = int(argv[0]), int(argv[1]), int(argv[2])
    pgrid = tuple(int(p) for p in argv[3].split(","))
    n, out_dir = int(argv[4]), argv[5]
    extra = argv[6:]
    torch.set_num_threads(1)
    mesh.init_process_group(f"tcp://127.0.0.1:{port}", world, rank, device="cpu",
                            timeout=120)
    g = Grid3D((n,) * 3, device="cpu", mesh=make_process_grid(pgrid))
    f = {k: g.shard(v) for k, v in fields(n).items()}
    out = {"dofs": np.array(g.dof_counts()), "offset": np.array(g.offset),
           "local_shape": np.array(g.local_shape)}
    out["pad"] = halo.halo_pad_local(f["u"], g.mesh, 1).numpy()
    ops = {
        "apply": lambda: ds.apply_laplacian_sharded(f["u"], g, local_impl="cuda"),
        "apply_padded": lambda: ds.apply_laplacian_sharded(f["u"], g, overlap=False),
        "residual": lambda: ds.residual_sharded(f["u"], f["b"], g, local_impl="cuda"),
        "jacobi": lambda: ds.jacobi_sweep_sharded(f["u"], f["b"], g, WJ,
                                                  local_impl="cuda"),
        "sor0": lambda: ds.sor_sweep_sharded(f["u"], f["b"], g, W, 0, local_impl="cuda"),
        "sor1": lambda: ds.sor_sweep_sharded(f["u"], f["b"], g, W, 1, local_impl="cuda"),
    }
    for name, fn in ops.items():
        out[name] = fn().numpy()
    y, dot = ds.apply_laplacian_dot_sharded(f["u"], g, local_impl="cuda")
    out["apply_dot"], out["apply_dot.dot"] = y.numpy(), float(dot)
    xo, ro, rr, sr = ds.cg_fused_update_sharded(ALPHA, f["u"], f["p"], f["r"],
                                                f["ap"], g, local_impl="cuda")
    out["cgupd.x"], out["cgupd.r"] = xo.numpy(), ro.numpy()
    out["cgupd.rr"], out["cgupd.sr"] = float(rr), float(sr)
    # one V-cycle of the default configuration on the kernels' plain versions
    M = make_mg_preconditioner(g.n, g.deltas, MGConfig(impl="cuda"), torch.float64,
                               "cpu", grid=g)
    out["vcycle"] = M(f["b"]).numpy()
    out["levels_dist"] = np.array([lv.grid is not None for lv in M.levels])
    for tag, opts in (("sor", []), ("jacobi", ["-mg_levels_pc_type", "jacobi"])):
        if tag == "jacobi" and "jacobi" not in extra:
            continue
        s = PoissonSolver((n,) * 3, options=Options(SOLVE + opts), dtype=torch.float64,
                          device="cpu", shard=pgrid)
        b = s.rhs_for(f["x_exact"])
        res = s.solve(b)
        out[f"{tag}.x"] = res.x.numpy()
        out[f"{tag}.its"] = int(res.iterations)
        out[f"{tag}.rel"] = s.residual_norm(res.x, b)
    if "mgopts" in extra:
        for tag, opts in MG_OPTS.items():
            s = PoissonSolver((n,) * 3, options=Options(SOLVE + opts), dtype=torch.float64,
                              device="cpu", shard=pgrid)
            res = s.solve(s.rhs_for(f["x_exact"]))
            out[f"mg.{tag}.x"], out[f"mg.{tag}.its"] = res.x.numpy(), int(res.iterations)
            if rank == 0:
                s1 = PoissonSolver((n,) * 3, options=Options(SOLVE + opts),
                                   dtype=torch.float64, device="cpu")
                r1 = s1.solve(s1.rhs_for(torch.as_tensor(fields(n)["x_exact"])))
                out[f"mg1.{tag}.x"], out[f"mg1.{tag}.its"] = r1.x.numpy(), int(r1.iterations)
    krylov(pgrid, n, f, out_dir, extra, out)
    census_iteration(pgrid, n, f, out)
    n6 = next((int(a[3:]) for a in extra if a.startswith("n6=")), None)
    if n6:
        order6(pgrid, n6, out)
    if "jacobi" in extra and rank == 0:
        # the same system on one rank (the process group plays no part)
        s1 = PoissonSolver((n,) * 3, options=Options(SOLVE + ["-mg_levels_pc_type", "jacobi"]),
                           dtype=torch.float64, device="cpu")
        res = s1.solve(s1.rhs_for(torch.as_tensor(fields(n)["x_exact"])))
        out["jacobi1.x"], out["jacobi1.its"] = res.x.numpy(), int(res.iterations)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
