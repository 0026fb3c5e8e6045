"""One rank of a spawned gloo group on the CPU, for tests/test_torch_dist*.py.

    python tests/torch_dist_worker.py RANK WORLD PORT PX,PY,PZ N OUT_DIR [jacobi] [mgopts] [n6=M]

It imports torch, numpy and poissbox_tpu_torch only (never jax), joins the
group over tcp://127.0.0.1:PORT, and writes OUT_DIR/rank{RANK}.npz: its
halo-padded block from the real exchange, the sharded operators' blocks
(the kernels' plain versions, the card's call graph), one V-cycle's block,
and an MG-CG solve to rtol 1e-8 (with the Jacobi smoother too when asked,
rank 0 then also solving the same system on one rank). With `mgopts`,
solves with other MG options (MG_OPTS), each beside rank 0's one-rank
solve. With `n6=M`, at M^3: the compact operators across ranks (and each
rank's error from the one-rank operator), the FFT solves of both orders,
order 6 by CG + GMG, FCG + `-pc_type fft` and `-ksp_type fft`, order 2 by
`-ksp_type fft`, with the pencil counters of each operator and solve.
The fields come from numpy seeds, so the test hands the same ones to the
JAX package. Every collective has a 120 s limit; a failure exits nonzero.
"""

from __future__ import annotations

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

W, WJ, ALPHA = 1.0, 0.8, 0.37
SOLVE = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8", "-ksp_max_it", "50"]
# MG options across ranks, each against the one-rank solve
MG_OPTS = {"w": ["-mg_cycle", "w"], "cycles2": ["-mg_cycles", "2"],
           "chebyshev": ["-mg_levels_ksp_type", "chebyshev"],
           "direct": ["-mg_coarse_pc_type", "direct"], "roll": ["-mg_impl", "roll"]}
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
