#!/usr/bin/env python3
"""A torch.profiler breakdown of rank 0 of the distributed MG-CG solve on
GPUs: path (m)'s headline case of chip_smoke.py, 512^3 f32 to rtol 1e-6
with the default cycle on the process grid (2, 2, 1), b = A u for u
uniform(-1, 1) from numpy seed 1 with its mean removed.

The script spawns one process a rank (``--rank``), over NCCL with one rank
a card when there are as many cards as ranks, else over gloo with the ranks
sharing card 0 (faces staged through the host: the kernel and mask shares
only, not a speed). Every rank builds the solver, takes b, solves once
(the iterations), then three warm solves (the slowest rank's wall, median),
one counted solve (rank 0's exchanges, face bytes, all-reduces and kernel
launches) and one solve that rank 0 profiles. Its device time is grouped
by kernel (NCCL's, K11 in f32 and in bf16, KB, K6, K7, KA, K8, the y/z
contractions, the rest), and the correction form's own work is annotated:
the split faces' red-black masks (``dist_stencil._face_color_masks``), the
pre-smooth's first-colour mask (``uneven.color_mask`` as ``mg`` calls it)
and the face differences and corrections (``dist_stencil._diffs``,
``_apply_corrections``), each with the device time of the kernels it
launched. "busy" is rank 0's device time outside NCCL's kernels over the
warm wall.

It uses only the package's public solver and its module-level helpers, so
the same file profiles another checkout: copy it into that checkout's root
and run it from there.

    python3 rank_profile.py
    python3 rank_profile.py --n 32 --device cpu   # a rehearsal: gloo, CPU,
                                                  # the kernels' plain versions

The last line of standard output is one JSON object with the card's name
and power limit and the numbers above.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PGRID = (2, 2, 1)
TIMEOUT = 600.0
# kernel name -> group (first match wins; K11 before KB, both rbsor.cu).
# NCCL's kernels run for as long as a transfer waits for its peer, so they
# are kept apart from the busy share.
GROUPS = (("NCCL", ("nccl",)),
          ("K11 bf16", ("colour_kernel<__nv_bfloat16",)), ("K11 f32", ("colour_kernel",)),
          ("KB", ("sweep_kernel",)), ("K6", ("restrict_kernel",)),
          ("K7", ("prolong_add_kernel",)), ("KA", ("stencil7_kernel",)), ("K8", ("cgupd",)),
          ("contractions", ("gemm", "cutlass", "xmma", "sm90")))
# annotated functions: (module attribute path, label)
SPANS = (("dist_stencil._face_color_masks", "face masks"),
         ("mg.color_mask", "first-colour mask"),
         ("dist_stencil._diffs", "face differences"),
         ("dist_stencil._apply_corrections", "face corrections"))


def _annotate(modules: dict) -> None:
    """Wrap each function of SPANS in a record_function span of its label."""
    for path, label in SPANS:
        mod, name = path.split(".")
        fn = getattr(modules[mod], name)

        @functools.wraps(fn)
        def spanned(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(f"poissbox::{_label}"):
                return _fn(*a, **k)

        setattr(modules[mod], name, spanned)


def rank_main(spec_path: str, rank: int) -> int:
    import torch.distributed as dist

    from poissbox_tpu_torch import mesh
    from poissbox_tpu_torch.api import PoissonSolver
    from poissbox_tpu_torch.config import Options
    from poissbox_tpu_torch.ops import stencil_cuda as sc
    from poissbox_tpu_torch.parallel import dist_stencil, halo
    from poissbox_tpu_torch.solvers import mg
    from poissbox_tpu_torch.utils import profiling

    spec = json.loads(open(spec_path).read())
    world = spec["world"]
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    n, device = spec["n"], spec["device"]
    mesh.init_process_group(f"tcp://127.0.0.1:{spec['port']}", world, rank,
                            backend=spec["backend"], device=device, timeout=TIMEOUT)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-6", "-ksp_max_it", "50"]
    solver = PoissonSolver((n,) * 3, options=Options(argv), dtype=torch.float32,
                           device=device, shard=PGRID)
    g = solver.grid
    b = solver.rhs_for(g.shard(np.load(spec["u"], mmap_mode="r")))
    res = solver.solve(b)
    its = int(res.iterations)
    rel = solver.residual_norm(res.x, b)

    def timed_solve() -> float:
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        solver.solve(b)
        sync()
        wall = torch.tensor([(time.perf_counter() - t0) * 1e3], dtype=torch.float64,
                            device=g.device)
        return float(halo.allreduce_max(wall, g.mesh))

    walls = [timed_solve() for _ in range(3)]
    dist.barrier()
    sc.reset_launches()
    halo.reset_counts()
    solver.solve(b)
    sync()
    launches = {k: v for k, v in sc.LAUNCHES.items() if v}
    counts = dict(halo.COUNTS)
    _annotate({"dist_stencil": dist_stencil, "mg": mg})
    dist.barrier()
    if rank == 0:
        with profiling.trace() as prof:
            t0 = time.perf_counter()
            solver.solve(b)
            sync()
            prof_wall = (time.perf_counter() - t0) * 1e3
    else:
        solver.solve(b)
        sync()
    dist.barrier()
    if rank == 0:
        groups = {name: 0.0 for name, _ in GROUPS}
        groups["elementwise and other"] = 0.0
        calls = {name: 0 for name in groups}
        spans = {label: 0.0 for _, label in SPANS}
        labels = {f"poissbox::{label}": label for _, label in SPANS}
        kernels = 0
        for evt in prof.key_averages():
            if evt.key in labels:
                if evt.device_type == torch.autograd.DeviceType.CPU:
                    spans[labels[evt.key]] += float(getattr(
                        evt, "device_time_total", getattr(evt, "cuda_time_total", 0.0))) / 1e3
                continue
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = next((float(getattr(evt, a)) for a in (
                "self_device_time_total", "self_cuda_time_total", "device_time_total",
                "cuda_time_total") if getattr(evt, a, 0)), 0.0)
            grp = next((name for name, keys in GROUPS if any(k in evt.key for k in keys)),
                       "elementwise and other")
            groups[grp] += us / 1e3
            calls[grp] += int(evt.count)
            kernels += int(evt.count)
        dev_ms = sum(groups.values())
        compute_ms = dev_ms - groups["NCCL"]
        warm = statistics.median(walls)
        smi = "cpu" if device == "cpu" else subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().replace("\n", "; ")
        out = {"device": smi, "backend": dist.get_backend(), "n": n, "pgrid": list(PGRID),
               "local_shape": list(g.local_shape), "its": its, "rel": rel,
               "warm_ms": warm, "walls_ms": walls, "profiled_wall_ms": prof_wall,
               "device_ms": dev_ms, "compute_ms": compute_ms, "busy": compute_ms / warm,
               "kernels": kernels,
               "groups_ms": groups, "group_calls": calls, "spans_ms": spans,
               "launches_rank0": launches, "halo_rank0": counts}
        with open(spec["out"], "w") as fh:
            json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.spec, args.rank)
    world = int(np.prod(PGRID))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("rank_profile: torch.cuda.is_available() is False")
        from poissbox_tpu_torch.ops import _build
        _build.load()            # once here; the ranks load the cached library
    backend = "nccl" if args.device == "cuda" and torch.cuda.device_count() >= world else "gloo"
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        u = np.random.default_rng(1).uniform(-1.0, 1.0, (args.n,) * 3)
        u -= u.mean()
        upath = os.path.join(tmp, "u.npy")
        np.save(upath, u.astype(np.float32))
        del u
        spec = os.path.join(tmp, "spec.json")
        out = os.path.join(tmp, "out.json")
        with open(spec, "w") as fh:
            json.dump({"world": world, "port": _free_port(), "backend": backend,
                       "n": args.n, "device": args.device, "u": upath, "out": out}, fh)
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--spec", spec], cwd=here, stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(world)]
        deadline = time.perf_counter() + TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            for r in bad[:2]:
                logs[r].seek(0)
                print(f"rank {r}:\n" + logs[r].read()[-4000:], flush=True)
            raise SystemExit(f"rank_profile: ranks {bad} failed")
        with open(out) as fh:
            res = json.load(fh)
    print(f"  rank 0 of {world} over {res['backend']}, {args.n}^3 f32 on {PGRID} (block "
          f"{tuple(res['local_shape'])}): {res['its']} iterations, relative residual "
          f"{res['rel']:.3e}; warm wall {res['warm_ms']:.2f} ms (slowest rank, median of 3: "
          f"{', '.join(f'{w:.2f}' for w in res['walls_ms'])}); profiled {res['kernels']} "
          f"kernels, {res['device_ms']:.2f} ms device, {res['compute_ms']:.2f} outside NCCL's "
          f"kernels, busy {100 * res['busy']:.1f} %")
    print("  device ms by group: " + ", ".join(
        f"{k} {v:.3f} ({res['group_calls'][k]})" for k, v in res["groups_ms"].items()))
    print("  annotated (device ms of the kernels launched inside): " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["spans_ms"].items()))
    print(f"  rank 0, one warm solve: halo {res['halo_rank0']}; launches "
          f"{res['launches_rank0']} ({res['device']})", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
