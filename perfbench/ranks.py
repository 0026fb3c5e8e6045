#!/usr/bin/env python3
"""One run of a cell on more than one card: one process a rank.

``run.py`` hands a cell whose "chips" is over 1 to :func:`main`. The
process that prints the result (the parent, :func:`launch`) picks a free
TCP port on localhost and starts one child a rank, this file with the
run's spec (``python3 perfbench/ranks.py <spec>``), with RANK, WORLD_SIZE,
LOCAL_RANK and LOCAL_WORLD_SIZE set: each child takes the card of its
local rank (``mesh.rank_device``). The parent waits for all of them. If
one exits non-zero, or the time limit passes, it ends every child, prints
no result and exits non-zero; a child ends with its parent. Rank 0 hands
its result to the parent over a pipe, and the parent prints it as the
last line of standard output.

Each child (:func:`worker`): ``mesh.init_process_group`` (the
configuration's backend, NCCL, on the cards; gloo on the CPU, for the
tests); ``PoissonSolver(..., shard=<the configuration's pgrid>)``; its
block of each right-hand side of the pool (``pool.py`` draws the global b
from the seed as a one-card run does, and the rank keeps its box); two
warm solves; then ``run.Run``'s closed loop. Every rank runs the same
solves: after each one rank 0 decides whether the window has ended and
broadcasts the decision, and each rank times that decision. With
``--trace 1`` the traffic file's "trace_solves" solves run untraced on
every rank (the slowest rank's wall), then under torch.profiler on every
rank; rank 0's trace gives the breakdown and the per-layer metrics.

After the window every rank reads its memory peak and frees the program
and its pool, and sends the solution blocks the judge samples to rank 0,
which places each by the program's box of that rank (``Grid3D.box_of``)
and judges the whole field with ``judge.judge_solve``, b the global
right-hand side made again from the seed.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and sys.path[0] and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)               # the script's folder: its module names are not top-level
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import cells, judge  # noqa: E402
from perfbench import run as harness  # noqa: E402

# seconds a collective may wait before it raises, and the parent's limit
# on a whole run (a checkout's first run builds the kernel library)
COLLECTIVE_TIMEOUT = 300.0
RUN_TIMEOUT = 1100.0
# torch's threads a rank: four ranks share the host's cores (one on the
# CPU, where the tests run four ranks at once)
THREADS = {"cuda": 2, "cpu": 1}
# NCCL's kernels spin while a rank waits for the others: not busy
NCCL = "nccl"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the child, before it runs: SIGKILL when the parent dies
    (prctl PR_SET_PDEATHSIG), so no rank outlives a parent that was
    killed."""
    import ctypes
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


class Launch(NamedTuple):
    """A finished launch: the exit code (0 when every rank exited 0),
    rank 0's result (None unless the code is 0), and the children's
    process ids."""

    rc: int
    result: Optional[dict]
    pids: list[int]


def _end(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _wait(procs, deadline: float) -> int:
    """0 once every child exited 0; the first non-zero code (1 at the
    time limit) as soon as one fails, with every child ended."""
    while True:
        codes = [p.poll() for p in procs]
        bad = next((c for c in codes if c not in (None, 0)), None)
        if bad is not None or time.time() > deadline:
            _end(procs)
            return bad if bad is not None else 1
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.05)


def launch(cell: dict, seed: int, seconds: float, trace: bool, device: str,
           t_start: float, metrics: list[dict] = (), fault: str | None = None) -> Launch:
    """Start one child a rank for `cell` and wait for all of them. Rank 0
    reports `metrics` (the manifest's entries of this cell and kind of
    run); `fault` is planted in every rank (``faults.planted``)."""
    world = int(cell["chips"])
    read_end, write_end = os.pipe()
    spec = {"cell": cell, "seed": int(seed), "seconds": float(seconds), "trace": bool(trace),
            "device": device, "t_start": float(t_start), "port": free_port(),
            "result_fd": write_end, "metrics": list(metrics), "fault": fault}
    procs, chunks = [], []
    reader = threading.Thread(target=_drain, args=(read_end, chunks), daemon=True)
    term = signal.getsignal(signal.SIGTERM)
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        try:
            for rank in range(world):
                env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
                procs.append(subprocess.Popen(
                    [sys.executable, str(HERE / "ranks.py"), json.dumps(spec)], cwd=ROOT,
                    env=env, pass_fds=(write_end,) if rank == 0 else (),
                    preexec_fn=_die_with_parent))
        finally:
            os.close(write_end)     # the pipe ends when rank 0 closes its copy
        reader.start()
        rc = _wait(procs, time.time() + RUN_TIMEOUT)
    finally:
        _end(procs)
        if on_main:
            signal.signal(signal.SIGTERM, term)
        if reader.ident is None:
            os.close(read_end)
    reader.join(timeout=60.0)
    text = b"".join(chunks).decode()
    result = json.loads(text) if rc == 0 and text else None
    if rc == 0 and result is None:
        rc = 1
    return Launch(rc, result, [p.pid for p in procs])


def _drain(fd: int, chunks: list) -> None:
    with os.fdopen(fd, "rb") as fh:
        chunks.append(fh.read())


def main(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
         device: str = "cuda", man: dict | None = None) -> int:
    """The parent's part of ``run.py``: launch on the cards (the CPU for
    the tests), then print rank 0's result last, with the metrics that
    the manifest (`man`, by default ``BENCHMARK.json``) gives the cell."""
    metrics = cells.metrics_for(cell["name"], cells.manifest() if man is None else man, trace)
    out = launch(cell, seed, seconds, trace, device, t_start, metrics)
    if out.rc != 0:
        print(f"perfbench: a rank of cell {cell['name']} failed (exit {out.rc}); no result",
              file=sys.stderr)
        return out.rc
    harness.refuse_forbidden()
    harness.emit(out.result)
    return 0


class RankRun(harness.Run):
    """One rank's set-up, windows and share of the judging; ``Run``'s
    loop, timed solve and memory reading, over a process group."""

    def __init__(self, spec: dict, rank: int, world: int):
        cell = spec["cell"]
        self.cell, self.seed, self.rank, self.world = cell, spec["seed"], rank, world
        self.spec = cell["config_spec"]
        self.parts: dict[str, float] = {}
        t = time.time()
        import torch
        import torch.distributed as dist
        from poissbox_tpu_torch import mesh
        from poissbox_tpu_torch.api import PoissonSolver
        from poissbox_tpu_torch.config import Options
        self.torch, self.dist = torch, dist
        torch.set_num_threads(THREADS[spec["device"]])
        self.parts["import_s"] = time.time() - t
        t = time.time()
        self.cuda = spec["device"] == "cuda"
        mesh.init_process_group(f"tcp://127.0.0.1:{spec['port']}", world, rank,
                                backend=self.spec["backend"] if self.cuda else "gloo",
                                device=spec["device"], timeout=COLLECTIVE_TIMEOUT)
        self.device = mesh.rank_device(spec["device"])
        torch.empty(1, device=self.device)
        self.sync()
        self.parts["device_s"] = time.time() - t
        t = time.time()
        if self.cuda:
            # rank 0 builds the library on a checkout's first run, the
            # others load what it built
            from poissbox_tpu_torch.ops import _build
            if rank == 0:
                _build.load()
            dist.barrier()
            if rank != 0:
                _build.load()
        self.parts["library_s"] = time.time() - t
        argv = list(self.spec["argv"])
        if "rtol" in cell:
            argv += ["-ksp_rtol", repr(cell["rtol"])]
        t = time.time()
        self.solver = PoissonSolver(
            tuple(cell["grid"]), tuple(cell["length"]), options=Options(argv),
            dtype=getattr(torch, cell["dtype"]), device=self.device, order=self.spec["order"],
            shard=tuple(self.spec["pgrid"]))
        self.grid = self.solver.grid
        self.sync()
        self.parts["build_s"] = time.time() - t
        t = time.time()
        from perfbench import pool
        self.deltas = pool.deltas(cell["grid"], cell["length"])
        self.pool = [self.grid.shard(b) for b in pool.right_hand_sides(cell, self.seed,
                                                                         self.device)]
        self.sync()
        self.parts["pool_s"] = time.time() - t
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        for j in range(harness.WARM_SOLVES):
            self.solver.solve(self.pool[j % len(self.pool)])
            self.sync()
        self.parts["warm_s"] = time.time() - t
        self.ready = time.time()
        self.mg = self._mg_view()
        from poissbox_tpu_torch.solvers import ksp
        inner = self.solver._solver
        self.view = ksp.view(inner.opts, inner.shape, inner.M).replace("\n", "; ")
        self.flag = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.decisions, self.decide_s = 0, 0.0

    def decide(self, stop: bool) -> bool:
        """Rank 0's `stop`, on every rank (a broadcast between solves)."""
        t = time.perf_counter()
        self.flag.fill_(int(stop) if self.rank == 0 else 0)
        self.dist.broadcast(self.flag, 0)
        out = bool(self.flag.item())
        self.decide_s += time.perf_counter() - t
        self.decisions += 1
        return out

    def window(self, seconds: float) -> dict:
        return self.loop(lambda _, elapsed: self.decide(elapsed >= seconds))

    def traced_window(self) -> tuple[dict, object]:
        """The traffic file's "trace_solves" solves untraced on every rank,
        then under torch.profiler on every rank, with the face exchanges
        of the traced ones counted."""
        from perfbench import devtrace
        from poissbox_tpu_torch.parallel import halo
        stop = lambda solves, _: solves >= self.cell["trace_solves"]  # noqa: E731
        untraced = self.loop(stop, keep=False)["wall_s"]
        halo.reset_counts()
        with devtrace.traced() as prof:
            out = self.loop(stop)
        out["exchanges"] = int(halo.COUNTS["exchanges"])
        out["untraced_wall_s"] = untraced
        return out, prof

    def free_program(self) -> None:
        self.pool = None             # the judge draws b again
        super().free_program()

    def gathered(self, x):
        """The global field of every rank's block `x`, on rank 0 (each
        block placed by the program's box of its rank); None elsewhere."""
        if self.rank != 0:
            self.dist.send(x.contiguous(), 0)
            return None
        full = self.torch.empty(tuple(self.cell["grid"]), dtype=x.dtype, device=x.device)
        for r in range(self.world):
            (xs, ys, zs), (xn, yn, zn) = self.grid.box_of(r)
            if r == 0:
                part = x
            else:
                part = self.torch.empty((xn, yn, zn), dtype=x.dtype, device=x.device)
                self.dist.recv(part, r)
            full[xs:xs + xn, ys:ys + yn, zs:zs + zn] = part
        return full

    def judged(self, kept: dict) -> list[dict]:
        """The reference's numbers of every kept solve, on rank 0 (an
        empty list elsewhere): each solution gathered, b made again from
        the seed in pool order."""
        from perfbench import pool
        rhs = pool.right_hand_sides(self.cell, self.seed, self.device) if self.rank == 0 else None
        out, made, b = [], 0, None
        for slot, (_, (x, reported)) in sorted(kept.items()):
            full = self.gathered(x)
            if full is None:
                continue
            while made <= slot:
                b = next(rhs)
                made += 1
            out.append(judge.judge_solve(self.spec["order"], full, reported, b, self.deltas,
                                         self.cell["limits"]))
            del full
        return out


def _trace_summary(prof) -> tuple[dict, float]:
    """A rank's kernel table and its device seconds outside NCCL."""
    from perfbench import devtrace
    table = devtrace.kernel_table(prof)
    return table, sum(s for name, (_, s) in table.items() if NCCL not in name.lower())


def worker(spec: dict) -> int:
    """One rank of a run; rank 0 writes the result to the parent's pipe."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if spec["device"] == "cuda":
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            print(f"perfbench: rank {rank} of {world} found {have} CUDA cards", file=sys.stderr)
            return 2
    if spec.get("fault"):
        from perfbench import faults
        with faults.planted(spec["fault"]):
            result = _rank(spec, rank, world)
    else:
        result = _rank(spec, rank, world)
    if rank == 0:
        with os.fdopen(spec["result_fd"], "w") as fh:
            fh.write(json.dumps(result))
    return 0


def _rank(spec: dict, rank: int, world: int):
    """Set-up, the window and the judging of one rank; rank 0's result."""
    cell = spec["cell"]
    run = RankRun(spec, rank, world)
    lead = rank == 0
    if lead:
        for k, v in run.parts.items():
            print(f"setup {k} {v:.6f}", flush=True)
        print(f"solver {run.view}", flush=True)
        levels = getattr(getattr(run.solver._solver, "M", None), "levels", [])
        print(f"mg {json.dumps(run.mg)} distributed {[lvl.grid is not None for lvl in levels]}",
              flush=True)
    prof = None
    if spec["trace"]:
        win, prof = run.traced_window()
    else:
        win = run.window(spec["seconds"])
    harness.refuse_forbidden()
    torch, dist = run.torch, run.dist
    mine = {"peak": run.memory_peak(), "ready": run.ready, "wall_s": win["wall_s"],
            "untraced_wall_s": win.get("untraced_wall_s"), "solves": win["solves"],
            "decide_ms": 1e3 * run.decide_s / max(1, run.decisions)}
    table = None
    if prof is not None:
        table, mine["busy_s"] = _trace_summary(prof)
        if lead:
            from perfbench import devtrace
            gaps = devtrace.idle_gaps(prof)
        del prof
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    if len({r["solves"] for r in ranks}) != 1:
        raise RuntimeError(f"the ranks ran different numbers of solves: {ranks}")
    kept = win.pop("kept")
    run.free_program()
    judged = run.judged(kept)
    del kept
    run.sync()
    if not lead:
        dist.destroy_process_group()
        return None
    setup_s = max(r["ready"] for r in ranks) - spec["t_start"]
    print(f"setup setup_s {setup_s:.6f}", flush=True)
    q = statistics.quantiles(win["solve_ms"], n=4) if len(win["solve_ms"]) > 1 else [0.0] * 3
    print(f"window decide_ms {mine['decide_ms']:.6f} per solve, mean solve "
          f"{1e3 * win['wall_s'] / win['solves']:.6f} ms, rank 0's solves by CUDA events "
          f"quartiles {q[0]:.3f} {q[1]:.3f} {q[2]:.3f} max {max(win['solve_ms']):.3f} ms", flush=True)
    record = {"cell": cell["name"], "grid": cell["grid"], "order": run.spec["order"],
              "itemsize": {"float32": 4, "float64": 8}[cell["dtype"]],
              "setup_s": setup_s, "setup": dict(run.parts), "mg": run.mg,
              "window": {"wall_s": win["wall_s"], "solves": win["solves"],
                         "solve_ms": win["solve_ms"]},
              "iterations": win["its"]}
    breakdown = None
    if table is not None:
        from perfbench import devtrace
        record["exchanges"] = win["exchanges"]
        record["trace"] = dict(devtrace.summarise(table), wall_s=win["wall_s"],
                               untraced_wall_s=max(r["untraced_wall_s"] for r in ranks),
                               outside_nccl_s=mine["busy_s"], table=table)
        breakdown = {"device_ops": devtrace.top_ops(table), "idle_gaps": gaps}
    checks = judge.numbers(judged, win["reasons"], cell["limits"])
    metrics = cells.read_metrics(spec["metrics"], record)
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
           "count": world, "memory_peak_bytes": max(r["peak"] for r in ranks)}
    if table is not None:
        dev["busy_s"] = sum(r["busy_s"] for r in ranks) / world
        dev["window_s"] = win["wall_s"]
    result = {"correct": judge.passed(checks), "attempted": win["solves"],
              "failed": judge.failed_count(judged, win["reasons"], cell["limits"]),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    dist.destroy_process_group()
    return result


if __name__ == "__main__":
    sys.exit(worker(json.loads(sys.argv[1])))
