#!/usr/bin/env python3
"""Run one cell of the benchmark of poissbox_tpu_torch once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s workloads; ``perfbench/workloads/<traffic>.json``)
is a configuration (``perfbench/configs/<config>.json``: operator order,
solver options, dtype) under a closed loop of solves on one card: the
caller of a time-stepping simulation, which hands the solver one
right-hand side a step and waits for the solution. Set-up makes a pool
of right-hand sides on the device from the seed (``pool.py``), builds
``PoissonSolver`` and solves twice; then the window solves the pool's
right-hand sides in turn, each solve from a zero guess, timed by CUDA
events and ending synchronised, for ``--seconds`` seconds
(``--trace 0``), or a fixed number of them (the traffic file's
"trace_solves") untraced and then under torch.profiler (``--trace 1``).

After the window the program's state is freed and ``judge.py`` decides
``correct`` against the plain reference (``reference/``). The last line of
standard output is one JSON object: ``correct``, ``attempted`` (solves),
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, each read by
``perfbench/metrics/<name>.py``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, the numbers compared beside their
limits (also the last lines of standard error). Set-up's parts are
printed on earlier lines.

A cell on more than one card runs one process a rank (``ranks.py``); this
process starts them, without importing torch itself, and prints rank 0's
result.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2. If JAX or the JAX package has been imported by
the time the window closes, it exits with 3.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and sys.path[0] and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)               # the script's folder: its module names are not top-level
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache at a fixed path inside the checkout (the
# program's nvcc library is built in poissbox_tpu_torch/_build/)
CACHE = ROOT / "_perfbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "poissbox_tpu")
WARM_SOLVES = 2

from perfbench import cells, judge  # noqa: E402


def forbidden_modules() -> list[str]:
    """Imported modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def refuse_forbidden() -> None:
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules imported: {', '.join(bad)}", file=sys.stderr)
        sys.exit(3)


def emit(result: dict) -> None:
    """Checks as the last lines of standard error, the result as the last
    line of standard output, its "checks" key last."""
    judge.print_checks(result["checks"])
    result = dict(result)
    result["checks"] = result.pop("checks")
    print(json.dumps(result), flush=True)


class Run:
    """One run's set-up, windows and judging, on one card (or the CPU,
    for the tests)."""

    def __init__(self, cell: dict, seed: int, device: str):
        self.cell, self.seed = cell, seed
        self.spec = cell["config_spec"]
        self.parts: dict[str, float] = {}
        t = time.time()
        import torch
        from poissbox_tpu_torch.api import PoissonSolver
        from poissbox_tpu_torch.config import Options
        self.torch = torch
        self.parts["import_s"] = time.time() - t
        t = time.time()
        self.cuda = device == "cuda"
        if self.cuda:
            torch.cuda.init()
            self.device = torch.device("cuda", torch.cuda.current_device())
            torch.empty(1, device=self.device)
            torch.cuda.synchronize()
        else:
            self.device = torch.device(device)
        self.parts["device_s"] = time.time() - t
        t = time.time()
        if self.cuda:
            from poissbox_tpu_torch.ops import _build
            _build.load()
        self.parts["library_s"] = time.time() - t
        argv = list(self.spec["argv"])
        if "rtol" in cell:
            argv += ["-ksp_rtol", repr(cell["rtol"])]
        t = time.time()
        self.solver = PoissonSolver(
            tuple(cell["grid"]), tuple(cell["length"]), options=Options(argv),
            dtype=getattr(torch, cell["dtype"]), device=device, order=self.spec["order"])
        self.sync()
        self.parts["build_s"] = time.time() - t
        t = time.time()
        from perfbench import pool
        self.deltas = pool.deltas(cell["grid"], cell["length"])
        self.pool = list(pool.right_hand_sides(cell, seed, self.device))
        self.sync()
        self.parts["pool_s"] = time.time() - t
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        for j in range(WARM_SOLVES):
            self.solver.solve(self.pool[j % len(self.pool)])
            self.sync()
        self.parts["warm_s"] = time.time() - t
        self.mg = self._mg_view()
        from poissbox_tpu_torch.solvers import ksp
        inner = self.solver._solver
        self.view = ksp.view(inner.opts, inner.shape, inner.M).replace("\n", "; ")

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _mg_view(self) -> dict | None:
        """The multigrid cycle the program resolved for this grid (levels,
        sweeps, pre-smooth dtype): what the smoothing floor counts."""
        M = getattr(getattr(self.solver, "_solver", None), "M", None)
        cfg = getattr(M, "config", None)
        if cfg is None:
            return None
        return {"levels": [list(lvl.shape) for lvl in M.levels],
                "pre": int(cfg.pre_smooth), "post": int(cfg.post_smooth),
                "pre_dtype": cfg.pre_dtype or cfg.dtype or self.cell["dtype"],
                "dtype": cfg.dtype or self.cell["dtype"]}

    def _timed_solve(self, b):
        """One solve, ending synchronised, and its ms: by CUDA events on
        the card (the device's clock, from the solve's first enqueued work
        to its last), by the host's clock elsewhere."""
        if not self.cuda:
            t = time.perf_counter()
            res = self.solver.solve(b)
            return res, 1e3 * (time.perf_counter() - t)
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        res = self.solver.solve(b)
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    def loop(self, stop, keep: bool = True) -> dict:
        """Solves the pool in turn until `stop(solves, elapsed)` says so;
        with `keep`, the solutions the judge samples are kept, each with
        the residual norm the solve reported."""
        sampler = judge.Sampler(self.seed, len(self.pool))
        its, reasons, ms = [], [], []
        self.sync()
        t0 = time.perf_counter()
        i = 0
        while True:
            res, t = self._timed_solve(self.pool[i % len(self.pool)])
            ms.append(t)
            its.append(res.iterations)
            reasons.append(res.reason)
            if keep:
                sampler.offer(i, (res.x, res.residual_norm))
            i += 1
            if stop(i, time.perf_counter() - t0):
                break
        wall = time.perf_counter() - t0
        del res
        return {"wall_s": wall, "solves": i, "solve_ms": ms, "its": [int(k) for k in its],
                "reasons": [int(r) for r in reasons], "kept": sampler.kept}

    def window(self, seconds: float) -> dict:
        return self.loop(lambda _, elapsed: elapsed >= seconds)

    def traced_window(self) -> tuple[dict, object]:
        """The traffic file's "trace_solves" solves twice: untraced (their
        wall, which the profiler's own host work would lengthen; no solution
        kept, so the allocator does not grow in it), then under
        torch.profiler."""
        from perfbench import devtrace
        stop = lambda solves, _: solves >= self.cell["trace_solves"]  # noqa: E731
        untraced = self.loop(stop, keep=False)["wall_s"]
        with devtrace.traced() as prof:
            out = self.loop(stop)
        out["untraced_wall_s"] = untraced
        return out, prof

    def memory_peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def free_program(self) -> None:
        self.solver = None
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def judged(self, kept: dict) -> list[dict]:
        """The reference's numbers of every kept solve."""
        return [judge.judge_solve(self.spec["order"], x, reported, self.pool[slot],
                                  self.deltas, self.cell["limits"])
                for slot, (_, (x, reported)) in sorted(kept.items())]


def run_process(cell: dict, seed: int, seconds: float, trace: bool, device: str,
                t_start: float) -> dict:
    """Set-up, the window and the judging of one run; returns the result."""
    run = Run(cell, seed, device)
    setup_s = time.time() - t_start
    for k, v in run.parts.items():
        print(f"setup {k} {v:.6f}", flush=True)
    print(f"setup setup_s {setup_s:.6f}", flush=True)
    print(f"solver {run.view}", flush=True)
    prof = None
    if trace:
        win, prof = run.traced_window()
    else:
        win = run.window(seconds)
    refuse_forbidden()
    peak = run.memory_peak()
    record = {"cell": cell["name"], "grid": cell["grid"], "order": run.spec["order"],
              "itemsize": {"float32": 4, "float64": 8}[cell["dtype"]],
              "setup_s": setup_s, "setup": dict(run.parts), "mg": run.mg,
              "window": {"wall_s": win["wall_s"], "solves": win["solves"],
                         "solve_ms": win["solve_ms"]},
              "iterations": win["its"]}
    breakdown = None
    if trace:
        from perfbench import devtrace
        table = devtrace.kernel_table(prof)
        record["trace"] = dict(devtrace.summarise(table), wall_s=win["wall_s"],
                               untraced_wall_s=win["untraced_wall_s"], table=table)
        breakdown = {"device_ops": devtrace.top_ops(table), "idle_gaps": devtrace.idle_gaps(prof)}
        del prof
    kept = win.pop("kept")
    run.free_program()
    judged = run.judged(kept)
    del kept
    checks = judge.numbers(judged, win["reasons"], cell["limits"])
    man = cells.manifest() if cells.MANIFEST.is_file() else None
    metrics = cells.read_metrics(cells.metrics_for(cell["name"], man, trace), record) \
        if man is not None else {}
    torch = run.torch
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = record["trace"]["device_s"]
        dev["window_s"] = win["wall_s"]
    result = {"correct": judge.passed(checks), "attempted": win["solves"],
              "failed": judge.failed_count(judged, win["reasons"], cell["limits"]),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload, cells.manifest())
    if cell["chips"] > 1:
        # one process a rank, each of which looks for its card
        from perfbench import ranks
        return ranks.main(cell, args.seed, args.seconds, bool(args.trace), T_START)
    t = time.time()
    import torch
    torch_import_s = time.time() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {cell['name']} needs {cell['chips']} CUDA cards, found {have}",
              file=sys.stderr)
        return 2
    print(f"setup torch_import_s {torch_import_s:.6f}", flush=True)
    res = run_process(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    refuse_forbidden()
    emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
