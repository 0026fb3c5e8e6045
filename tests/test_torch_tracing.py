"""The port's spans (`poissbox_tpu_torch.utils.profiling.span`) on the CPU:
what a solve records, when it records nothing, how the spans reach a
torch profiler's trace and `-log_view`, and the benchmark's readers of
them (`perfbench/metrics/`), which read nothing unless every solve of
the traced window is there."""

import contextlib
import io

import pytest
import torch

from perfbench import cells
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.solvers.ksp import solve
from poissbox_tpu_torch.utils import profiling

SPAN_READERS = ["enqueue_ms_per_it", "sync_wait_ms", "vcycles_per_it",
                "vcycle_device_ms", "krylov_device_ms", "symbol_device_ms"]


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def _rhs(solver, seed=3):
    return solver.rhs_for(solver.random_solution(seed))


def _recorded_solve(argv, n=32, order=2):
    solver = PoissonSolver((n,) * 3, options=Options(argv), dtype=torch.float64,
                           device="cpu", order=order)
    b = _rhs(solver)
    with profiling.recording():
        res = solver.solve(b)
    return solver, res, profiling.spans()


def _count(recs, name):
    return sum(1 for s in recs if s["name"] == name)


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_cg_mg_solve_records_its_spans(impl):
    """A 32^3 float64 CG + MG solve: one root that every span shares, an
    iteration span an iteration, a V-cycle and a stopping test one more
    than the iterations, and each level's span once a V-cycle, inside the
    level above. impl "cuda" walks the card's call graph (the residual
    update fused into the first sweep) on the kernels' plain versions."""
    solver, res, recs = _recorded_solve(["-ksp_type", "cg", "-pc_type", "mg",
                                         "-ksp_rtol", "1e-8", "-mg_impl", impl])
    its = int(res.iterations)
    assert its > 1
    roots = [s for s in recs if s["parent"] is None]
    assert [s["name"] for s in roots] == ["KSPSolve"]
    assert all(s["solve"] == roots[0]["id"] for s in recs)
    assert _count(recs, "KSPIteration") == its
    assert _count(recs, "PCApply") == its + 1
    assert _count(recs, "KSPSync") == its + 1
    assert _count(recs, "MatMult") == its
    by_id = {s["id"]: s for s in recs}
    levels = len(solver._solver.M.levels)
    assert levels >= 3
    for k in range(levels):
        spans_k = [s for s in recs if s["name"] == f"MGLevel{k}"]
        assert len(spans_k) == its + 1
        above = "PCApply" if k == 0 else f"MGLevel{k - 1}"
        assert all(by_id[s["parent"]]["name"] == above for s in spans_k)
    assert _count(recs, f"MGLevel{levels}") == 0
    for s in recs:
        if s["name"] in ("KSPIteration", "KSPSync"):
            assert s["parent"] == roots[0]["id"]
        assert s["device_ms"] is None and s["self_device_ms"] is None


@pytest.mark.parametrize("ksp", ["cg", "fcg", "pipecg", "gmres", "richardson"])
def test_every_krylov_type_counts_its_iterations(ksp):
    """One KSPIteration span an iteration of every Krylov type, and a
    host read (KSPSync) in every solve."""
    _, res, recs = _recorded_solve(["-ksp_type", ksp, "-pc_type", "mg",
                                    "-ksp_rtol", "1e-6"], n=16)
    assert _count(recs, "KSPSolve") == 1
    assert _count(recs, "KSPIteration") == int(res.iterations) > 0
    assert _count(recs, "KSPSync") >= 1 and _count(recs, "PCApply") >= int(res.iterations)


def test_fft_solve_records_one_symbol():
    """The order-6 direct spectral solve: one symbol build, one operator
    application (its residual), no iteration."""
    _, res, recs = _recorded_solve(["-ksp_type", "fft"], n=16, order=6)
    assert int(res.iterations) == 1
    assert _count(recs, "KSPSolve") == 1
    assert _count(recs, "FFTSymbol") == 1
    assert _count(recs, "MatMult") == 1
    assert _count(recs, "KSPIteration") == 0


def test_closed_recording_records_nothing():
    """Outside a recording window and a profiler the store stays empty,
    and `span` hands out one shared no-op context."""
    solver = PoissonSolver((16,) * 3, options=Options(["-ksp_type", "cg", "-pc_type", "mg"]),
                           dtype=torch.float64, device="cpu")
    solver.solve(_rhs(solver))
    assert profiling.spans() == []
    assert profiling.span("KSPSolve") is profiling.span("MatMult")
    with profiling.recording():
        assert profiling.span("KSPSolve") is not profiling.span("KSPSolve")
    assert profiling.span("KSPSolve") is profiling.span("MatMult")


def test_spans_reach_the_torch_profiler():
    """Under torch.profiler the spans record with no recording window, and
    each appears in the profiler's events as a host range of its name,
    not as a user annotation (which the profiler would also draw on the
    device's timeline)."""
    solver = PoissonSolver((16,) * 3, options=Options(["-ksp_type", "cg", "-pc_type", "mg"]),
                           dtype=torch.float64, device="cpu")
    b = _rhs(solver)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = solver.solve(b)
    recs = profiling.spans()
    assert _count(recs, "KSPSolve") == 1
    assert _count(recs, "KSPIteration") == int(res.iterations)
    events = [e for e in prof.events() if e.name in ("KSPSolve", "KSPIteration", "PCApply",
                                                      "MGLevel0", "KSPSync", "MatMult")]
    assert sorted(e.name for e in events) == sorted(
        s["name"] for s in recs if s["name"] in {e.name for e in events})
    assert _count([{"name": e.name} for e in events], "KSPIteration") == int(res.iterations)
    assert all(not getattr(e, "is_user_annotation", False) for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)
    profiling.reset()
    solver.solve(b)
    assert profiling.spans() == []


def test_self_host_ms_is_host_ms_less_the_childrens():
    _, _, recs = _recorded_solve(["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8"],
                                 n=16)
    kids = {}
    for s in recs:
        kids[s["parent"]] = kids.get(s["parent"], 0.0) + s["host_ms"]
    for s in recs:
        assert s["self_host_ms"] == pytest.approx(s["host_ms"] - kids.get(s["id"], 0.0),
                                                  abs=1e-9)
        assert s["host_ms"] >= 0 and s["self_host_ms"] >= -1e-9


def test_log_view_counts_pcapply_by_its_spans():
    """-log_view's PCApply and MatMult counts are the logged solve's
    spans, and its span table lists them."""
    solver = PoissonSolver((16,) * 3, dtype=torch.float64, device="cpu")
    b = _rhs(solver)
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8", "-log_view"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = solve(solver.A, b, Options(argv), grid=solver.grid)
    recs = profiling.spans()
    logged = [s for s in recs if s["solve"] == recs[-1]["id"]]
    assert recs[-1]["name"] == "KSPSolve"
    rows = {ln[12:22].strip(): ln[23:28].strip() for ln in out.getvalue().splitlines()
            if ln.startswith("log_view:   ")}
    assert rows["PCApply"] == str(_count(logged, "PCApply")) == str(int(res.iterations) + 1)
    assert rows["MatMult"] == str(_count(logged, "MatMult")) == str(int(res.iterations))
    table = {ln.split()[2]: int(ln.split()[3]) for ln in out.getvalue().splitlines()
             if ln.startswith("log_view: span ") and ln.split()[2] != "name"}
    assert table["PCApply"] == _count(logged, "PCApply")
    assert table["KSPIteration"] == int(res.iterations)
    assert table["KSPSolve"] == 1


def _synthetic(solves):
    """A store of `solves` solves: each one iteration pair and a V-cycle
    more, device times included."""
    recs, ids = [], iter(range(10**6))

    def add(name, parent, solve, host, dev):
        s = {"name": name, "id": next(ids), "parent": parent, "solve": solve,
             "host_ms": host, "self_host_ms": host, "device_ms": dev, "self_device_ms": dev}
        recs.append(s)
        return s["id"]
    for _ in range(solves):
        root = next(ids)
        add("PCApply", root, root, 1.0, 5.0)
        for _ in range(2):
            add("KSPSync", root, root, 0.5, 0.1)
            it = add("KSPIteration", root, root, 3.0, 9.0)
            add("MatMult", it, root, 0.5, 1.0)
            add("PCApply", it, root, 1.0, 5.0)
        add("KSPSync", root, root, 0.5, 0.1)
        add("FFTSymbol", root, root, 0.2, 4.0)
        recs.append({"name": "KSPSolve", "id": root, "parent": None, "solve": root,
                     "host_ms": 10.0, "self_host_ms": 1.0, "device_ms": 30.0,
                     "self_device_ms": 1.0})
    return recs


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_need_every_solve_of_the_window(name, monkeypatch):
    """Each reader of the spans reads a number where the store's roots are
    the window's solves, and nothing where they are not or where the
    program records no spans."""
    rec = {"window": {"solves": 3, "wall_s": 0.5, "solve_ms": [30.0] * 3}}
    monkeypatch.setattr(profiling, "spans", lambda: _synthetic(3))
    assert cells.reader(name)(rec) is not None
    monkeypatch.setattr(profiling, "spans", lambda: _synthetic(2))
    assert cells.reader(name)(rec) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert cells.reader(name)(rec) is None
    monkeypatch.delattr(profiling, "spans")
    assert cells.reader(name)(rec) is None
