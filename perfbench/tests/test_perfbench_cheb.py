"""The cell poisson7.512.cheb on the CPU: whole runs, sound and with the
faults of ``perfbench/faults.py`` planted, and the readers of its
smoothing spans and Chebyshev counters (smooth_device_ms, cheb_roofline,
iterations.cheb), on a synthetic store of CG + Chebyshev-MG solves and in
a traced run; the byte model's 512^3 numbers."""

import pytest

from perfbench import cells, faults
from perfbench_helpers import cpu_run, small_cell
from poissbox_tpu_torch.utils import profiling

CELL = "poisson7.512.cheb"
SOLVES = 3
ITS = 2
# the 512^3 cycle: 8 levels, V(1,1), the bf16 pre-smooth
MG = {"levels": [[512 >> k] * 3 for k in range(8)], "pre": 1, "post": 1,
      "pre_dtype": "bfloat16", "dtype": "float32"}
SMOOTHED = 7


def test_sound_run_is_correct():
    cell = small_cell(CELL, 32)
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(cell["limits"]) | {"unconverged"}


@pytest.mark.parametrize("fault", ["unchanged", "altered", "unconverged"])
def test_a_planted_fault_is_not_correct(fault):
    cell = small_cell(CELL, 32)
    with faults.planted(fault):
        res = cpu_run(cell)
    assert not res["correct"] and res["failed"] >= 1, res["checks"]
    over = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    want = {"unchanged": set(cell["limits"]), "unconverged": {"unconverged"}}.get(fault)
    if want is not None:
        assert want <= over, res["checks"]


def store(solves=SOLVES):
    """`solves` CG solves of ITS iterations, each iteration and the solve's
    first M r0 one V-cycle: in each level's span its two MGSmooth spans,
    0.5 device ms each."""
    recs, ids = [], iter(range(10**6))

    def add(name, parent, root, host, dev):
        recs.append({"name": name, "id": next(ids), "parent": parent, "solve": root,
                     "host_ms": host, "self_host_ms": host, "device_ms": dev,
                     "self_device_ms": dev})
        return recs[-1]["id"]

    def cycle(parent, root):
        pc = add("PCApply", parent, root, 1.0, 10.0)
        up = pc
        for k in range(SMOOTHED):
            up = add(f"MGLevel{k}", up, root, 0.5, 1.0)
            add("MGSmooth", up, root, 0.1, 0.5)
            add("MGSmooth", up, root, 0.1, 0.5)
        add(f"MGLevel{SMOOTHED}", up, root, 0.1, 0.1)

    for _ in range(solves):
        root = next(ids)
        cycle(root, root)
        for _ in range(ITS):
            add("KSPSync", root, root, 0.5, 0.1)
            it = add("KSPIteration", root, root, 3.0, 12.0)
            add("MatMult", it, root, 0.5, 1.0)
            cycle(it, root)
        add("KSPSync", root, root, 0.5, 0.1)
        recs.append({"name": "KSPSolve", "id": root, "parent": None, "solve": root,
                     "host_ms": 30.0, "self_host_ms": 1.0, "device_ms": 40.0,
                     "self_device_ms": 1.0})
    return recs


def record(solves=SOLVES):
    return {"window": {"solves": solves, "wall_s": 0.5, "solve_ms": [40.0] * solves},
            "iterations": [ITS] * solves, "grid": [512] * 3, "itemsize": 4, "mg": dict(MG)}


def counters(recs, cycles=ITS + 1):
    """Each solve's counters: `cycles` V-cycles of degree 2 a side."""
    per = {"MGSmooth.cheb_steps": cycles * SMOOTHED * 4}
    for shape in MG["levels"][:-1]:
        pts = cycles * shape[0] * shape[1] * shape[2]
        for key in ("zero.bfloat16", "last.bfloat16", "first.float32", "last.float32"):
            name = "MGSmooth.cheb_points." + key
            per[name] = per.get(name, 0) + pts
    return {s["id"]: dict(per) for s in recs if s["name"] == "KSPSolve"}


def read(name, rec):
    return cells.reader(name)(rec)


@pytest.fixture
def spans(monkeypatch):
    recs = store()
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    monkeypatch.setattr(profiling, "counts", lambda: counters(recs))
    return recs


def test_byte_model_at_512():
    """A fine level's V(1,1) at 512^3 with the bf16 pre-smooth: (2 + 4)
    bf16 and (4 + 4) float32 passes of 512^3 points, 5.906 GB, 1.763 ms
    at 3.35 TB/s; the seven smoothed levels 2.015 ms and 28 degrees."""
    model = cells.metric_module("cheb_roofline")
    steps, fine = model.cycle_points(dict(MG, levels=MG["levels"][:2]))
    assert steps == 4
    assert model.nbytes(fine) == 44 * 512**3
    assert model.nbytes(fine) / 3.35e12 * 1e3 == pytest.approx(1.7629, abs=1e-4)
    steps, whole = model.cycle_points(MG)
    assert steps == 4 * SMOOTHED
    assert model.nbytes(whole) / 3.35e12 * 1e3 == pytest.approx(2.0147, abs=1e-4)
    steps, deg4 = model.cycle_points(dict(MG, pre=2, post=2, levels=MG["levels"][:2]))
    assert steps == 8
    assert model.nbytes(deg4) == (2 + 2 * 5 + 4) * 2 * 512**3 + (4 + 2 * 5 + 4) * 4 * 512**3


def test_readers_on_a_synthetic_store(spans):
    rec = record()
    cycles = ITS + 1
    assert read("smooth_device_ms", rec) == pytest.approx(cycles * SMOOTHED * 2 * 0.5)
    model = cells.metric_module("cheb_roofline")
    _, whole = model.cycle_points(MG)
    floor_ms = cycles * model.nbytes(whole) / 3.35e12 * 1e3
    assert read("cheb_roofline", rec) == pytest.approx(100.0 * floor_ms / (cycles * SMOOTHED))
    assert read("iterations.cheb", rec) == ITS


@pytest.mark.parametrize("name", ["smooth_device_ms", "cheb_roofline"])
def test_readers_need_every_solve(spans, name):
    assert read(name, record()) is not None
    assert read(name, record(SOLVES + 1)) is None


@pytest.mark.parametrize("name", ["smooth_device_ms", "cheb_roofline"])
def test_readers_read_nothing_off_the_card(monkeypatch, name):
    recs = store()
    for s in recs:
        s["device_ms"] = s["self_device_ms"] = None
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    monkeypatch.setattr(profiling, "counts", lambda: counters(recs))
    assert read(name, record()) is None


def test_roofline_needs_counters_that_match_the_cycle(monkeypatch):
    """A program without the Chebyshev counters (the parent, or SOR
    levels), counters of another cycle, or a record without the resolved
    cycle give no roofline; the spans' time still reads."""
    recs = store()
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    monkeypatch.setattr(profiling, "counts", lambda: {})
    assert read("cheb_roofline", record()) is None
    assert read("smooth_device_ms", record()) is not None
    monkeypatch.setattr(profiling, "counts", lambda: counters(recs, cycles=ITS))
    assert read("cheb_roofline", record()) is None
    monkeypatch.setattr(profiling, "counts", lambda: counters(recs))
    assert read("cheb_roofline", dict(record(), mg=dict(MG, post=2))) is None
    assert read("cheb_roofline", dict(record(), mg=None)) is None
    monkeypatch.delattr(profiling, "counts")
    assert read("cheb_roofline", record()) is None


def test_traced_run_records_its_smoothing():
    """A traced CPU run of the cell at 32^3 (float32, V(3,3): degree 6 a
    side, 4 levels): in every solve two MGSmooth spans a smoothed level a
    V-cycle, each inside its MGLevel<k>, and the counters as the resolved
    cycle gives them; the run is correct and reads its iterations under
    their own name, and nothing from the device."""
    profiling.reset()
    res = cpu_run(small_cell(CELL, n=32), trace=True)
    recs, per = profiling.spans(), profiling.counts()
    profiling.reset()
    assert res["correct"] and set(res["metrics"]) == {"iterations.cheb"}
    by_id = {s["id"]: s for s in recs}
    roots = [s for s in recs if s["name"] == "KSPSolve" and s["parent"] is None]
    assert len(roots) == res["attempted"]
    model = cells.metric_module("cheb_roofline")
    for root in roots:
        mine = [s for s in recs if s["solve"] == root["id"]]
        cycles = sum(1 for s in mine if s["name"] == "PCApply")
        levels = sum(1 for s in mine if s["name"].startswith("MGLevel")) // cycles
        smooth = [s for s in mine if s["name"] == "MGSmooth"]
        assert len(smooth) == 2 * cycles * (levels - 1)
        assert all(by_id[s["parent"]]["name"].startswith("MGLevel") for s in smooth)
        mg = {"levels": [[32 >> k] * 3 for k in range(levels)], "pre": 3, "post": 3,
              "pre_dtype": "float32", "dtype": "float32"}
        steps, want = model.cycle_points(mg)
        assert per[root["id"]] == {
            "MGSmooth.cheb_steps": cycles * steps,
            **{"MGSmooth.cheb_points." + k: cycles * n for k, n in want.items()}}
