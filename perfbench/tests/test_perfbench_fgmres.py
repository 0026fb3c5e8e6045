"""The cell poisson7.512.fgmres on the CPU: whole runs, sound and with the
faults of ``perfbench/faults.py`` planted, and the readers of its
Gram-Schmidt spans and counters (orthog_device_ms, orthog_roofline), on a
synthetic store of FGMRES solves and in a traced run."""

import pytest

from perfbench import cells, faults
from perfbench_helpers import cpu_run, small_cell
from poissbox_tpu_torch.utils import profiling

CELL = "poisson7.512.fgmres"
SOLVES = 3
STEPS = 2


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
    """`solves` FGMRES solves of one cycle, each: STEPS iterations of a
    V-cycle, a matvec and a Gram-Schmidt step; the cycle's build of x."""
    recs, ids = [], iter(range(10**6))

    def add(name, parent, root, host, dev):
        recs.append({"name": name, "id": next(ids), "parent": parent, "solve": root,
                     "host_ms": host, "self_host_ms": host, "device_ms": dev,
                     "self_device_ms": dev})
        return recs[-1]["id"]
    for _ in range(solves):
        root = next(ids)
        for _ in range(STEPS):
            add("KSPSync", root, root, 0.5, 0.1)
            it = add("KSPIteration", root, root, 3.0, 9.0)
            add("PCApply", it, root, 1.0, 5.0)
            add("MatMult", it, root, 0.5, 1.0)
            add("KSPGMRESOrthog", it, root, 0.1, 2.0)
        add("KSPGMRESBuildSoln", root, root, 0.1, 0.5)
        recs.append({"name": "KSPSolve", "id": root, "parent": None, "solve": root,
                     "host_ms": 10.0, "self_host_ms": 1.0, "device_ms": 30.0,
                     "self_device_ms": 1.0})
    return recs


def record(solves=SOLVES):
    return {"window": {"solves": solves, "wall_s": 0.5, "solve_ms": [30.0] * solves},
            "iterations": [STEPS] * solves, "grid": [512] * 3, "itemsize": 4}


def counters(recs):
    """Each solve's counters: STEPS steps, which saw 1, 2, ... rows built."""
    return {s["id"]: {"KSPGMRESOrthog.steps": STEPS,
                      "KSPGMRESOrthog.rows": STEPS * (STEPS + 1) // 2}
            for s in recs if s["name"] == "KSPSolve"}


def read(name, rec):
    return cells.reader(name)(rec)


@pytest.fixture
def spans(monkeypatch):
    recs = store()
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    monkeypatch.setattr(profiling, "counts", lambda: counters(recs))
    return recs


def test_readers_on_a_synthetic_store(spans):
    rec = record()
    assert read("orthog_device_ms", rec) == pytest.approx(STEPS * 2.0)
    # a solve's 2 steps: (2 x 3 + 2 x 2) passes of a 512^3 f32 field in 4 ms
    floor_ms = 10 * 512**3 * 4 / 3.35e12 * 1e3
    assert read("orthog_roofline", rec) == pytest.approx(100.0 * floor_ms / (STEPS * 2.0))


@pytest.mark.parametrize("name", ["orthog_device_ms", "orthog_roofline"])
def test_readers_need_every_solve(spans, name):
    assert read(name, record()) is not None
    assert read(name, record(SOLVES + 1)) is None


@pytest.mark.parametrize("name", ["orthog_device_ms", "orthog_roofline"])
def test_readers_read_nothing_off_the_card(monkeypatch, name):
    recs = store()
    for s in recs:
        s["device_ms"] = s["self_device_ms"] = None
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    monkeypatch.setattr(profiling, "counts", lambda: counters(recs))
    assert read(name, record()) is None


def test_roofline_needs_the_programs_counters(monkeypatch):
    """A program without counters, or whose steps disagree with its
    spans, gives no roofline; the span's time still reads."""
    recs = store()
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    monkeypatch.delattr(profiling, "counts")
    assert read("orthog_roofline", record()) is None
    assert read("orthog_device_ms", record()) == pytest.approx(STEPS * 2.0)
    monkeypatch.setattr(profiling, "counts", lambda: {}, raising=False)
    assert read("orthog_roofline", record()) is None


def test_traced_run_records_its_gram_schmidt():
    """A traced CPU run of the cell at 32^3: in every solve a
    KSPGMRESOrthog span a step, inside its iteration, one
    KSPGMRESBuildSoln under the root (one cycle), and the counters' rows
    sum(j + 1) over the steps; the run is correct and reads its
    iterations under their own name."""
    profiling.reset()
    res = cpu_run(small_cell(CELL, n=32), trace=True)
    recs, per = profiling.spans(), profiling.counts()
    profiling.reset()
    assert res["correct"] and "iterations.fgmres" in res["metrics"]
    by_id = {s["id"]: s for s in recs}
    roots = [s for s in recs if s["name"] == "KSPSolve" and s["parent"] is None]
    assert len(roots) == res["attempted"]
    for root in roots:
        mine = [s for s in recs if s["solve"] == root["id"]]
        its = sum(1 for s in mine if s["name"] == "KSPIteration")
        orthog = [s for s in mine if s["name"] == "KSPGMRESOrthog"]
        build = [s for s in mine if s["name"] == "KSPGMRESBuildSoln"]
        assert len(orthog) == its >= 1 and len(build) == 1
        assert all(by_id[s["parent"]]["name"] == "KSPIteration" for s in orthog)
        assert build[0]["parent"] == root["id"]
        assert per[root["id"]] == {"KSPGMRESOrthog.steps": its,
                                   "KSPGMRESOrthog.rows": its * (its + 1) // 2}
