"""The readers of the program's spans on a synthetic store, and in a
whole traced run on the CPU, with and without spans in the program."""

import pytest

from perfbench import cells
from perfbench_helpers import cpu_run, small_cell
from poissbox_tpu_torch.utils import profiling

SOLVES = 3


def store(solves=SOLVES):
    """`solves` solves, each: a V-cycle, then two iterations of a matvec
    and a V-cycle, each iteration after a stopping test and the second
    holding a host read of its own; a last stopping test; a symbol."""
    recs, ids = [], iter(range(10**6))

    def add(name, parent, root, host, dev):
        recs.append({"name": name, "id": next(ids), "parent": parent, "solve": root,
                     "host_ms": host, "self_host_ms": host, "device_ms": dev,
                     "self_device_ms": dev})
        return recs[-1]["id"]
    for _ in range(solves):
        root = next(ids)
        add("PCApply", root, root, 1.0, 5.0)
        mg = add("MGLevel0", recs[-1]["id"], root, 0.9, 4.0)
        add("MGLevel1", mg, root, 0.4, 1.0)
        for j in range(2):
            add("KSPSync", root, root, 0.5, 0.1)
            it = add("KSPIteration", root, root, 3.0, 9.0)
            add("MatMult", it, root, 0.5, 1.0)
            add("PCApply", it, root, 1.0, 5.0)
            if j == 1:
                add("KSPSync", it, root, 0.25, 0.0)
        add("KSPSync", root, root, 0.5, 0.1)
        add("FFTSymbol", root, root, 0.2, 4.0)
        recs.append({"name": "KSPSolve", "id": root, "parent": None, "solve": root,
                     "host_ms": 10.0, "self_host_ms": 1.0, "device_ms": 30.0,
                     "self_device_ms": 1.0})
    return recs


def record(solves=SOLVES):
    return {"window": {"solves": solves, "wall_s": 0.5, "solve_ms": [30.0] * solves},
            "iterations": [2] * solves}


@pytest.fixture
def spans(monkeypatch):
    recs = store()
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    return recs


def read(name, rec):
    return cells.reader(name)(rec)


def test_readers_on_a_synthetic_store(spans):
    rec = record()
    # 6 iterations of 3.0 host ms, one 0.25-ms host read inside each second
    assert read("enqueue_ms_per_it", rec) == pytest.approx((6 * 3.0 - 3 * 0.25) / 6)
    assert read("sync_wait_ms", rec) == pytest.approx(3 * 0.5 + 0.25)
    assert read("vcycles_per_it", rec) == pytest.approx(9 / 6)
    assert read("vcycle_device_ms", rec) == pytest.approx(3 * 5.0)
    # the root's 30 ms less three V-cycles and two matvecs
    assert read("krylov_device_ms", rec) == pytest.approx(30.0 - 15.0 - 2.0)
    assert read("symbol_device_ms", rec) == pytest.approx(4.0)
    for name in ("enqueue_ms_per_it", "sync_wait_ms", "vcycles_per_it"):
        assert read(name + ".host", rec) == read(name, rec)


def test_readers_need_every_solve(spans):
    for m in cells.manifest()["per_layer"]:
        if m["source"] == "program_span":
            assert read(m["name"], record()) is not None
            assert read(m["name"], record(SOLVES + 1)) is None


def test_device_readers_read_nothing_off_the_card(monkeypatch):
    recs = store()
    for s in recs:
        s["device_ms"] = s["self_device_ms"] = None
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    for name in ("vcycle_device_ms", "krylov_device_ms", "symbol_device_ms"):
        assert read(name, record()) is None
    assert read("vcycles_per_it", record()) == pytest.approx(1.5)


def test_traced_cpu_run_reads_the_spans():
    profiling.reset()
    res = cpu_run(small_cell("poisson7.64.f64", n=16), trace=True)
    profiling.reset()
    assert res["correct"]
    m = res["metrics"]
    assert m["enqueue_ms_per_it.host"]["value"] > 0
    assert m["sync_wait_ms.host"]["value"] > 0
    its = m["iterations.host"]["value"]
    # CG applies M once more than it iterates
    assert m["vcycles_per_it.host"]["value"] == pytest.approx((its + 1) / its)


def test_a_program_without_spans_gives_no_span_metric(monkeypatch):
    """The parent of the spans: the readers find nothing and raise nothing,
    and the run's line leaves their metrics out."""
    monkeypatch.delattr(profiling, "spans")
    res = cpu_run(small_cell("poisson7.512.f32", n=16), trace=True)
    profiling.reset()
    assert res["correct"] and "iterations" in res["metrics"]
    assert not {"enqueue_ms_per_it", "sync_wait_ms", "vcycles_per_it"} & set(res["metrics"])
