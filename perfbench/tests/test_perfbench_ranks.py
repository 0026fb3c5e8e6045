"""The four-card cell's launcher on the CPU: four gloo ranks share the
CPU, each with its box of a small copy of the cell ((32, 32, 16) on
(2, 2, 1)), the look for cards skipped, the manifest the one that lists
the cell (``data/four_card_cell.json``). The parent prints one result
line, last; the gathered solution is a one-process solve's; a planted
fault in every rank reads not correct; a rank that exits ends the run."""

import json
import os
import time

import pytest
import torch

from perfbench import cells, faults, ranks
from perfbench_helpers import small_cell, with_four_card_cell

NAME = "poisson7.weak4.f32"
SEED = 2**31 + 29


def cell():
    return small_cell(NAME, 16)


def man():
    return with_four_card_cell(cells.manifest())


def _lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("trace", [0, 1])
def test_parent_prints_one_result_line_last(trace, capfd):
    c = cell()
    assert c["grid"] == [32, 32, 16] and c["config_spec"]["pgrid"] == [2, 2, 1]
    assert ranks.main(c, SEED, 0.3, bool(trace), time.time(), device="cpu", man=man()) == 0
    out, err = capfd.readouterr()
    results = [ln for ln in _lines(out) if ln.startswith("{")]
    assert len(results) == 1 and _lines(out)[-1] == results[0]
    res = json.loads(results[0])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    assert list(res)[-1] == "checks" and set(res["checks"]) == {"residual", "unconverged"}
    assert res["device"]["count"] == 4
    assert _lines(err)[-1].startswith("check unconverged ")
    want = {m["name"] for m in cells.metrics_for(NAME, man(), bool(trace))}
    if trace:
        # no device time on the CPU: busy_pct.dist finds nothing to read
        assert set(res["metrics"]) == want - {"busy_pct.dist"}
        assert res["metrics"]["exchanges_per_it.dist"]["value"] > 0
        assert res["metrics"]["build_s.dist"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    else:
        assert set(res["metrics"]) == want == {"setup_s", "solve_ms.dist"}


def test_gathered_solution_is_a_one_process_solve(tmp_path, monkeypatch):
    from poissbox_tpu_torch.api import PoissonSolver
    from poissbox_tpu_torch.config import Options
    c = cell()
    monkeypatch.setenv("PERFBENCH_SAVE", str(tmp_path))
    out = ranks.launch(c, SEED, 0.3, False, "cpu", time.time(),
                       fault="perfbench.tests.perfbench_helpers:save_judged")
    assert out.rc == 0 and out.result["correct"]
    saved = sorted(tmp_path.glob("judged*.pt"))
    assert saved
    one = PoissonSolver(tuple(c["grid"]), tuple(c["length"]),
                        options=Options(c["config_spec"]["argv"] + ["-ksp_rtol", repr(c["rtol"])]),
                        dtype=torch.float32, device="cpu")
    for path in saved:
        got = torch.load(path)
        ref = one.solve(got["b"]).x
        assert got["x"].shape == ref.shape == tuple(c["grid"])
        assert float((got["x"] - ref).norm() / ref.norm()) <= 10 * c["rtol"]


@pytest.mark.parametrize("fault", ["x_exchange_left_out", "unchanged", "altered"])
def test_a_fault_in_every_rank_is_not_correct(fault):
    out = ranks.launch(cell(), SEED, 0.3, False, "cpu", time.time(), fault=fault)
    assert out.rc == 0
    res = out.result
    assert not res["correct"] and res["failed"] >= 1, res["checks"]
    assert res["checks"]["residual"]["value"] > res["checks"]["residual"]["limit"]


def test_a_rank_that_exits_ends_every_rank(capfd, monkeypatch):
    import subprocess
    import sys
    real, pids = subprocess.Popen, []

    def popen(args, env, **kw):
        # rank 1 exits with 1 at once; the others wait for it in the
        # process group's rendezvous until the parent ends them
        if env["RANK"] == "1":
            args = [sys.executable, "-c", "import sys; sys.exit(1)"]
        proc = real(args, env=env, **kw)
        pids.append(proc.pid)
        return proc
    monkeypatch.setattr(ranks.subprocess, "Popen", popen)
    assert ranks.main(cell(), SEED, 0.3, False, time.time(), device="cpu", man=man()) != 0
    out, _ = capfd.readouterr()
    assert not [ln for ln in _lines(out) if ln.startswith("{")]
    assert len(pids) == 4
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_faults_across_ranks_are_taken_out_again():
    from perfbench import judge
    from poissbox_tpu_torch.parallel import halo
    before = halo.start_face_exchange, judge.judge_solve
    with faults.planted("x_exchange_left_out"):
        assert halo.start_face_exchange is not before[0]
    with faults.planted("perfbench.tests.perfbench_helpers:save_judged"):
        assert judge.judge_solve is not before[1]
    assert (halo.start_face_exchange, judge.judge_solve) == before


def _record(**changes):
    rec = {"iterations": [7, 7, 7, 7], "window": {"wall_s": 2.0, "solves": 4,
                                                  "solve_ms": [490.0, 500.0, 510.0, 520.0]},
           "setup_s": 30.0, "setup": {}, "exchanges": 1820,
           "trace": {"device_s": 2.5, "outside_nccl_s": 0.6, "untraced_wall_s": 1.8,
                     "wall_s": 2.7, "launches": 100, "table": {}}}
    rec.update(changes)
    return rec


def test_dist_readers_read_a_hand_built_record():
    rec = _record()
    assert cells.reader("exchanges_per_it.dist")(rec) == 1820 / 28
    assert cells.reader("busy_pct.dist")(rec) == pytest.approx(100 * 0.6 / 1.8)
    assert cells.reader("iterations.dist")(rec) == 7.0
    assert cells.reader("build_s.dist")(_record(setup={"build_s": 4.5})) == 4.5
    untraced = _record()
    del untraced["trace"], untraced["exchanges"]
    assert cells.reader("solve_ms.dist")(untraced) == 500.0
    # nothing to read: no exchanges counted, no device time outside NCCL
    assert cells.reader("exchanges_per_it.dist")(untraced) is None
    assert cells.reader("busy_pct.dist")(untraced) is None
    assert cells.reader("solve_ms.dist")(rec) is None
    nothing = _record()
    nothing["trace"]["outside_nccl_s"] = 0.0
    assert cells.reader("busy_pct.dist")(nothing) is None
    assert cells.reader("busy_pct.dist")(_record(trace=dict(rec["trace"], outside_nccl_s=None))) \
        is None


def test_no_cards_no_result():
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", NAME, "--seed", "1",
                          "--seconds", "1"], cwd=ranks.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and not [ln for ln in _lines(out.stdout) if ln.startswith("{")]
    assert "found 0 CUDA cards" in out.stderr
