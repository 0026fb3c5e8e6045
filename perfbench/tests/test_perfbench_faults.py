"""Whole runs on the CPU, the look for a card skipped, with the timed path
sound and broken underneath (``perfbench/faults.py``): ``correct`` has to
come out true and false. The faults a solve can have: a solve that
returns its state unchanged (x = 0), an answer altered where it is
produced (one cell of x), a solve reported unconverged, and for the
compact operator the 7-point Laplacian in K15's place or in the spectral
solve's. (A solve has one right-hand side, so there is no batch to
halve; a cell runs on one card, so there is no exchange to leave out.)"""

import sys

import pytest

from perfbench import faults, judge
from perfbench import run as harness
from perfbench_helpers import cpu_run, small_cell

CELLS = ["poisson7.512.f32", "compact6.512.fft", "poisson7.64.f64"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = small_cell(name, 32)
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cell["limits"]) | {"unconverged"}


@pytest.mark.parametrize("name", ["poisson7.512.f32", "compact6.512.fft"])
def test_sound_traced_run_reads_its_per_layer_metrics(name):
    res = cpu_run(small_cell(name), trace=True)
    assert res["correct"]
    assert "build_s" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


@pytest.mark.parametrize("fault,name", [(f, n) for f in ("unchanged", "altered", "unconverged")
                                        for n in CELLS]
                         + [("k15_lapl7", "compact6.512.fft"),
                            ("solve_lapl7", "compact6.512.fft")])
def test_a_planted_fault_is_not_correct(fault, name):
    cell = small_cell(name, 32)
    with faults.planted(fault):
        res = cpu_run(cell)
    assert not res["correct"] and res["failed"] >= 1, res["checks"]
    over = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    want = {"unchanged": set(cell["limits"]) - {"residual_gap"}, "unconverged": {"unconverged"},
            "k15_lapl7": {"residual_gap"}, "solve_lapl7": {"error"}}.get(fault)
    if want is not None:
        assert want <= over, res["checks"]


def test_faults_are_taken_out_again():
    from poissbox_tpu_torch.api import PoissonSolver
    from poissbox_tpu_torch.ops import compact
    before = (PoissonSolver.solve, compact.lapl)
    for name in faults.FAULTS:
        with faults.planted(name):
            pass
    assert (PoissonSolver.solve, compact.lapl) == before


def test_forbidden_modules_refuse_the_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]
    with pytest.raises(SystemExit) as e:
        harness.refuse_forbidden()
    assert e.value.code == 3
    assert "jax.numpy" in capsys.readouterr().err
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "poissbox_tpu_torchx", sys)
    assert harness.forbidden_modules() == []


def test_checks_and_limits():
    limits = {"residual": 2e-6}
    judged = [{"residual": 1e-7}, {"residual": float("nan")}]
    checks = judge.numbers(judged, [2, 2], limits)
    assert checks["residual"]["value"] == judge.NOT_FINITE and not judge.passed(checks)
    assert judge.failed_count(judged, [2, -3], limits) == 2
    assert judge.numbers([], [2], {"error": 1.0})["error"]["value"] == judge.NOT_FINITE
    s = judge.Sampler(5, 4)
    for i in range(40):
        s.offer(i, i)
    assert sorted(s.kept) == [0, 1, 2, 3] and all(i % 4 == slot for slot, (i, _) in s.kept.items())
