"""`-log_view` and the profiling helpers of the port against the JAX
package (ports of tests/test_round3.py's log_view case and
tests/test_utils.py's timer cases).

The table's events are held to the JAX package's on the same problem, and
its counts to the logged solve's spans (the JAX package assumes MatMult
it+1 and PCApply it; CG from a zero guess applies A it times and M it+1
times); the times are host times here and are only checked to be positive.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.config import Options as JOptions
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.solvers.ksp import solve as jsolve
from poissbox_tpu_torch import demo
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers.ksp import solve
from poissbox_tpu_torch.utils import kernel_time, trace
from poissbox_tpu_torch.utils.profiling import bandwidth_gbps, device_times, solve_time

ARGV = ["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-6", "-log_view"]


def _problem(n=8):
    grid = Grid3D((n,) * 3, device="cpu")
    A = make_laplacian_operator(grid)
    u = np.random.default_rng(4).uniform(-1.0, 1.0, grid.n)
    return grid, A, A(A.project(torch.as_tensor(u))), u


def _events(out: str) -> list:
    """(event, count) of each table row: the name in a 10-wide column, the
    count (blank for "other") in the 5-wide column after it."""
    return [(ln[12:22].strip(), ln[23:28].strip()) for ln in out.splitlines()
            if ln.startswith("log_view:   ")]


def test_log_view(capsys):
    """The port of tests/test_round3.py:74-88: the per-event table."""
    grid, A, b, _ = _problem()
    solve(A, b, Options(list(ARGV)), grid=grid)
    out = capsys.readouterr().out
    assert "log_view:   setup" in out and "log_view:   solve" in out
    assert "iterations" in out
    assert "log_view:   MatMult" in out
    assert "log_view:   PCApply" in out
    assert "time/call" in out


@pytest.mark.parametrize("pc", ["jacobi", "mg"])
def test_log_view_events_match_jax(capsys, pc):
    """The same events as the JAX package's table, counted by the logged
    solve's spans: CG from a zero guess applies A once an iteration and M
    once more (its last iteration applies M before the stopping test)."""
    argv = ["-ksp_type", "cg", "-pc_type", pc, "-ksp_rtol", "1e-6", "-log_view"]
    grid, A, b, u = _problem()
    res = solve(A, b, Options(list(argv)), grid=grid)
    got = capsys.readouterr().out
    jgrid = JGrid3D((8,) * 3)
    jA = jmake_operator(jgrid)
    jb = jA(jA.project(jnp.asarray(u)))
    jres = jsolve(jA, jb, JOptions(list(argv)), shape=jgrid.n, deltas=jgrid.deltas)
    ref = capsys.readouterr().out
    assert int(res.iterations) == int(jres.iterations)
    assert [e for e, _ in _events(got)] == [e for e, _ in _events(ref)]
    it = int(res.iterations)
    assert ("MatMult", str(it + 1)) in _events(ref)
    assert ("PCApply", str(it)) in _events(ref)
    assert ("MatMult", str(it)) in _events(got)
    assert ("PCApply", str(it + 1)) in _events(got)


def test_log_view_with_options_error_if_unused():
    """`-log_view` is read: with -options_error_if_unused the solve no
    longer raises (it raised "option(s) set but never used: -log_view")."""
    grid, A, b, _ = _problem()
    res = solve(A, b, Options(ARGV + ["-options_error_if_unused"]), grid=grid)
    assert res.reason_enum() > 0


def test_demo_log_view(capsys):
    """The demo with -log_view -options_error_if_unused prints the table
    and returns the converged residual."""
    rel = demo.run(Options(["-n", "16", "-device", "cpu", "-ksp_rtol", "1e-8",
                            "-log_view", "-options_error_if_unused"]))
    out = capsys.readouterr().out
    assert rel < 1e-7
    names = [e[0] for e in _events(out)]
    assert names == ["MatMult", "PCApply", "other", "setup", "solve"]
    assert "WARNING" not in out


def test_log_view_monitor_prints_one_history(capsys):
    """With -ksp_monitor the warm re-run prints no second history."""
    grid, A, b, _ = _problem()
    res = solve(A, b, Options(ARGV + ["-ksp_monitor"]), grid=grid)
    out = capsys.readouterr().out
    assert out.count("KSP Residual norm") == int(res.iterations) + 1


class TestProfiling:
    def test_kernel_time_positive_and_sane(self):
        f = lambda v: v * 2.0 + 1.0
        t = kernel_time(f, torch.ones((64, 64)), lo=2, hi=10, reps=1)
        assert 0 < t < 1.0

    def test_bandwidth_positive(self):
        gb = bandwidth_gbps(lambda v: v + 1.0, torch.ones((128, 128)),
                            lo=2, hi=10, reps=1)
        assert gb > 0

    def test_kernel_time_scale_keeps_values_finite(self):
        seen = []

        def f(v):
            seen.append(bool(torch.isfinite(v).all()))
            return v * 1e6
        kernel_time(f, torch.ones(16), lo=2, hi=8, reps=1, scale=1e-6)
        assert seen and all(seen)

    def test_solve_time_positive(self):
        grid, A, b, _ = _problem()
        from poissbox_tpu_torch.solvers.cg import cg
        t = solve_time(lambda rhs: cg(A, rhs, rtol=1e-4), b, lo=1, hi=2, reps=1)
        assert 0 < t < 10.0

    def test_trace_on_cpu(self, tmp_path):
        with trace(str(tmp_path)) as prof:
            torch.ones(32, 32) @ torch.ones(32, 32)
        assert (tmp_path / "trace.json").exists()
        assert device_times(prof) == {}
