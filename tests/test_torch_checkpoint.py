"""The port's checkpointing: the npz round trip (readable by the JAX
package's loader), kill-and-resume equal to an uninterrupted chunked
solve, the exact foreign-RHS guard, and the facade's solve_checkpointed."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu import checkpoint as jcheckpoint
from poissbox_tpu.mesh import Grid3D as JGrid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator as jmake_operator
from poissbox_tpu.solvers.cg import cg as jcg
from poissbox_tpu_torch import checkpoint, interop
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.mesh import Grid3D, ProcessGrid
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.solvers.cg import cg

N = 16


def problem(seed=0):
    A = make_laplacian_operator(Grid3D((N,) * 3, device="cpu"))
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, (N,) * 3)
    return A, A(A.project(torch.as_tensor(u)))


def test_npz_round_trip(tmp_path):
    """Tensors go out as numpy and come back on the device asked for; the
    JAX package's loader reads the same file, field by field."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((4, 5, 6)))
    st = checkpoint.SolveCheckpoint(x=x, b=x.float(), iterations=7,
                                    residual_norm=1.5e-7)
    path = checkpoint.save(str(tmp_path / "sub" / "ckpt"), st.as_dict())
    assert path.endswith("ckpt.npz")
    back = checkpoint.load(str(tmp_path / "sub" / "ckpt"), device="cpu")
    assert back["x"].device.type == "cpu"
    again = checkpoint.SolveCheckpoint.from_dict(back)
    assert torch.equal(again.x, x) and torch.equal(again.b, x.float())
    assert (again.iterations, again.residual_norm) == (7, 1.5e-7)
    jst = jcheckpoint.SolveCheckpoint.from_dict(jcheckpoint.load(path))
    assert (jst.iterations, jst.residual_norm) == (7, 1.5e-7)
    np.testing.assert_array_equal(np.asarray(jst.x), x.numpy())
    # the state dicts of both packages convert field by field
    mine = interop.checkpoint_to_numpy(st.as_dict())
    theirs = interop.checkpoint_to_numpy(interop.checkpoint_from_numpy(
        jcheckpoint.SolveCheckpoint(x=jnp.asarray(x.numpy()), b=jnp.asarray(
            x.float().numpy()), iterations=7, residual_norm=1.5e-7).as_dict()))
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
        assert mine[k].dtype == theirs[k].dtype, k


def test_resume_from_a_saved_result_matches_jax(tmp_path):
    """The JAX package's test_resume_matches_uninterrupted, held to the
    JAX package: 20 CG iterations, saved, loaded, resumed."""
    A, b = problem(2)
    part = cg(A, b, rtol=1e-10, max_it=20)
    p = checkpoint.save(str(tmp_path / "solve"),
                        checkpoint.SolveCheckpoint.from_result(part, b=b).as_dict())
    st = checkpoint.SolveCheckpoint.from_dict(checkpoint.load(p, device="cpu"))
    resumed = cg(A, st.b, x0=st.x, rtol=1e-10, max_it=2000)
    jA = jmake_operator(JGrid3D((N,) * 3))
    jb = jnp.asarray(b.numpy())
    jpart = jcg(jA, jb, rtol=1e-10, max_it=20)
    jresumed = jcg(jA, jb, x0=jpart.x, rtol=1e-10, max_it=2000)
    assert bool(resumed.converged)
    assert int(resumed.iterations) == int(jresumed.iterations)
    np.testing.assert_allclose(resumed.x.numpy(), np.asarray(jresumed.x),
                               rtol=1e-8, atol=1e-11)


class Killed(Exception):
    pass


def test_kill_and_resume_equals_uninterrupted(tmp_path):
    """A run killed after chunk 0 and resumed ends with the uninterrupted
    run's total iterations and x exactly: the chunk boundaries are the
    same, and the iterate crosses the file exactly."""
    A, b = problem(3)
    kw = dict(rtol=1e-10, max_it=400, every=5)
    full, total = checkpoint.solve_with_checkpoints(A, b, str(tmp_path / "full"), **kw)
    assert bool(full.converged) and total > 10

    def kill(chunk, result):
        if chunk == 0:
            raise Killed

    path = str(tmp_path / "killed")
    with pytest.raises(Killed):
        checkpoint.solve_with_checkpoints(A, b, path, on_chunk=kill, **kw)
    assert checkpoint.SolveCheckpoint.from_dict(
        checkpoint.load(path, device="cpu")).iterations == 5
    res, total2 = checkpoint.solve_with_checkpoints(A, b, path, **kw)
    assert total2 == total
    assert float((res.x - full.x).abs().max()) == 0.0


def test_foreign_rhs_one_ulp_away_starts_fresh(tmp_path):
    """The port's guard is exact equality: a b that differs from the
    saved one in one element by one ulp is another problem, so the solve
    starts from zero (the JAX package's allclose would resume it)."""
    A, b = problem(4)
    path = str(tmp_path / "ckpt")
    kw = dict(rtol=1e-10, max_it=400, every=5)

    def kill(chunk, result):
        raise Killed

    with pytest.raises(Killed):
        checkpoint.solve_with_checkpoints(A, b, path, on_chunk=kill, **kw)
    b2 = b.clone()
    b2[1, 2, 3] = torch.nextafter(b2[1, 2, 3], torch.tensor(np.inf, dtype=b.dtype))
    assert not torch.equal(b2, b) and torch.allclose(b2, b)
    seen = []
    res, total = checkpoint.solve_with_checkpoints(
        A, b2, path, on_chunk=lambda c, r: seen.append(int(r.iterations)), **kw)
    fresh, total_fresh = checkpoint.solve_with_checkpoints(
        A, b2, str(tmp_path / "fresh"), **kw)
    assert total == total_fresh == sum(seen)
    assert torch.equal(res.x, fresh.x)
    # the same b resumes: the saved chunks are not run again
    resumed, total3 = checkpoint.solve_with_checkpoints(A, b2, path, **kw)
    assert total3 == total and int(resumed.iterations) == 0


def test_solve_checkpointed_on_the_facade(tmp_path):
    s = PoissonSolver((N,) * 3, dtype=torch.float64, device="cpu")
    u = s.A.project(torch.as_tensor(np.random.default_rng(5).uniform(-1, 1, (N,) * 3)))
    b = s.rhs_for(u)
    path = str(tmp_path / "facade")

    def kill(chunk, result):
        raise Killed

    res, total = s.solve_checkpointed(b, path, rtol=1e-8, every=2)
    assert bool(res.converged) and s.residual_norm(res.x, b) <= 1e-8 * 1.01
    st = checkpoint.SolveCheckpoint.from_dict(checkpoint.load(path, device="cpu"))
    assert st.iterations == total and torch.equal(st.x, res.x)
    with pytest.raises(Killed):
        from poissbox_tpu_torch.solvers.mg import MGConfig, make_mg_preconditioner
        M = make_mg_preconditioner(s.grid.n, s.grid.deltas, MGConfig(),
                                   device="cpu")
        checkpoint.solve_with_checkpoints(s.A, b, path + "2", M=M, rtol=1e-8,
                                          every=2, on_chunk=kill)
    res2, total2 = s.solve_checkpointed(b, path + "2", rtol=1e-8, every=2)
    assert total2 == total and torch.equal(res2.x, res.x)


def test_checkpoint_path_names_each_rank(tmp_path):
    """One rank: `path` itself (the .npz beside it); over a process grid
    one file a rank under the directory `path`, by rank and world size."""
    path = str(tmp_path / "ck")
    assert checkpoint.checkpoint_path(path) == path
    assert checkpoint.checkpoint_path(path, Grid3D((8,) * 3, device="cpu")) == path
    one = Grid3D((8,) * 3, device="cpu", mesh=ProcessGrid((1, 1, 1), 0))
    assert checkpoint.checkpoint_path(path, one) == path
    names = {checkpoint.checkpoint_path(path, Grid3D((8,) * 3, device="cpu",
                                                     mesh=ProcessGrid((2, 2, 1), r)))
             for r in range(4)}
    assert names == {os.path.join(path, f"rank{r}of4") for r in range(4)}
    # written under a temporary name and renamed: nothing else is left
    f = checkpoint.save(os.path.join(path, "rank3of4"), {"x": torch.ones(2)})
    assert os.listdir(path) == ["rank3of4.npz"] and f.endswith("rank3of4.npz")


@pytest.mark.parametrize("case,oks,its,resume", [
    ("every rank may", [True] * 4, [6, 6, 6, 6], True),
    ("b differs on one rank", [True, False, True, True], [6, 6, 6, 6], False),
    ("killed between two writes", [True] * 4, [6, 6, 4, 6], False),
    ("one rank has no file", [True, True, True, False], [6, 6, 6, -1], False),
])
def test_resume_verdict_is_every_ranks(case, oks, its, resume):
    """Every rank reaches the same verdict from its own: all resume only
    if every one may and all saved the same iteration count."""
    vectors = [torch.tensor([0.0 if ok else 1.0, k, -k], dtype=torch.float64)
               for ok, k in zip(oks, its)]

    def group(rank):
        def allreduce_max(t):
            assert torch.equal(t, vectors[rank])
            return torch.stack(vectors).max(0).values
        return allreduce_max

    got = [checkpoint.resume_verdict(ok, k, group(r)) for r, (ok, k) in enumerate(zip(oks, its))]
    assert got == [resume] * 4, case
    # one rank decides alone
    assert checkpoint.resume_verdict(oks[1], its[1]) == oks[1]


def test_rank_blocks_need_the_grid(tmp_path):
    """An operator on rank blocks (it carries an all-reduce) cannot save to
    one file: the grid names each rank's."""
    A, b = problem(6)
    A_blocks = dataclasses.replace(A, allreduce=lambda t: t)
    with pytest.raises(ValueError, match="grid"):
        checkpoint.solve_with_checkpoints(A_blocks, b, str(tmp_path / "ck"))
