"""MG-CG across ranks on a decomposition that does not divide the grid:
(3, 1, 1) at 64^3, the reference's `mpirun -np 3` split (90112/86016/86016
DoF), against the JAX package's padded-layout path. Rank 2's box starts at
x = 43, an odd offset, where K11's colour is XOR'd with the offset parity.
The checks of tests/torch_dist_common.py (see tests/test_torch_dist.py),
and a solve with the Jacobi smoother (K10 on the fine level) against the
port's one-rank solve of the same system.
"""

import numpy as np
import pytest

from torch_dist_common import *  # noqa: F401,F403  (the shared checks)
from torch_dist_common import (blocks, run_case, test_mg_options_match_one_rank,  # noqa: F401
                               test_krylov_matches_jax, test_fgmres_matches_one_rank,
                               test_solve_refined_matches_jax,
                               test_solve_checkpointed_matches_jax,
                               test_checkpoint_kill_and_resume_equals_uninterrupted,
                               test_checkpoint_starts_fresh_on_every_rank,
                               test_restart_length_agreed_over_boxes)


@pytest.fixture(scope="module", params=[((3, 1, 1), 64)], ids=["311-64"])
def dist_run(request, tmp_path_factory):
    pgrid, n = request.param
    ranks, ref = run_case(pgrid, n, tmp_path_factory.mktemp("ranks"), jacobi=True,
                          mgopts=True, krylov=True, n6=16)
    return pgrid, n, ranks, ref


def test_reference_split(dist_run):
    pgrid, n, ranks, ref = dist_run
    assert [list(r["dofs"]) for r in ranks] == [[90112, 86016, 86016]] * 3
    assert [tuple(r["offset"]) for r in ranks] == [(0, 0, 0), (22, 0, 0), (43, 0, 0)]


def test_jacobi_mgcg_matches_one_rank(dist_run):
    pgrid, n, ranks, ref = dist_run
    one = ranks[0]
    assert {int(r["jacobi.its"]) for r in ranks} == {int(one["jacobi1.its"])}
    for r in ranks:
        assert float(r["jacobi.rel"]) <= 1.01e-8
    got = np.concatenate([r["jacobi.x"].ravel() for r in ranks])
    want = np.concatenate([b.ravel() for b in blocks(one["jacobi1.x"], n, pgrid)])
    assert np.linalg.norm(got - want) <= 1e-10 * np.linalg.norm(want)
