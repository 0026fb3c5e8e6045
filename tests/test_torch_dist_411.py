"""MG-CG across ranks, (4, 1, 1) at 32^3: four ranks along x, the coarsest
level (4^3, one plane a rank) replicated. The checks of
tests/torch_dist_common.py; see tests/test_torch_dist.py."""

import pytest

from torch_dist_common import *  # noqa: F401,F403  (the shared checks)
from torch_dist_common import run_case


@pytest.fixture(scope="module", params=[((4, 1, 1), 32)], ids=["411-32"])
def dist_run(request, tmp_path_factory):
    pgrid, n = request.param
    ranks, ref = run_case(pgrid, n, tmp_path_factory.mktemp("ranks"), n6=32)
    return pgrid, n, ranks, ref
