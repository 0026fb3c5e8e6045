"""MG-CG across ranks, (2, 2, 2) at 16^3: 8 ranks, every axis split, every
level down to the coarsest distributed (the coarse solve gathers a
distributed level). The checks of tests/torch_dist_common.py; see
tests/test_torch_dist.py."""

import pytest

from torch_dist_common import *  # noqa: F401,F403  (the shared checks)
from torch_dist_common import run_case


@pytest.fixture(scope="module", params=[((2, 2, 2), 16)], ids=["222-16"])
def dist_run(request, tmp_path_factory):
    pgrid, n = request.param
    ranks, ref = run_case(pgrid, n, tmp_path_factory.mktemp("ranks"), n6=16)
    return pgrid, n, ranks, ref
