"""MG-CG across ranks, (3, 2, 1) at 24^3: x split three ways and y two. The
checks of tests/torch_dist_common.py; see tests/test_torch_dist.py."""

import pytest

from torch_dist_common import *  # noqa: F401,F403  (the shared checks)
from torch_dist_common import run_case


@pytest.fixture(scope="module", params=[((3, 2, 1), 24)], ids=["321-24"])
def dist_run(request, tmp_path_factory):
    pgrid, n = request.param
    ranks, ref = run_case(pgrid, n, tmp_path_factory.mktemp("ranks"), n6=18)
    return pgrid, n, ranks, ref
