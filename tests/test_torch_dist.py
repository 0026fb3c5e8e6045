"""MG-CG across ranks: spawned gloo groups of CPU ranks against the JAX
package's sharded path; here (2, 2, 1) at 32^3.

Each decomposition is one spawn in a file of its own (so parallel test
workers run them side by side): a module-scoped fixture starts the ranks
(tests/torch_dist_worker.py, which imports the port only) and computes the
JAX package's side on its virtual CPU devices meanwhile; every check of
the spawn is a test case of its own (tests/torch_dist_common.py): the real
exchange against the global wrap, the sharded operators (<= 1e-12), one
V-cycle (<= 1e-10), the level stack, and an MG-CG solve to rtol 1e-8 (JAX's
iteration count, true residual <= 1.01 rtol, x within 1e-6 of JAX's x).
The other decompositions: test_torch_dist_411.py, _222.py, _311.py, _321.py.
The demo under torchrun runs here too.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_dist_common import *  # noqa: F401,F403  (the shared checks)
from torch_dist_common import run_case, test_mg_options_match_one_rank  # noqa: F401


@pytest.fixture(scope="module", params=[((2, 2, 1), 32)], ids=["221-32"])
def dist_run(request, tmp_path_factory):
    pgrid, n = request.param
    ranks, ref = run_case(pgrid, n, tmp_path_factory.mktemp("ranks"), mgopts=True, n6=32)
    return pgrid, n, ranks, ref


def test_demo_under_torchrun():
    """The demo on 3 gloo ranks under torchrun, as the reference runs
    `mpirun -np 3`: process 0 alone prints the DoF split, the ownership
    check and the verified residual."""
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(repo), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "3", "-m", "poissbox_tpu_torch.demo", "-n", "24",
         "-device", "cpu", "-ksp_rtol", "1e-8", "-ksp_converged_reason"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=150)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    text = out.stdout
    assert text.count("DoF distribution over 3 device(s): [4608, 4608, 4608]") == 1
    assert "ownership: process grid (3, 1, 1), 3 boxes tile the domain (sum ok)" in text
    line = next(ln for ln in text.splitlines() if ln.startswith("verification:"))
    rel = float(line.split("(relative ")[1].split(")")[0])
    assert rel <= 1.01e-8
