"""Package-level properties of the port: it never imports jax, a CUDA
request never runs on the CPU, and results convert to and from numpy.
(The kernels themselves are checked on the card by chip_smoke.py.)
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.solvers.result import SolveResult as JSolveResult
from poissbox_tpu.solvers.result import classify as jclassify
from poissbox_tpu_torch import constants, interop
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import _build, stencil_cuda
from poissbox_tpu_torch.solvers.result import ConvergedReason, SolveResult, classify

REPO = Path(__file__).resolve().parent.parent


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import poissbox_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'poissbox_tpu' or k.startswith('poissbox_tpu.'))\n"
        "print(len([k for k in sys.modules if k.startswith('poissbox_tpu_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15   # every submodule was imported


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PoissonSolver((8, 8, 8), device="cuda")


WRAPPERS = {
    "apply_laplacian_cuda": lambda u, d: stencil_cuda.apply_laplacian_cuda(u, d),
    "apply_laplacian_dot_cuda": lambda u, d: stencil_cuda.apply_laplacian_dot_cuda(u, d),
    "residual_cuda": lambda u, d: stencil_cuda.residual_cuda(u, u, d),
    "sor_rb_zero_sweep_cuda": lambda u, d: stencil_cuda.sor_rb_zero_sweep_cuda(u, d, 1.0),
    "sor_rb_zero_update_cuda": lambda u, d: stencil_cuda.sor_rb_zero_update_cuda(
        u, u, 0.5, d, 1.0),
    "sor_rb_sweep_cuda": lambda u, d: stencil_cuda.sor_rb_sweep_cuda(u, u, d, 1.0),
    "sor_rb_multisweep_cuda": lambda u, d: stencil_cuda.sor_rb_multisweep_cuda(
        u, u, d, 1.0, 2, dots=True),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_refuse_non_cpu_non_cuda_tensors(name):
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise — never compute on the CPU."""
    u = torch.empty((8, 8, 8), dtype=torch.float32, device="meta")
    stencil_cuda.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        WRAPPERS[name](u, (0.125,) * 3)
    assert not any(stencil_cuda.LAUNCHES.values())


def test_build_raises_without_nvcc(monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_output_is_content_addressed():
    path = _build.library_path()
    assert path.parent == REPO / "poissbox_tpu_torch" / "_build"
    assert "poissbox_tpu_torch/_build/" in (REPO / ".gitignore").read_text()
    assert path.name.startswith("libpoissbox_kernels_") and path.suffix == ".so"
    for src in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / src).is_file()


def _jax_result():
    rng = np.random.default_rng(31)
    hist = np.full(6, np.nan)
    hist[:3] = [1.0, 1e-3, 1e-7]
    return JSolveResult(x=jnp.asarray(rng.standard_normal((4, 4, 4))),
                        iterations=jnp.int32(2),
                        residual_norm=jnp.asarray(1e-7),
                        history=jnp.asarray(hist),
                        reason=jnp.int32(ConvergedReason.CONVERGED_RTOL))


def test_interop_round_trips_a_solve_result():
    jres = _jax_result()
    res = interop.solve_result_from_numpy(jres)
    assert isinstance(res, SolveResult)
    back = interop.solve_result_to_numpy(res)
    for f in SolveResult._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jres, f)))
    again = interop.solve_result_from_numpy(back)
    assert again.reason_enum() is ConvergedReason.CONVERGED_RTOL
    assert again.monitor_lines() == jres.monitor_lines()
    x = np.arange(6.0).reshape(1, 2, 3)
    np.testing.assert_array_equal(
        interop.to_numpy(interop.to_torch(x, dtype=torch.float32)),
        x.astype(np.float32))


@pytest.mark.parametrize("resnorm", [float("nan"), 0.0, 1e-9, 0.5])
def test_classify_matches_jax(resnorm):
    args = (1.0, 1e-6, 1e-50, 10)
    got = classify(torch.tensor(resnorm, dtype=torch.float64), 3,
                   torch.tensor(args[0], dtype=torch.float64), *args[1:])
    ref = jclassify(jnp.asarray(resnorm), 3, jnp.asarray(args[0]), *args[1:])
    assert int(got) == int(ref)


def test_grid_and_constants():
    g = Grid3D((4, 6, 8), (1.0, 3.0, 2.0))
    assert g.deltas == (0.25, 0.5, 0.25) and g.ndof == 192
    assert g.dof_counts() == [192]
    a = g.random(torch.Generator().manual_seed(3), torch.float64)
    b = g.random(torch.Generator().manual_seed(3), torch.float64)
    assert torch.equal(a, b) and a.shape == (4, 6, 8)
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0
    assert g.random().dtype == constants.default_real() == torch.float32
    assert constants.epsilon(torch.float64) == np.finfo(np.float64).eps
