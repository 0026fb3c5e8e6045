"""GMRES's Gram-Schmidt step over the basis rows built so far
(`ops/gmres_cuda.py`, `csrc/gmres.cu`).

On the CPU: the plain versions give the coefficients, the new row and its
norm of the whole-basis products over a zero-padded basis, read no row
past the ones built, and a solve whose bases start filled with NaN is
bit for bit the solve whose bases start at zero. Tests marked ``card``
hold the kernels to the plain versions and count their launches; they
skip without a CUDA card. This file imports no JAX, so on the card it
runs without the suite's conftest:

    python -m pytest tests/test_torch_gmres_gs.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.ops import gmres_cuda, stencil_cuda

M = 8                                   # restart of the basis tests
SHAPE = (6, 5, 7)
EPS = {torch.float32: float(np.finfo(np.float32).eps),
       torch.float64: float(np.finfo(np.float64).eps)}


def basis(rows, shape, dtype, seed, device="cpu"):
    """`rows` orthonormal fields (QR in float64) and a field w that is not
    in their span."""
    n = math.prod(shape)
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, rows)))
    V = torch.as_tensor(q.T.copy()).reshape((rows,) + shape).to(dtype).to(device)
    w = torch.as_tensor(rng.standard_normal(shape)).to(dtype).to(device)
    return V, w


def whole_basis(V, j, w):
    """The whole-basis products over a basis zero-padded past row j: the
    coefficients h (M + 1 of them), the new row and its squared norm."""
    Vz = torch.zeros_like(V)
    Vz[:j + 1] = V[:j + 1]
    Vf = Vz.reshape(V.shape[0], -1)
    h = Vf @ w.reshape(-1)
    new = w - (h @ Vf).view(w.shape)
    return h, new, torch.sum(new * new)


@pytest.mark.parametrize("j", range(M))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_steps_match_the_whole_basis_products(dtype, j):
    """Step j over rows 0..j gives the whole-basis products' h[:j+1] (the
    rest of which are zeros), new row and norm, to rounding."""
    V, w = basis(M + 1, SHAPE, dtype, seed=j)
    h_ref, new_ref, ww_ref = whole_basis(V, j, w)
    assert not torch.any(h_ref[j + 1:])
    h = gmres_cuda.gs_dots(V, j + 1, w)
    out = torch.empty_like(w)
    ww = gmres_cuda.gs_update_norm(V, j + 1, h, w, out)
    tol = 64 * (j + 2) * EPS[dtype]
    scale = float(w.abs().max())
    assert h.shape == (j + 1,)
    assert float((h - h_ref[:j + 1]).abs().max()) <= tol * float(w.norm())
    assert float((out - new_ref).abs().max()) <= tol * scale
    assert float(ww) == pytest.approx(float(ww_ref), rel=tol)


@pytest.mark.parametrize("j", [0, 3, M - 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_past_the_built_ones_are_never_read(dtype, j):
    """A basis whose rows past j hold NaN gives finite results, bit-equal
    to those of the zero-padded basis."""
    V, w = basis(M + 1, SHAPE, dtype, seed=100 + j)
    Vz, Vn = V.clone(), V.clone()
    Vz[j + 1:] = 0.0
    Vn[j + 1:] = float("nan")
    got = []
    for B in (Vz, Vn):
        h = gmres_cuda.gs_dots(B, j + 1, w)
        ww = gmres_cuda.gs_update_norm(B, j + 1, h, w, B[j + 1])
        got.append((h, B[j + 1].clone(), ww))
    for a, b in zip(*got):
        assert bool(torch.isfinite(b).all())
        assert torch.equal(a, b)


METHODS = {
    "gmres-mg": ["-ksp_type", "gmres", "-pc_type", "mg"],
    "fgmres-mg": ["-ksp_type", "fgmres", "-pc_type", "mg"],
    "gmres-none": ["-ksp_type", "gmres", "-pc_type", "none"],
}


def nan_bases(monkeypatch, nbytes):
    """Every torch.empty of at least `nbytes` comes filled with NaN: the
    stacked bases, since nothing else a solve allocates is as large."""
    empty = torch.empty

    def filled(*size, **kw):
        t = empty(*size, **kw)
        if t.is_floating_point() and t.nbytes >= nbytes:
            t.fill_(float("nan"))
        return t

    monkeypatch.setattr(torch, "empty", filled)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_a_solve_never_reads_an_unbuilt_row(method, monkeypatch):
    """GMRES(3) and FGMRES(3) with MG (to convergence), and GMRES(3)
    without a preconditioner on the operator that hands K2's <V_j, A V_j>
    to the step (60 iterations), at 16^3 f64, each over several cycles:
    bases that start as NaN give the iterations, history and x of a solve
    whose bases start at zero."""
    argv = METHODS[method] + ["-gmres_restart", "3", "-ksp_rtol", "1e-10",
                              "-ksp_max_it", "60"]
    s = PoissonSolver((16,) * 3, dtype=torch.float64, device="cpu", options=Options(argv))
    b = s.rhs_for(s.random_solution(5))
    ref = s.solve(b)
    nan_bases(monkeypatch, 3 * b.nbytes)
    res = s.solve(b)
    assert int(ref.iterations) > 6
    assert (int(res.iterations), int(res.reason)) == (int(ref.iterations), int(ref.reason))
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.history.nan_to_num(), ref.history.nan_to_num())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


ROWS = (1, 7, 8, 9, 16, 31)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(64,) * 3, (128,) * 3, (33, 20, 27)])
def test_kernels_match_the_plain_versions(shape, dtype):
    """gs_dots and gs_update_norm against their plain versions for rows
    1, 7, 8, 9, 16 and 31 of a 32-row basis, the new row written into the
    next row of the basis: coefficients and norm to the sums' rounding,
    the row to the fused multiply-adds' (an odd size takes single-value
    loads)."""
    _need_card()
    V, w = basis(32, shape, dtype, seed=sum(shape), device="cuda")
    V = V * torch.linspace(0.5, 2.0, 32, dtype=dtype, device="cuda").view(-1, 1, 1, 1)
    eps = EPS[dtype]
    for rows in ROWS:
        h = gmres_cuda.gs_dots(V, rows, w)
        h_ref = gmres_cuda.gs_dots_plain(V, rows, w)
        absdot = (V[:rows].abs().reshape(rows, -1) @ w.abs().reshape(-1))
        assert bool(((h - h_ref).abs() <= 256 * eps * absdot).all()), rows
        V2, out_ref = V.clone(), torch.empty_like(w)
        ww = gmres_cuda.gs_update_norm(V2, rows, h_ref, w, V2[rows])
        ww_ref = gmres_cuda.gs_update_norm_plain(V, rows, h_ref, w, out_ref)
        bound = w.abs() + (h_ref.abs().view(-1, 1, 1, 1) * V[:rows].abs()).sum(0)
        assert bool(((V2[rows] - out_ref).abs() <= 2 * (rows + 1) * eps * bound).all()), rows
        assert float(ww) == pytest.approx(float(ww_ref), rel=256 * eps), rows
        assert torch.equal(V2[:rows], V[:rows]) and torch.equal(V2[rows + 1:], V[rows + 1:])


@pytest.mark.card
@pytest.mark.parametrize("pc", ["mg", "none"])
def test_each_step_launches_one_dots_and_one_update(pc):
    """GMRES(4) at 32^3 f64 on the card (with MG to 1e-8; without a
    preconditioner, where K2 hands the step its coefficient, for 40
    iterations): one gmres.dots and one gmres.update a Gram-Schmidt step,
    and one more gmres.update a cycle (x += V[:j] y)."""
    _need_card()
    s = PoissonSolver((32,) * 3, dtype=torch.float64, device="cuda", options=Options(
        ["-ksp_type", "gmres", "-pc_type", pc, "-gmres_restart", "4",
         "-ksp_rtol", "1e-8" if pc == "mg" else "1e-14", "-ksp_max_it", "40"]))
    assert (s.A.apply_dot is not None and s._solver.M is None) == (pc == "none")
    b = s.rhs_for(s.random_solution(2))
    stencil_cuda.reset_launches()
    res = s.solve(b)
    its = int(res.iterations)
    assert its > 4 and (int(res.reason) > 0 or its == 40)
    assert stencil_cuda.LAUNCHES["gmres.dots"] == its
    assert stencil_cuda.LAUNCHES["gmres.update"] == its + -(-its // 4)
