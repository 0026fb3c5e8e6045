"""The fused transfer legs' kernels (`ops/transfer_cuda.py`,
`csrc/xfer.cu`) on the card.

K6 (`residual_restrict_cuda`) and K7 (`prolong_add_cuda`) are held bit for
bit to their plain versions in every dtype pair (f32, f64, a bf16 iterate
with f32 and with f64), with cubic and anisotropic cells, at 512^3, at
(48, 40, 96), at the ragged (40, 36, 52) and at the small levels
16^3 -> 8^3 and 8^3 -> 4^3; MG-CG on the card reaches neither banded
contraction, counts one launch of each leg a kernel level and cycle, and
takes the plain path's iterations. Every test is marked ``card`` and skips
without a CUDA card. This file imports no JAX, so on the card it runs
without the suite's conftest:

    python -m pytest tests/test_torch_transfers_card.py --noconftest -q
"""

import pytest
import torch

from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.ops import stencil_cuda, transfer_cuda
from poissbox_tpu_torch.solvers import mg

SHAPES = [(512, 512, 512), (48, 40, 96), (40, 36, 52), (16, 16, 16), (8, 8, 8)]
SHAPE_IDS = ["512^3", "48x40x96", "40x36x52", "16^3", "8^3"]
DELTAS = {"cubic": (0.5, 0.5, 0.5), "aniso": (1.0, 0.75, 1.5)}
# (iterate dtype, dtype of b, e and the output)
PAIRS = {"f32": (torch.float32, torch.float32), "f64": (torch.float64, torch.float64),
         "bf16u-f32": (torch.bfloat16, torch.float32),
         "bf16u-f64": (torch.bfloat16, torch.float64)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def rand(shape, dtype, g):
    return (torch.rand(shape, generator=g, dtype=torch.float64, device="cuda") * 2
            - 0.75).to(dtype)


def key(mode, pair):
    return mode + (".bf16u" if pair.startswith("bf16u") else "")


@pytest.mark.card
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("cells", DELTAS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_restrict_kernel_equals_plain(shape, cells, pair):
    """K6: (u, b) to the coarse residual in one launch, bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    tu, t = PAIRS[pair]
    u, b = rand(shape, tu, g), rand(shape, t, g)
    d = DELTAS[cells]
    k = key("xfer.restrict", pair)
    before = stencil_cuda.LAUNCHES[k]
    got = transfer_cuda.residual_restrict_cuda(u, b, d)
    ref = transfer_cuda.residual_restrict_plain(u, b, d)
    torch.cuda.synchronize()
    assert stencil_cuda.LAUNCHES[k] == before + 1
    assert got.dtype == t and tuple(got.shape) == tuple(n // 2 for n in shape)
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_prolong_add_kernel_equals_plain(shape, pair):
    """K7: u + P e in one launch, bit for bit; u is not written."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + 1)
    tu, t = PAIRS[pair]
    u = rand(shape, tu, g)
    e = rand(tuple(n // 2 for n in shape), t, g)
    u0 = u.clone()
    k = key("xfer.prolong_add", pair)
    before = stencil_cuda.LAUNCHES[k]
    got = transfer_cuda.prolong_add_cuda(u, e)
    ref = transfer_cuda.prolong_add_plain(u, e)
    torch.cuda.synchronize()
    assert stencil_cuda.LAUNCHES[k] == before + 1
    assert got.dtype == t and tuple(got.shape) == shape
    assert torch.equal(u, u0)
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("n,dtype,rtol", [(64, torch.float64, 1e-8),
                                          (128, torch.float32, 1e-6)])
def test_mgcg_legs_on_the_card(monkeypatch, n, dtype, rtol):
    """MG-CG on the card never reaches the banded contractions, launches
    each leg once a kernel level and V-cycle, and takes the iterations of
    the same call graph on the CPU (the plain versions)."""
    _need_card()

    def refuse(*args, **kwargs):
        raise AssertionError("a fused leg reached the banded contractions")

    monkeypatch.setattr(mg, "_contract", refuse)
    opts = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
            "-ksp_max_it", "50", "-mg_impl", "cuda", "-mg_transfers", "matmul"]
    card = PoissonSolver((n,) * 3, dtype=dtype, device="cuda", options=Options(opts))
    cpu = PoissonSolver((n,) * 3, dtype=dtype, device="cpu", options=Options(opts))
    b = card.rhs_for(card.random_solution(3))
    stencil_cuda.reset_launches()
    res = card.solve(b)
    torch.cuda.synchronize()
    ref = cpu.solve(b.cpu())
    fused = len(card._solver.M.levels) - 1
    legs = sum(v for k, v in stencil_cuda.LAUNCHES.items() if k.startswith("xfer.restrict"))
    ups = sum(v for k, v in stencil_cuda.LAUNCHES.items()
              if k.startswith("xfer.prolong_add"))
    assert legs == ups and legs > 0 and legs % fused == 0
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.reason) > 0
