"""The traffic: a pool of right-hand sides made on the device from the
seed, which the closed loop hands to the solver in turn.

Each right-hand side is b = A u for a mean-free u, with A the reference
operator of the configuration's order, applied in float64 and rounded
once to the cell's dtype. The traffic file's "field" says which u:

  * "uniform": u uniform in (-1, 1), every cell drawn from the seed (the
    upstream's example.f90 set_solution);
  * "band": uniform noise in (-1, 1) filtered to a Gaussian band of the
    traffic file's "band" wavenumber k0 (each Fourier mode's amplitude
    times exp(-|k|^2 / (2 k0^2)), k in waves across the box), then scaled
    to unit RMS: broadband content up to a few k0 and none near the
    Nyquist modes, which the staggered interpolation annihilates. Every
    seed gives the same spectrum's envelope with other phases.

One torch.Generator on the device, seeded once, draws the fields in pool
order, so the same seed gives the same pool on any card.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from perfbench.reference import operators

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def deltas(shape: Sequence[int], length: Sequence[float]) -> tuple[float, float, float]:
    return tuple(float(L) / n for n, L in zip(shape, length))


def _band(shape, k0: float, gen: torch.Generator) -> torch.Tensor:
    device = gen.device
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float64, device=device)
    uh = torch.fft.rfftn(u.mul_(2.0).sub_(1.0))
    del u
    for ax, n in enumerate(shape):
        k = (torch.fft.rfftfreq(n, 1.0 / n, dtype=torch.float64, device=device) if ax == 2
             else torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64, device=device))
        view = [1, 1, 1]
        view[ax] = -1
        uh *= torch.exp(-0.5 * (k / k0) ** 2).view(view)
    u = torch.fft.irfftn(uh, s=tuple(shape))
    del uh
    return u.div_(torch.sqrt(torch.mean(u * u)))


def field(kind: str, shape, gen: torch.Generator, band: float | None = None) -> torch.Tensor:
    """One mean-free float64 u on the generator's device."""
    device = gen.device
    if kind == "band":
        u = _band(shape, float(band), gen)
    elif kind == "uniform":
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float64, device=device)
        u.mul_(2.0).sub_(1.0)
    else:
        raise ValueError(f"unknown field {kind!r} (expected uniform|band)")
    u -= u.mean()
    return u


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


def right_hand_sides(cell: dict, seed: int, device) -> Iterator[torch.Tensor]:
    """The cell's pool in order: global right-hand sides in the cell's
    dtype, made one at a time (the float64 work is freed between them)."""
    shape, length = cell["grid"], cell["length"]
    order = cell["config_spec"]["order"]
    dtype = DTYPES[cell["dtype"]]
    d = deltas(shape, length)
    gen = generator(seed, device)
    for _ in range(cell["pool"]):
        u = field(cell["field"], shape, gen, cell.get("band"))
        b = operators.apply(order, u, d)
        del u
        yield b.to(dtype)
        del b
