"""Structured grid, single device (port of the single-device part of
:mod:`poissbox_tpu.mesh`).

Axis convention: tensor dims are (x, y, z), C order, z contiguous — the
JAX package's layout, so fields compare one to one. Meshes, sharding and
uneven layouts come with the multi-device slice (ROADMAP.md). A grid lives
on the card unless its `device` says otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from poissbox_tpu_torch.constants import default_real


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A periodic, uniform, cell-centred 3-D grid on one device (the card
    unless `device` says otherwise; the CPU only when asked for).

    Scalar fields live at cell centres x_i = (i + 1/2) dx.
    """

    n: tuple[int, int, int]
    length: tuple[float, float, float] = (1.0, 1.0, 1.0)
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        object.__setattr__(self, "n", tuple(int(v) for v in self.n))
        object.__setattr__(self, "length", tuple(float(v) for v in self.length))
        object.__setattr__(self, "device", torch.device(self.device))

    # -- geometry ----------------------------------------------------------
    @property
    def deltas(self) -> tuple[float, float, float]:
        return tuple(L / n for L, n in zip(self.length, self.n))

    @property
    def ndof(self) -> int:
        return int(np.prod(self.n))

    def dof_counts(self) -> list[int]:
        """Per-device DoF counts: one device holds them all."""
        return [self.ndof]

    def cells(self, dim: int, dtype=None) -> torch.Tensor:
        """Cell-centre coordinates along `dim`: (i + 1/2) * d."""
        i = torch.arange(self.n[dim], dtype=dtype or default_real(),
                         device=self.device)
        return (i + 0.5) * self.deltas[dim]

    def vertices(self, dim: int, dtype=None) -> torch.Tensor:
        """Vertex coordinates along `dim`: i * d."""
        i = torch.arange(self.n[dim], dtype=dtype or default_real(),
                         device=self.device)
        return i * self.deltas[dim]

    def coords(self, staggered: tuple[bool, bool, bool] = (False, False, False),
               dtype=None):
        """Meshgrid (X, Y, Z) of cell-centre (or vertex, where staggered)
        coordinates."""
        axes = [self.vertices(d, dtype) if staggered[d] else self.cells(d, dtype)
                for d in range(3)]
        return torch.meshgrid(*axes, indexing="ij")

    # -- field constructors -------------------------------------------------
    def random(self, generator: Optional[torch.Generator] = None, dtype=None,
               minval: float = -1.0, maxval: float = 1.0) -> torch.Tensor:
        """Uniform random field in [minval, maxval) drawn from `generator`
        (on the generator's device, then placed on the grid's)."""
        gdev = generator.device if generator is not None else "cpu"
        f = torch.rand(self.n, generator=generator, dtype=dtype or default_real(),
                       device=gdev)
        return (f * (maxval - minval) + minval).to(self.device)
