"""Assembled stencil-operator view (port of
:mod:`poissbox_tpu.ops.assemble`): the (3, 3, 3) coefficient box stored
explicitly, applied as a periodic shift-and-scale contraction, convertible
to a dense matrix for tests."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from poissbox_tpu_torch.ops.coefficients import lapl_star_coeffs


@dataclasses.dataclass(frozen=True)
class StencilMatrix:
    """An assembled constant-coefficient 3x3x3 box-stencil operator.

    Attributes:
      box: (3, 3, 3) coefficient box, centre at [1, 1, 1].
      shape: grid shape the operator acts on.
    """

    box: torch.Tensor
    shape: tuple[int, int, int]

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.apply(u)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """y = M u by periodic shift-and-scale over the nonzero box
        entries."""
        if tuple(u.shape) != tuple(self.shape):
            raise ValueError(f"field shape {tuple(u.shape)} != operator "
                             f"shape {self.shape}")
        box = self.box.cpu().numpy()
        out = torch.zeros_like(u)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    c = float(box[di + 1, dj + 1, dk + 1])
                    if c == 0.0:
                        continue
                    out = out + c * torch.roll(u, (-di, -dj, -dk), (0, 1, 2))
        return out

    def diagonal(self) -> torch.Tensor:
        return self.box[1, 1, 1]

    def row(self, i: int, j: int, k: int) -> dict[tuple[int, int, int], float]:
        """Nonzero (column -> value) entries of one matrix row; on an axis
        of extent <= 2 the periodic offsets wrap onto one column and sum."""
        box = self.box.cpu().numpy()
        nx, ny, nz = self.shape
        out: dict[tuple[int, int, int], float] = {}
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    v = float(box[di + 1, dj + 1, dk + 1])
                    if v == 0.0:
                        continue
                    key = ((i + di) % nx, (j + dj) % ny, (k + dk) % nz)
                    out[key] = out.get(key, 0.0) + v
        return out

    def to_dense(self) -> np.ndarray:
        """Dense (N, N) matrix, N = prod(shape). For tests only."""
        nx, ny, nz = self.shape
        A = np.zeros((nx * ny * nz,) * 2)
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    r = (i * ny + j) * nz + k
                    for (ci, cj, ck), v in self.row(i, j, k).items():
                        A[r, (ci * ny + cj) * nz + ck] += v
        return A


def assemble_laplacian(shape: Sequence[int], deltas: Sequence[float],
                       dtype=torch.float64, device="cpu") -> StencilMatrix:
    """Assemble the periodic 7-point Laplacian."""
    dx, dy, dz = deltas
    box = lapl_star_coeffs(dx, dy, dz, dtype=dtype).to(device)
    return StencilMatrix(box=box, shape=tuple(shape))
