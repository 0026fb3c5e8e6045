"""Structured grid over a process grid (port of :mod:`poissbox_tpu.mesh`).

The reference creates a periodic 3-D DMDA and lets PETSc pick the process
decomposition and each rank's owned box (`DMDACreate3d` with PETSC_DECIDE).
Here a :class:`Grid3D` couples the global grid (shape, extents, spacing) to
a :class:`ProcessGrid`, the counterpart of the JAX package's device mesh:
one process per rank on ``torch.distributed``, each holding ONE plain
tensor, its owned box of every field (``parallel.decomp.owned_boxes``:
64^3 on (3, 1, 1) gives (22, 64, 64), (21, 64, 64), (21, 64, 64)).

The JAX package stores an uneven decomposition in a padded layout
(``parallel/uneven.py`` ``to_padded``/``from_padded``, ``Grid3D.padded_n``,
``valid_mask``) because XLA needs equal shards. Owned boxes of different
sizes need no padding, so that layout has no counterpart here: a field of
an uneven grid is each rank's box, as it is on an even one.

Axis convention: tensor dims are (x, y, z), C order, z contiguous; ranks
are numbered in C order over the process grid (px, py, pz), as the JAX
package lays its devices out. A grid lives on the card unless its
`device` says otherwise; on a process grid of more than one rank a bare
"cuda" becomes this rank's card, ``cuda:(local_rank % device_count)``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from poissbox_tpu_torch.constants import default_real
from poissbox_tpu_torch.parallel.decomp import decompose_3d, dof_distribution, owned_boxes


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_rank() -> int:
    """This process's rank on its host: torchrun's LOCAL_RANK, else the
    global rank, else 0."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return _env_int("RANK") or 0


def rank_device(device="cuda") -> torch.device:
    """`device` with a bare "cuda" resolved to this rank's card,
    ``cuda:(local_rank % device_count)``; any other device as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a rank on 'cuda' needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def ranks_on_device(device) -> int:
    """How many ranks of this host share `device`: the local ranks that
    :func:`rank_device` puts on that card (1 for any other device, and
    without a process group)."""
    device = torch.device(device)
    if device.type != "cuda" or not (dist.is_available() and dist.is_initialized()):
        return 1
    local_world = _env_int("LOCAL_WORLD_SIZE") or dist.get_world_size()
    cards = torch.cuda.device_count()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return max(1, sum(1 for lr in range(local_world) if lr % cards == index))


def default_backend(device, world_size: int) -> str:
    """NCCL when every rank of this host has a card of its own (NCCL refuses
    two ranks on one device), gloo otherwise and on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_process_group(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None, *,
                       backend: Optional[str] = None,
                       device="cuda",
                       timeout: float = 600.0) -> None:
    """Initialise the process group, the MPI_Init analogue (the JAX
    package's ``init_distributed``).

    With no arguments it reads torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT); in a single process with none of it set it
    is a no-op, and so it is when a group already exists. Explicit
    arguments (all three: `init_method`, e.g. ``tcp://localhost:29500``,
    `world_size` and `rank`) must work or raise: a failure is never
    swallowed. `backend` defaults to :func:`default_backend` for `device`;
    on cuda this rank's card becomes the current device. `timeout` (s)
    bounds every collective, so a mismatched exchange raises instead of
    hanging.
    """
    if dist.is_initialized():
        return
    explicit = not (init_method is None and world_size is None and rank is None)
    if explicit and (init_method is None or world_size is None or rank is None):
        raise ValueError("init_process_group: give init_method, world_size and "
                         "rank together, or none of them")
    if not explicit:
        if _env_int("WORLD_SIZE") is None or _env_int("RANK") is None:
            return           # a single process: nothing to initialise
        world_size, rank, init_method = _env_int("WORLD_SIZE"), _env_int("RANK"), "env://"
    backend = backend or default_backend(device, world_size)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """A (px, py, pz) grid of ranks and this process's place in it (the
    counterpart of the JAX package's ``make_device_mesh``): rank r sits at
    the C-order coordinates of r, and its neighbours along an axis are the
    periodic next and previous ranks there (where the JAX package's
    ``halo._shift_perms`` send a block's planes). `groups` holds the
    sub-groups of the pencil transposes, made at the first one
    (``parallel.pencil.groups``)."""

    pgrid: tuple[int, int, int]
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "pgrid", tuple(int(p) for p in self.pgrid))
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside process grid {self.pgrid}")

    @property
    def size(self) -> int:
        return int(np.prod(self.pgrid))

    def coords_of(self, rank: int) -> tuple[int, int, int]:
        return tuple(int(c) for c in np.unravel_index(rank, self.pgrid))

    def rank_of(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(
            tuple(c % p for c, p in zip(coords, self.pgrid)), self.pgrid))

    @property
    def coords(self) -> tuple[int, int, int]:
        return self.coords_of(self.rank)

    def neighbors(self, axis: int) -> tuple[int, int]:
        """(previous, next) rank along `axis`, periodic."""
        lo, hi = list(self.coords), list(self.coords)
        lo[axis] -= 1
        hi[axis] += 1
        return self.rank_of(lo), self.rank_of(hi)


def make_process_grid(pgrid: Sequence[int], rank: Optional[int] = None) -> ProcessGrid:
    """The process grid `pgrid` over the world group, this process at its
    rank (0 without a group). `rank` places the grid for another rank: the
    in-process tests cut every rank's blocks without a group."""
    pgrid = tuple(int(p) for p in pgrid)
    need = int(np.prod(pgrid))
    if rank is None:
        have = world_size()
        if need != have:
            raise ValueError(f"process grid {pgrid} needs {need} ranks, the "
                             f"world group has {have}")
        rank = dist.get_rank() if have > 1 else 0
    return ProcessGrid(pgrid, int(rank))


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A periodic, uniform, cell-centred 3-D grid, on one device or over a
    process grid (`mesh`), where this rank holds its owned box of every
    field. Scalar fields live at cell centres x_i = (i + 1/2) dx.
    """

    n: tuple[int, int, int]
    length: tuple[float, float, float] = (1.0, 1.0, 1.0)
    device: torch.device = torch.device("cuda")
    mesh: Optional[ProcessGrid] = None

    def __post_init__(self):
        object.__setattr__(self, "n", tuple(int(v) for v in self.n))
        object.__setattr__(self, "length", tuple(float(v) for v in self.length))
        device = torch.device(self.device)
        if self.mesh is not None and self.mesh.size > 1:
            device = rank_device(device)
        object.__setattr__(self, "device", device)

    # -- geometry ----------------------------------------------------------
    @property
    def deltas(self) -> tuple[float, float, float]:
        return tuple(L / n for L, n in zip(self.length, self.n))

    @property
    def ndof(self) -> int:
        return int(np.prod(self.n))

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
        coordinates of the global grid."""
        axes = [self.vertices(d, dtype) if staggered[d] else self.cells(d, dtype)
                for d in range(3)]
        return torch.meshgrid(*axes, indexing="ij")

    # -- distribution ------------------------------------------------------
    @property
    def distributed(self) -> bool:
        """True when the grid spans more than one rank."""
        return self.mesh is not None and self.mesh.size > 1

    @property
    def pgrid(self) -> tuple[int, int, int]:
        """Ranks per grid axis ((1, 1, 1) without a process grid)."""
        return (1, 1, 1) if self.mesh is None else self.mesh.pgrid

    @property
    def uneven(self) -> bool:
        """True when some split axis does not divide evenly: owned boxes
        then differ in size (PETSc's DMDA runs any rank count)."""
        return any(nd % p for nd, p in zip(self.n, self.pgrid))

    def box_of(self, rank: int):
        """((xs, ys, zs), (xn, yn, zn)): the owned box of `rank`."""
        if self.mesh is None:
            return (0, 0, 0), self.n
        return owned_boxes(self.n, self.pgrid)[self.mesh.coords_of(rank)]

    @property
    def offset(self) -> tuple[int, int, int]:
        """Global index of this rank's first owned cell."""
        return self.box_of(self.mesh.rank if self.mesh is not None else 0)[0]

    @property
    def local_shape(self) -> tuple[int, int, int]:
        """Shape of this rank's block (the global shape on one device)."""
        return self.box_of(self.mesh.rank if self.mesh is not None else 0)[1]

    def with_mesh(self, mesh: Optional[ProcessGrid] = None) -> "Grid3D":
        """Attach a process grid; if none is given, decompose the grid over
        the world group (the PETSC_DECIDE moment; one rank without a
        group)."""
        if mesh is None:
            mesh = make_process_grid(decompose_3d(world_size(), self.n))
        return dataclasses.replace(self, mesh=mesh)

    def dof_counts(self) -> list[int]:
        """Per-rank DoF counts, in rank order (90112/86016/86016 for 64^3
        on 3 ranks, the reference README's rank report)."""
        return dof_distribution(self.n, self.pgrid)

    def shard(self, f) -> torch.Tensor:
        """This rank's owned box of a global field (a tensor or anything
        np.asarray takes), contiguous, on the grid's device."""
        (xs, ys, zs), (xn, yn, zn) = self.box_of(
            self.mesh.rank if self.mesh is not None else 0)
        if tuple(f.shape) != self.n:
            raise ValueError(f"shard: expected a global field of shape {self.n}, "
                             f"got {tuple(f.shape)}")
        box = f[xs:xs + xn, ys:ys + yn, zs:zs + zn]
        if not torch.is_tensor(box):    # numpy: a copy of the box only
            box = torch.from_numpy(np.array(box))
        return box.contiguous().to(self.device)

    def unshard(self, f: torch.Tensor) -> torch.Tensor:
        """The global field gathered from every rank's block (on every
        rank, on the grid's device); the field itself on one rank."""
        if not self.distributed:
            return f
        from poissbox_tpu_torch.parallel.halo import allgather_field
        return allgather_field(f, self)

    # -- field constructors -------------------------------------------------
    def zeros(self, dtype=None) -> torch.Tensor:
        """A zero field: this rank's block."""
        return torch.zeros(self.local_shape, dtype=dtype or default_real(),
                           device=self.device)

    def random(self, generator: Optional[torch.Generator] = None, dtype=None,
               minval: float = -1.0, maxval: float = 1.0) -> torch.Tensor:
        """Uniform random field in [minval, maxval) drawn from `generator`
        (on the generator's device): the global field is drawn on every
        rank, so a seed gives the same field on any process grid, and this
        rank keeps its box."""
        gdev = generator.device if generator is not None else "cpu"
        f = torch.rand(self.n, generator=generator, dtype=dtype or default_real(),
                       device=gdev)
        return self.shard(f * (maxval - minval) + minval)
