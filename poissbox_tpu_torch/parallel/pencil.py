"""Pencil transposes over ``torch.distributed`` (port of
:mod:`poissbox_tpu.parallel.pencil`).

The compact schemes and the FFT couple whole grid lines, so a line
operator runs where its lines are whole on one rank: the field moves
between layouts (home -> Z-pencils -> Y-pencils -> X-pencils), the 2decomp
transpose method.

A layout is, per array dim, the tuple of process-grid axes (0, 1, 2 for
the x, y, z ranks) that split it, major first; axes of one rank are left
out. The home layout splits dim d by axis d; the pencil along `local_dim`
moves that dim's axes onto the next dim, after its own
(:func:`pencil_spec`, the JAX package's ``pencil_spec``: an X-pencil of a
(px, py, pz) grid splits dim 1 by (x, y), x major). Blocks follow the
owned-box convention (``decomp.axis_boxes``), so the home layout's blocks
are the owned boxes.

The JAX package pins each layout with ``with_sharding_constraint`` and
splits every change into single-axis hops (``reshard_chain``) because XLA
rematerialises a reshard that moves several axes at once. Here a layout
change is ONE ``dist.all_to_all_single`` over the sub-group of ranks that
exchange data for it (those that differ only in the axes it moves: a row,
a column, a plane or the world), with every field that makes the change
stacked into it. Each rank packs the chunks it sends in group-rank order
(layout copies, which XLA makes in the JAX package) and keeps its own
chunk out of the collective. The sub-groups are made once per
:class:`~poissbox_tpu_torch.mesh.ProcessGrid`, on every rank, in one fixed
order, at its first transpose (a group made on some ranks only would hang
the world).

Owned boxes carry no padding, so a layout whose blocks differ in size is
not transposed: :func:`pencil_ok` says whether a route's layouts all
divide, and the callers take the gather route where they do not (as the
JAX package does on uneven grids).

Transport as :func:`poissbox_tpu_torch.parallel.halo.transport`: NCCL
with CUDA tensors, gloo with CPU tensors, gloo staged through pinned host
buffers where ranks share a card. Counted in ``halo.COUNTS``:
``alltoalls`` (calls), ``alltoall_bytes`` (what this rank sent to other
ranks, its own chunk not included), ``staged`` (chunks staged through the
host).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from poissbox_tpu_torch.parallel.decomp import axis_boxes
from poissbox_tpu_torch.parallel.halo import transport
from poissbox_tpu_torch.utils import census

Tensor = torch.Tensor
Layout = tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]
Box = tuple[tuple[int, int, int], tuple[int, int, int]]

# the layouts the routes pass through: home, then the Z, Y and X pencils
ROUTE = (None, 2, 1, 0)


def _pgrid(grid) -> tuple[int, int, int]:
    return tuple(grid) if isinstance(grid, (tuple, list)) else grid.pgrid


def pencil_spec(grid, local_dim: Optional[int]) -> Layout:
    """The layout with `local_dim` unsplit and every split axis kept
    (`local_dim` None: the home layout). `grid` is a Grid3D, a
    ProcessGrid or a (px, py, pz) tuple."""
    pgrid = _pgrid(grid)
    out: list[list[int]] = [[], [], []]
    for d in range(3):
        if pgrid[d] == 1:
            continue
        target = d if local_dim is None or d != local_dim else (d + 1) % 3
        out[target].append(d)
    return tuple(tuple(o) for o in out)


def block_of(shape: Sequence[int], pgrid: Sequence[int], spec: Layout,
             rank: int) -> Box:
    """((start per dim), (count per dim)) of `rank`'s block of an array of
    `shape` in layout `spec`."""
    coords = np.unravel_index(rank, tuple(pgrid))
    starts, counts = [], []
    for d in range(3):
        axes = spec[d]
        sizes = [pgrid[a] for a in axes]
        idx = int(np.ravel_multi_index([coords[a] for a in axes], sizes)) if axes else 0
        s, c = axis_boxes(int(shape[d]), math.prod(sizes))[idx]
        starts.append(s)
        counts.append(c)
    return tuple(starts), tuple(counts)


def pencil_ok(shape: Sequence[int], pgrid: Sequence[int],
              local_dims: Sequence[Optional[int]] = ROUTE) -> bool:
    """True when every block of every layout in `local_dims` (None: home)
    of an array of `shape` has the same size, the condition for the
    transposes between them."""
    for ld in local_dims:
        spec = pencil_spec(tuple(pgrid), ld)
        for d in range(3):
            if int(shape[d]) % math.prod(pgrid[a] for a in spec[d]):
                return False
    return True


def moving_axes(src: Layout, dst: Layout) -> frozenset:
    """The process-grid axes whose ranks exchange data in the change
    src -> dst: every split axis but those in the common leading part of
    one dim's tuples in both layouts (a rank's chunk along that dim is the
    same in both)."""
    axes = {a for t in src for a in t}
    fixed = set()
    for s, t in zip(src, dst):
        for a, b in zip(s, t):
            if a != b:
                break
            fixed.add(a)
    return frozenset(axes - fixed)


def _members(pgrid, rank: int, moving: frozenset) -> tuple[int, ...]:
    """The world ranks that agree with `rank` on every axis not in
    `moving`, ascending (the group's rank order)."""
    me = np.unravel_index(rank, tuple(pgrid))
    size = math.prod(pgrid)
    return tuple(r for r in range(size)
                 if all(c == m for a, (c, m) in enumerate(
                     zip(np.unravel_index(r, tuple(pgrid)), me)) if a not in moving))


def _make_groups(mesh) -> dict:
    """{moving axes: (members, group)} for every change between the
    layouts of :data:`ROUTE`, this rank's group of each. Every rank makes
    every group, in one order; the world group serves a change that moves
    every split axis."""
    specs = [pencil_spec(mesh, ld) for ld in ROUTE]
    sets = []
    for i, a in enumerate(specs):
        for b in specs[i + 1:]:
            m = moving_axes(a, b)
            if m and m not in sets:
                sets.append(m)
    split = frozenset(d for d in range(3) if mesh.pgrid[d] > 1)
    out = {}
    for m in sorted(sets, key=sorted):
        mine = _members(mesh.pgrid, mesh.rank, m)
        if m == split:
            out[m] = (mine, None)
            continue
        seen = set()
        for r in range(mesh.size):
            members = _members(mesh.pgrid, r, m)
            if members in seen:
                continue
            seen.add(members)
            group = dist.new_group(list(members))
            if members == mine:
                out[m] = (mine, group)
    return out


def groups(mesh) -> dict:
    """The ProcessGrid's transpose groups, made at the first call."""
    if not mesh.groups:
        mesh.groups.update(_make_groups(mesh))
    return mesh.groups


def _intersect(a: Box, b: Box) -> Optional[Box]:
    starts, counts = [], []
    for (sa, ca, sb, cb) in zip(a[0], a[1], b[0], b[1]):
        lo, hi = max(sa, sb), min(sa + ca, sb + cb)
        if hi <= lo:
            return None
        starts.append(lo)
        counts.append(hi - lo)
    return tuple(starts), tuple(counts)


def _cut(t: Tensor, box: Box, origin: tuple) -> Tensor:
    """The part of block `t` (whose first cell is `origin`) in `box`."""
    for d in range(3):
        t = t.narrow(d, box[0][d] - origin[d], box[1][d])
    return t


def plan(mesh, shape: Sequence[int], src: Layout, dst: Layout) -> dict:
    """What `mesh.rank` exchanges in the change src -> dst of an array of
    global `shape`: the group's world ranks (`members`, in group-rank
    order), the box it gives each (`give`) and takes from each (`take`),
    None where they share nothing, and its own blocks in both layouts."""
    members = _members(mesh.pgrid, mesh.rank, moving_axes(src, dst))
    me_src = block_of(shape, mesh.pgrid, src, mesh.rank)
    me_dst = block_of(shape, mesh.pgrid, dst, mesh.rank)
    return {"members": members, "src": me_src, "dst": me_dst,
            "give": [_intersect(me_src, block_of(shape, mesh.pgrid, dst, s))
                     for s in members],
            "take": [_intersect(block_of(shape, mesh.pgrid, src, s), me_dst)
                     for s in members],
            "me": members.index(mesh.rank)}


def pack(fields: Sequence[Tensor], p: dict):
    """(send buffer, send sizes, outputs): the chunks for the other
    members in group-rank order, each with every field's part in turn;
    the outputs (the fields' blocks in the new layout) hold this rank's
    own chunk already. Fields are real, one dtype and device."""
    f0 = fields[0]
    tail = tuple(f0.shape[3:])
    outs = [torch.empty(p["dst"][1] + tail, dtype=f0.dtype, device=f0.device)
            for _ in fields]
    sends, sizes = [], []
    for i, box in enumerate(p["give"]):
        if box is None:
            sizes.append(0)
        elif i == p["me"]:
            for o, f in zip(outs, fields):
                _cut(o, box, p["dst"][0]).copy_(_cut(f, box, p["src"][0]))
            sizes.append(0)
        else:
            parts = [_cut(f, box, p["src"][0]).reshape(-1) for f in fields]
            sends += parts
            sizes.append(sum(t.numel() for t in parts))
    send = (torch.cat(sends) if sends
            else torch.empty(0, dtype=f0.dtype, device=f0.device))
    return send, sizes, outs


def recv_sizes(fields: Sequence[Tensor], p: dict) -> list[int]:
    """The elements this rank takes from each member (its own: 0)."""
    per = math.prod(fields[0].shape[3:]) * len(fields)
    return [0 if box is None or i == p["me"] else math.prod(box[1]) * per
            for i, box in enumerate(p["take"])]


def unpack(recv: Tensor, sizes: Sequence[int], outs: Sequence[Tensor], p: dict) -> None:
    """Place the received chunks into the outputs."""
    tail = tuple(outs[0].shape[3:])
    for i, (part, box) in enumerate(zip(torch.split(recv, list(sizes)), p["take"])):
        if box is None or i == p["me"]:
            continue
        for o, piece in zip(outs, part.chunk(len(outs))):
            _cut(o, box, p["dst"][0]).copy_(piece.view(box[1] + tail))


def transpose(blocks: Sequence[Tensor], mesh, shape: Sequence[int],
              src: Layout, dst: Layout) -> list[Tensor]:
    """Move this rank's blocks of arrays of global `shape` (dims 0-2; any
    trailing dims ride along) from layout `src` to `dst`: one
    all_to_all_single over the change's group for every field together.
    All fields have one dtype and device; complex fields travel as their
    real views."""
    blocks = list(blocks)
    if src == dst or mesh is None or mesh.size == 1:
        return blocks
    cplx = blocks[0].is_complex()
    fields = [torch.view_as_real(b) if cplx else b for b in blocks]
    _, group = groups(mesh)[moving_axes(src, dst)]
    p = plan(mesh, shape, src, dst)
    send, send_sizes, outs = pack(fields, p)
    sizes = recv_sizes(fields, p)
    f0 = fields[0]
    staged = transport(f0) == "gloo-staged"
    if staged:
        send = torch.empty(send.shape, dtype=send.dtype, pin_memory=True).copy_(send)
        recv = torch.empty(sum(sizes), dtype=f0.dtype, pin_memory=True)
    else:
        recv = torch.empty(sum(sizes), dtype=f0.dtype, device=f0.device)
    dist.all_to_all_single(recv, send, sizes, send_sizes, group=group)
    census.record("all_to_all", sum(send_sizes) * f0.element_size(), ranks=len(sizes),
                  staged=sum(1 for n in send_sizes if n) if staged else 0)
    unpack(recv.to(f0.device), sizes, outs, p)
    return [torch.view_as_complex(o) for o in outs] if cplx else outs


Fields = Union[Tensor, Sequence[Tensor]]


def _apply(f: Fields, grid, src: Layout, dst: Layout, shape) -> Fields:
    single = torch.is_tensor(f)
    out = transpose([f] if single else f, grid.mesh if grid.distributed else None,
                    grid.n if shape is None else shape, src, dst)
    return out[0] if single else out


def to_pencil(f: Fields, grid, local_dim: int, from_dim: Optional[int] = None,
              shape: Optional[Sequence[int]] = None) -> Fields:
    """Move a field (or a list of fields, in one call) from the layout
    along `from_dim` (None: home) to the pencil along `local_dim`, where
    every line along `local_dim` lies whole on one rank. `shape` is the
    global array's (the grid's by default)."""
    return _apply(f, grid, pencil_spec(grid, from_dim), pencil_spec(grid, local_dim), shape)


def from_pencil(f: Fields, grid, from_dim: int,
                shape: Optional[Sequence[int]] = None) -> Fields:
    """Move a field (or fields) from the pencil along `from_dim` back to
    the home layout: this rank's owned box."""
    return _apply(f, grid, pencil_spec(grid, from_dim), pencil_spec(grid, None), shape)


def allgather_blocks(block: Tensor, grid, spec: Layout,
                     shape: Sequence[int]) -> Tensor:
    """The whole array of `shape` on every rank from every rank's block in
    layout `spec` (which divides it): one ``all_gather`` over the world,
    counted in ``COUNTS["gathers"]``."""
    mesh = grid.mesh
    cplx = block.is_complex()
    b = torch.view_as_real(block) if cplx else block
    host = transport(b) == "gloo-staged"
    buf = b.contiguous()
    if host:
        buf = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True).copy_(buf)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf)
    census.record("gather", buf.numel() * buf.element_size(), shape=buf.shape,
                  ranks=mesh.size)
    full = torch.empty(tuple(shape) + tuple(b.shape[3:]), dtype=b.dtype, device=buf.device)
    for r, part in enumerate(parts):
        box = block_of(shape, mesh.pgrid, spec, r)
        _cut(full, box, (0, 0, 0)).copy_(part)
    full = full.to(block.device)
    return torch.view_as_complex(full) if cplx else full
