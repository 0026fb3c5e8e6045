"""Periodic halo exchange and the collectives over ``torch.distributed``
(port of :mod:`poissbox_tpu.parallel.halo`).

Replaces PETSc's ghost update (`DMGetLocalVector` + `DMGlobalToLocal`).
The JAX package moves planes with ``lax.ppermute`` inside ``shard_map``;
here each rank posts point-to-point messages to its periodic neighbour
ranks with ``dist.batch_isend_irecv`` on the world group, and global sums
go through one ``dist.all_reduce``.

Transport, chosen by the group's backend and named, never a fallback:

  * ``nccl``: CUDA faces are sent as they are (one rank per card);
  * ``gloo``, CPU tensors: sent as they are;
  * ``gloo``, CUDA tensors (ranks that share one card, which NCCL
    refuses): each face is copied to a pinned host buffer, sent, received
    into one and copied back (``COUNTS["staged"]`` counts the faces).

Anything else raises. The kernels run on the card in every case.

:data:`COUNTS` holds plain integers: face exchanges started
(``exchanges``, one a block and call), face bytes this rank sent
(``bytes``), faces staged through the host (``staged``), all-reduces
(``allreduces``), field gathers (``gathers``, with ``gather_bytes``
this rank contributed), and the pencil transposes of
:mod:`~poissbox_tpu_torch.parallel.pencil` (``alltoalls``, with
``alltoall_bytes`` this rank sent to other ranks; their chunks staged
through the host count in ``staged``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor

COUNTS: dict[str, int] = {k: 0 for k in (
    "exchanges", "bytes", "staged", "allreduces", "gathers", "gather_bytes",
    "alltoalls", "alltoall_bytes")}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def transport(t: Tensor) -> str:
    """The route a tensor on `t`'s device takes over the world group:
    "nccl", "gloo" or "gloo-staged"."""
    backend = dist.get_backend()
    if backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"the NCCL group carries CUDA tensors, not {t.device}")
        return "nccl"
    if backend == "gloo":
        if t.device.type == "cpu":
            return "gloo"
        if t.device.type == "cuda":
            return "gloo-staged"
    raise ValueError(f"no transport for backend {backend!r} and a tensor on {t.device}")


def sharded_dims(mesh, dims: Optional[Sequence[int]] = None) -> list[int]:
    """The dims of `dims` (all three by default) split over more than one
    rank."""
    if mesh is None:
        return []
    return [d for d in (range(3) if dims is None else dims) if mesh.pgrid[d] > 1]


class FaceExchange:
    """An exchange of one block's faces in flight: :meth:`wait` returns
    {dim: (left, right)}, the previous rank's last `width` planes and the
    next rank's first `width` planes along each split dim."""

    def __init__(self, works, recvs: dict, device: torch.device, staged: bool):
        self._works = works
        self._recvs = recvs
        self._device = device
        self._staged = staged

    def wait(self) -> dict[int, tuple[Tensor, Tensor]]:
        for w in self._works:
            w.wait()
        if not self._staged:
            return self._recvs
        return {d: tuple(h.to(self._device, non_blocking=True) for h in pair)
                for d, pair in self._recvs.items()}


def start_face_exchange(block: Tensor, mesh, width: int = 1,
                        dims: Optional[Sequence[int]] = None) -> FaceExchange:
    """Post the exchange of `block`'s faces along its split dims: the last
    `width` planes go to the next rank (its left halo), the first `width`
    to the previous one (its right halo). Returns at once; the transfers
    run while the caller launches its kernel."""
    dims = sharded_dims(mesh, dims)
    route = transport(block) if dims else "local"
    staged = route == "gloo-staged"
    ops, recvs = [], {}
    for d in dims:
        n = block.shape[d]
        if width > n:
            raise ValueError(f"halo width {width} exceeds local extent {n} on dim {d}")
        prev, nxt = mesh.neighbors(d)
        lo = block.narrow(d, 0, width).contiguous()
        hi = block.narrow(d, n - width, width).contiguous()
        if staged:
            # synchronous copies: the faces are on the host before gloo
            # reads them
            lo = torch.empty(lo.shape, dtype=lo.dtype, pin_memory=True).copy_(lo)
            hi = torch.empty(hi.shape, dtype=hi.dtype, pin_memory=True).copy_(hi)
            left = torch.empty(hi.shape, dtype=hi.dtype, pin_memory=True)
            right = torch.empty(lo.shape, dtype=lo.dtype, pin_memory=True)
            COUNTS["staged"] += 2
        else:
            left, right = torch.empty_like(hi), torch.empty_like(lo)
        # tags tell the two messages between one pair of ranks apart (two
        # ranks along an axis: the previous and the next are one rank)
        ops += [dist.P2POp(dist.isend, hi, nxt, tag=2 * d),
                dist.P2POp(dist.isend, lo, prev, tag=2 * d + 1),
                dist.P2POp(dist.irecv, left, prev, tag=2 * d),
                dist.P2POp(dist.irecv, right, nxt, tag=2 * d + 1)]
        recvs[d] = (left, right)
        COUNTS["bytes"] += (lo.numel() + hi.numel()) * lo.element_size()
    works = dist.batch_isend_irecv(ops) if ops else []
    if ops:
        COUNTS["exchanges"] += 1
    return FaceExchange(works, recvs, block.device, staged)


def exchange_faces(block: Tensor, mesh, width: int = 1,
                   dims: Optional[Sequence[int]] = None) -> dict:
    """:func:`start_face_exchange`, waited for."""
    return start_face_exchange(block, mesh, width, dims).wait()


def halo_pad_local(u: Tensor, mesh, width: int = 1,
                   dims: Optional[Sequence[int]] = None) -> Tensor:
    """Pad a rank's block with periodic halos of `width` planes: neighbour
    planes on split dims, a local periodic wrap elsewhere. Dims are padded
    in turn, so edge and corner halos travel in two or three hops and the
    padded block is right for box stencils too."""
    dims = range(u.dim()) if dims is None else dims
    for d in dims:
        n = u.shape[d]
        if width > n:
            raise ValueError(f"halo width {width} exceeds local extent {n} on dim {d}")
        if d in sharded_dims(mesh):
            left, right = exchange_faces(u, mesh, width, (d,))[d]
        else:
            left, right = u.narrow(d, n - width, width), u.narrow(d, 0, width)
        u = torch.cat([left, u, right], dim=d)
    return u


def halo_exchange_spec(mesh) -> tuple:
    """Static description of the exchange: per dim (axis index, ranks
    along it), None for an axis of one rank."""
    return tuple((d if p > 1 else None, p)
                 for d, p in enumerate((1, 1, 1) if mesh is None else mesh.pgrid))


def allreduce_sum(t: Tensor, mesh=None) -> Tensor:
    """The sum of `t` over every rank (a new tensor on t's device); `t`
    itself without a group of more than one rank."""
    if mesh is None or mesh.size == 1:
        return t
    route = transport(t)
    COUNTS["allreduces"] += 1
    if route == "gloo-staged":
        h = t.detach().to("cpu")
        dist.all_reduce(h)
        return h.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def allreduce_max(t: Tensor, mesh=None) -> Tensor:
    """The elementwise maximum of `t` over every rank."""
    if mesh is None or mesh.size == 1:
        return t
    h = t.detach().to("cpu") if transport(t) == "gloo-staged" else t.detach().clone()
    COUNTS["allreduces"] += 1
    dist.all_reduce(h, op=dist.ReduceOp.MAX)
    return h.to(t.device)


def allgather_field(block: Tensor, grid) -> Tensor:
    """The global field from every rank's owned box, on every rank (on
    the block's device). Boxes differ in size on an uneven grid, so each
    rank sends its block in a buffer of the largest box, and the global
    field is cut back out of the gathered buffers."""
    mesh = grid.mesh
    route = transport(block)
    boxes = [grid.box_of(r) for r in range(mesh.size)]
    big = tuple(max(c[d] for _, c in boxes) for d in range(3))
    host = route == "gloo-staged"
    dev = torch.device("cpu") if host else block.device
    buf = torch.zeros(big, dtype=block.dtype, device=dev)
    sx, sy, sz = block.shape
    buf[:sx, :sy, :sz] = block
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf)
    COUNTS["gathers"] += 1
    COUNTS["gather_bytes"] += buf.numel() * buf.element_size()
    full = torch.empty(grid.n, dtype=block.dtype, device=dev)
    for part, ((xs, ys, zs), (xn, yn, zn)) in zip(parts, boxes):
        full[xs:xs + xn, ys:ys + yn, zs:zs + zn] = part[:xn, :yn, :zn]
    return full.to(block.device)


# ---------------------------------------------------------------------------
# halos cut from a global field (the exchange's result, without a group)
# ---------------------------------------------------------------------------

def _wrapped_index(start: int, count: int, n: int, device) -> Tensor:
    return torch.arange(start, start + count, device=device) % n


def pad_from_global(f: Tensor, grid, width: int = 1,
                    rank: Optional[int] = None) -> Tensor:
    """`rank`'s owned box of the global field `f` grown by `width` cells
    on every side, periodic: what :func:`halo_pad_local` returns there.
    The V-cycle cuts the halo-padded coarse block for its prolongation
    from a replicated coarse field with it."""
    rank = grid.mesh.rank if rank is None else rank
    (xs, ys, zs), (xn, yn, zn) = grid.box_of(rank)
    idx = [_wrapped_index(s - width, c + 2 * width, n, f.device)
           for s, c, n in zip((xs, ys, zs), (xn, yn, zn), grid.n)]
    return f[idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]]


def faces_from_global(f: Tensor, grid, width: int = 1,
                      rank: Optional[int] = None) -> dict:
    """{dim: (left, right)} of `rank`'s block cut from the global field
    `f`: exactly what :func:`exchange_faces` delivers to that rank, so the
    correction-form arithmetic can be checked without a process group."""
    rank = grid.mesh.rank if rank is None else rank
    (st, cnt) = grid.box_of(rank)
    faces = {}
    for d in sharded_dims(grid.mesh):
        def cut(start, count, d=d):
            sl = [slice(s, s + c) for s, c in zip(st, cnt)]
            sl[d] = _wrapped_index(start, count, grid.n[d], f.device)
            return f[sl[0]][:, sl[1]][:, :, sl[2]]
        faces[d] = (cut(st[d] - width, width), cut(st[d] + cnt[d], width))
    return faces

