"""Communication census: count and size the collectives a rank makes
(port of :mod:`poissbox_tpu.utils.census`).

The reference's DMDA contract promises one width-1 halo exchange an
operator application plus CG's reductions (reference
src/poissbox.f90:104-105). The JAX package checks that contract on the
compiled program: it parses the optimised HLO text into collectives by
computation (``parse_collectives``, ``_payload_bytes``, ``while_bodies``,
``poissbox_tpu/utils/census.py:50-111``). The port has no compiled
program: every collective is a ``torch.distributed`` call made by
:mod:`~poissbox_tpu_torch.parallel.halo` or
:mod:`~poissbox_tpu_torch.parallel.pencil`, and each of those sites calls
:func:`record`. So the record takes the parser's place, and the parser
has no counterpart here.

:func:`record` updates :data:`COUNTS` (``halo.COUNTS``, the same dict:
plain totals, read by the tests and ``chip_smoke.py``) and, while a
window is open (``with recording() as rec:``), appends
:class:`Collective` records to it. A record is built from tensor shapes
alone: no host sync, no device work; with no window open a call costs the
counter update only.

Ops, and what one record is:

  * ``exchange``: one ``batch_isend_irecv`` call (the unit of latency);
    `bytes` every face it sends, `shape` the block it was cut from;
  * ``face``: one face sent to one neighbour, two a split dim an exchange
    (the unit of the JAX package's ``collective-permute``); `dim` the
    split dim, `shape` the block;
  * ``all_reduce``, ``gather`` (``all_gather``; `shape` the buffer each
    rank sends, the largest owned box) and ``all_to_all`` (a pencil
    transpose).

`bytes` is what this rank sent; `ranks` the size of the collective's
group. A block's shape names its MG level (a halo pad grows it by two
cells a dim, in turn).

The analytic models the records are held to: :func:`halo_model`,
:func:`pencil_lapl_model`, and the shape models of a whole solve,
:func:`exchange_bytes_model`, :func:`pencil_bytes_model` (routes in
:data:`PENCIL_ROUTES`) and :func:`krylov_work`;
:func:`poissbox_tpu_torch.utils.scaling.mgcg_iteration_model` replays one
MG-CG iteration record for record.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Iterable, Optional, Sequence

from poissbox_tpu_torch.parallel.decomp import owned_boxes

# halo.COUNTS: face exchanges started (`exchanges`), face bytes this rank
# sent (`bytes`), faces and transpose chunks staged through the host
# (`staged`), all-reduces, field gathers (with `gather_bytes` this rank
# contributed), pencil transposes (with `alltoall_bytes` this rank sent
# to other ranks)
COUNTS: dict[str, int] = {k: 0 for k in (
    "exchanges", "bytes", "staged", "allreduces", "gathers", "gather_bytes",
    "alltoalls", "alltoall_bytes")}

_WINDOWS: list[list] = []   # the open recording windows


@dataclasses.dataclass(frozen=True)
class Collective:
    op: str                              # exchange, face, all_reduce, gather, all_to_all
    bytes: int                           # bytes this rank sent
    dim: Optional[int] = None            # the split dim of a face
    shape: Optional[tuple] = None        # block (exchange, face), buffer (gather)
    ranks: int = 1                       # ranks in the collective's group


def exchange_records(shape: Sequence[int], faces: dict) -> list[Collective]:
    """The records of one face exchange of a block of `shape`: `faces`
    maps each split dim to the bytes of one face (sent twice, to the
    previous and the next rank)."""
    shape = tuple(int(s) for s in shape)
    out = [Collective("exchange", 2 * sum(faces.values()), shape=shape)]
    for d, nbytes in faces.items():
        out += [Collective("face", nbytes, dim=d, shape=shape)] * 2
    return out


def record(op: str, nbytes: int, *, shape: Optional[Sequence[int]] = None,
           faces: Optional[dict] = None, ranks: int = 1, staged: int = 0) -> None:
    """Count one collective this rank made (`op` one of "exchange",
    "all_reduce", "gather", "all_to_all"; an exchange passes `faces`,
    {dim: bytes of one face}), and record it in every open window."""
    if op == "exchange":
        COUNTS["exchanges"] += 1
        COUNTS["bytes"] += nbytes
    elif op == "all_reduce":
        COUNTS["allreduces"] += 1
    elif op == "gather":
        COUNTS["gathers"] += 1
        COUNTS["gather_bytes"] += nbytes
    elif op == "all_to_all":
        COUNTS["alltoalls"] += 1
        COUNTS["alltoall_bytes"] += nbytes
    else:
        raise ValueError(f"unknown collective {op!r}")
    COUNTS["staged"] += staged
    if not _WINDOWS:
        return
    if op == "exchange":
        recs = exchange_records(shape, faces)
    else:
        recs = [Collective(op, int(nbytes), shape=None if shape is None else
                           tuple(int(s) for s in shape), ranks=int(ranks))]
    for w in _WINDOWS:
        w.extend(recs)


@contextlib.contextmanager
def recording():
    """A window: the list of every collective recorded while it is open
    (windows nest; each sees every record)."""
    rec: list[Collective] = []
    _WINDOWS.append(rec)
    try:
        yield rec
    finally:
        _WINDOWS.remove(rec)


def subtract(more: Iterable[Collective], fewer: Iterable[Collective]) -> list[Collective]:
    """The records of `more` that `fewer` lacks, as multisets (a window of
    k + 1 iterations less one of k: one iteration). Raises where `fewer`
    holds a record `more` does not."""
    a, b = collections.Counter(more), collections.Counter(fewer)
    extra = b - a
    if extra:
        raise ValueError(f"the smaller window holds records the larger lacks: {dict(extra)}")
    return list((a - b).elements())


def _add(stats: dict, key, c: Collective) -> None:
    s = stats.setdefault(key, {"count": 0, "bytes": 0})
    s["count"] += 1
    s["bytes"] += c.bytes


def census(records: Iterable[Collective], shape: Optional[Sequence[int]] = None) -> dict:
    """{op: {"count": n, "bytes": bytes this rank sent}}, restricted to
    the records of one block shape where `shape` is given (the JAX
    package's ``computation=`` filter picks a while body instead)."""
    want = None if shape is None else tuple(shape)
    stats: dict = {}
    for c in records:
        if want is None or c.shape == want:
            _add(stats, c.op, c)
    return stats


def census_by_dim(records: Iterable[Collective]) -> dict:
    """{dim: {"count", "bytes"}} of the face messages."""
    stats: dict = {}
    for c in records:
        if c.op == "face":
            _add(stats, c.dim, c)
    return dict(sorted(stats.items()))


def census_by_shape(records: Iterable[Collective]) -> dict:
    """{block shape: {op: {"count", "bytes"}}} of the exchanges and faces,
    largest block first: the census by MG level."""
    stats: dict = {}
    for c in records:
        if c.op in ("exchange", "face"):
            _add(stats.setdefault(c.shape, {}), c.op, c)
    return dict(sorted(stats.items(), key=lambda kv: -math.prod(kv[0])))


def exchange_messages(records: Iterable[Collective]) -> list[tuple[tuple, int, int]]:
    """(block shape, messages, largest message's bytes) of each exchange
    of `records` in the order they were recorded (a window, whose
    exchange records are followed by their faces): the latency view of a
    census."""
    out: list[list] = []
    for c in records:
        if c.op == "exchange":
            out.append([c.shape, 0, 0])
        elif c.op == "face" and out:
            out[-1][1] += 1
            out[-1][2] = max(out[-1][2], c.bytes)
    return [tuple(x) for x in out]


def max_gather_bytes(records: Iterable[Collective]) -> int:
    """The largest field one gather brings to a rank (its buffer times
    the group's ranks): the accidental-replication tripwire. Legitimate
    gathers exist only where a level runs replicated (the MG coarse levels,
    an uneven fine level's residual, the gather routes of order 6)."""
    return max((c.bytes * c.ranks for c in records if c.op == "gather"), default=0)


# ---------------------------------------------------------------------------
# analytic models
# ---------------------------------------------------------------------------

def halo_model(grid, itemsize: int = 4, n_exchanges: int = 1) -> dict:
    """The face census of `n_exchanges` width-1 exchanges of one field
    on `grid` (a Grid3D over a ProcessGrid), for this rank's block: two
    faces a split dim, each one plane of the block."""
    from poissbox_tpu_torch.parallel.halo import sharded_dims

    loc = grid.local_shape
    count = total = 0
    for d in sharded_dims(grid.mesh):
        count += 2
        total += 2 * itemsize * math.prod(n for i, n in enumerate(loc) if i != d)
    return {"count": count * n_exchanges, "bytes": total * n_exchanges}


def pencil_lapl_model(grid, itemsize: int = 4) -> dict:
    """The all-to-all census of `compact_dist.lapl` on `grid`, this rank:
    the port's route, one ``all_to_all_single`` a layout change whose
    layouts differ (3 on a grid with z whole, 4 with every axis split;
    none where a layout does not divide: the gather route). The JAX
    package counts 22-28 single-axis hops for the same operator
    (``reshard_chain``, an XLA limit): the two differ by design."""
    from poissbox_tpu_torch.parallel.pencil import pencil_ok

    if not grid.distributed:
        return {"count": 0, "bytes": 0}
    route = "lapl" if pencil_ok(grid.n, grid.pgrid) else "gather"
    calls, nbytes = pencil_bytes_model(grid.n, grid.pgrid, itemsize, route, grid.mesh.rank)
    return {"count": calls, "bytes": nbytes}


def exchange_bytes_model(n: int, pgrid, esize: int, pre_esize: int, pre: int,
                         post: int, smoother: str = "sor") -> tuple[int, int]:
    """Rank 0's face bytes sent, from the shapes alone: (one matvec, one
    V-cycle). A face exchange sends two planes a split axis; a halo pad
    (the transfers) pads the axes in turn, each on the block the earlier
    axes grew. On a distributed level the pre-smooth sends 2 pre - 1 faces
    sets (SOR: the first colour is closed form) or pre - 1 (Jacobi), the
    residual one, the post-smooth 2 post (SOR) or post; the restriction
    pads the fine block, the prolongation the coarse one where the coarse
    level is distributed too. The coarsest level and replicated levels
    send no faces (they gather)."""
    split = [d for d in range(3) if pgrid[d] > 1]

    def block(m):
        return owned_boxes((m,) * 3, pgrid)[(0, 0, 0)][1]

    def faces(shape, e):
        return sum(2 * e * math.prod(shape[k] for k in range(3) if k != d) for d in split)

    def pad(shape, e):
        return sum(2 * e * math.prod((shape[k] + 2) if k < d else shape[k]
                                     for k in range(3) if k != d) for d in split)

    def dist(m):   # mg._level_shardable
        return all(m % p == 0 and (m // p) % 2 == 0 for p in pgrid if p > 1)

    uneven = any(n % p for p in pgrid)
    sizes = [n]
    while sizes[-1] > 4 and sizes[-1] % 2 == 0:
        sizes.append(sizes[-1] // 2)
    v = 0
    for i, m in enumerate(sizes[:-1]):
        if not (dist(m) or (uneven and i == 0)):
            break
        sh = block(m)
        npre = 2 * pre - 1 if smoother == "sor" else pre - 1
        npost = 2 * post if smoother == "sor" else post
        v += npre * faces(sh, pre_esize) + (1 + npost) * faces(sh, esize)
        if not uneven:
            v += pad(sh, esize)
            if dist(sizes[i + 1]):
                v += pad(block(sizes[i + 1]), esize)
    return faces(block(n), esize), v


# the layout changes of each pencil route: (from, to, fields, shape) with
# the pencil's local dim (None: home); shape "body" is the packed FFT's
# half spectrum (nx, ny, nz/2) and "cfull" the full complex field
PENCIL_ROUTES = {
    "lapl": [(None, 2, 1, "real"), (2, 1, 2, "real"), (1, 0, 2, "real"),
             (0, None, 1, "real")],
    "grad": [(None, 2, 1, "real"), (2, 1, 2, "real"), (1, 0, 3, "real"),
             (0, None, 3, "real")],
    "div": [(None, 0, 3, "real"), (0, 1, 3, "real"), (1, 2, 2, "real"),
            (2, None, 1, "real")],
    "interp": [(None, 2, 1, "real"), (2, 1, 1, "real"), (1, 0, 1, "real"),
               (0, None, 1, "real")],
    "packed": [(None, 2, 1, "real"), (2, 1, 1, "body"), (1, 0, 1, "body"),
               (0, 1, 1, "body"), (1, 2, 1, "body"), (2, None, 1, "real")],
    "complex": [(None, 2, 1, "real"), (2, 1, 1, "cfull"), (1, 0, 1, "cfull"),
                (0, 1, 1, "cfull"), (1, 2, 1, "cfull"), (2, None, 1, "real")],
    "gather": [],
}


def pencil_bytes_model(n, pgrid, esize: int, route: str, rank: int = 0) -> tuple[int, int]:
    """A rank's all-to-alls (rank 0's by default) and the bytes it sends
    in them for one pass of a pencil route (PENCIL_ROUTES: an operator, or
    an FFT solve by its route), from the shapes alone: a change whose
    layouts differ is one call, and the rank sends every field's block but
    the part of it that its own block in the new layout holds."""
    from poissbox_tpu_torch.parallel.pencil import block_of, pencil_spec

    n = tuple(n)
    calls = nbytes = 0
    for src, dst, nf, kind in PENCIL_ROUTES[route]:
        a, b = pencil_spec(pgrid, src), pencil_spec(pgrid, dst)
        if a == b:
            continue
        shape = (n[0], n[1], n[2] // 2) if kind == "body" else n
        e = esize if kind == "real" else 2 * esize
        (s0, c0), (s1, c1) = block_of(shape, pgrid, a, rank), block_of(shape, pgrid, b, rank)
        keep = math.prod(max(0, min(p + c, q + d) - max(p, q))
                         for p, c, q, d in zip(s0, c0, s1, c1))
        calls += 1
        nbytes += nf * e * (math.prod(c0) - keep)
    return calls, nbytes


def krylov_work(argv, its: int, restart: int = 30) -> tuple[int, int]:
    """(matvecs, V-cycles) of rhs_for + solve + residual_norm for the
    method `argv` names, from its recurrence (x0 = 0): CG one matvec and
    one V-cycle an iteration and a V-cycle first; PIPECG a V-cycle and a
    matvec first; Richardson a matvec first, one of each an iteration;
    GMRES a matvec and two V-cycles first (r0 and M b), one of each a step
    and a restart (no V-cycle without a preconditioner)."""
    from poissbox_tpu_torch.config import Options, SolverOptions

    opts = SolverOptions.from_options(Options(list(argv)))
    if opts.ksp_type == "cg":
        return its + 2, its + 1
    if opts.ksp_type == "pipecg":
        return its + 3, its + 1
    if opts.ksp_type == "richardson":
        return its + 3, its
    cycles = max(1, -(-its // restart))
    return its + cycles + 2, (0 if opts.pc_type == "none" else its + cycles + 1)
