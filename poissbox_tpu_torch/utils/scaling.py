"""Scaling model across ranks, held to the census (port of
:mod:`poissbox_tpu.utils.scaling`).

Two parts, as in the JAX package:

  1. :func:`mgcg_iteration_model`, an analytic replay of every collective
     one iteration of the port's distributed MG-CG makes on one rank,
     record for record (:class:`~poissbox_tpu_torch.utils.census.Collective`),
     level by level. It is exact: the port makes its collectives itself
     (no compiler inserts any), so the census of one iteration equals the
     replay on even and uneven decompositions (tests/test_torch_dist*.py on
     spawned CPU ranks, ``chip_smoke.py`` path (m) on the card);
  2. :func:`predict_efficiency`, the JAX package's arithmetic: those
     bytes, the link bandwidth (:data:`LINK_BW`) and a measured one-card
     iteration time give the weak- and strong-scaling efficiencies, a
     falsifiable number.

The model assumes, as the JAX package's does, that each process-grid
axis has a link of its own, so the wire time is the largest axis's bytes
over one link's bandwidth. On an NVSwitch board every axis shares the
card's links, so the maximum can understate the wire time by up to the
number of split axes. It counts bytes, not messages: a message's latency
is not in it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from poissbox_tpu_torch.parallel.decomp import axis_boxes
from poissbox_tpu_torch.utils.census import Collective, exchange_records

# One-way bandwidth of one card's links to its peers, bytes/s, by the name
# torch.cuda.get_device_name gives. H100 SXM: NVLink 4, 18 links, 900 GB/s
# both ways together (NVIDIA H100 Tensor Core GPU datasheet).
LINK_BW = {"NVIDIA H100 80GB HBM3": 450e9}



def _itemsize(dtype_name: str) -> int:
    return torch.finfo(getattr(torch, dtype_name)).bits // 8


def link_bandwidth(card: str) -> float:
    """:data:`LINK_BW` of `card`; an unknown card raises (no default)."""
    if card not in LINK_BW:
        raise KeyError(f"no link bandwidth for card {card!r} (known: {sorted(LINK_BW)})")
    return LINK_BW[card]


@dataclasses.dataclass(frozen=True)
class CommModel:
    """The collectives of one iteration of distributed MG-CG, one rank."""

    permute_count: int        # face messages (the JAX package's permutes)
    permute_bytes: int        # their bytes, sent by this rank
    gather_bytes: int         # what the gathers bring to the rank
    axis_bytes: tuple         # face bytes by array dim (a link an axis)
    levels: tuple             # (shape, distributed) per MG level
    exchange_count: int = 0   # batch_isend_irecv calls (the latency unit)
    allreduce_count: int = 0  # CG's all-reduces
    records: tuple = ()       # the replay, record for record


def _resolve_sweeps(cfg, shape):
    """mg._resolve_sweeps: V(1,1) at 512^3-class, V(2,2) at 256^3-class,
    V(3,3) below; explicit counts pass through."""
    auto = 1 if min(shape) >= 512 else (2 if min(shape) >= 256 else 3)
    pre = cfg.pre_smooth if cfg.pre_smooth >= 0 else auto
    post = cfg.post_smooth if cfg.post_smooth >= 0 else auto
    return pre, post


def _levels(n, pgrid, cfg) -> list:
    """mg._build_levels with mg._level_shardable: (shape, distributed)
    per level; an uneven fine level runs distributed, the levels below it
    replicated."""
    uneven = any(nd % p for nd, p in zip(n, pgrid))
    levels = []
    cur = tuple(n)
    while True:
        dist = (uneven and not levels) or all(
            nd % p == 0 and (nd // p) % 2 == 0 for nd, p in zip(cur, pgrid) if p > 1)
        levels.append((cur, dist))
        if (min(cur) <= cfg.coarse_size or any(x % 2 for x in cur)
                or (cfg.levels > 0 and len(levels) >= cfg.levels)):
            return levels
        cur = tuple(x // 2 for x in cur)


def mgcg_iteration_model(n: Sequence[int], pgrid: Sequence[int], cfg=None,
                         itemsize: int = 4, pre_itemsize: Optional[int] = None,
                         rank: int = 0) -> CommModel:
    """Replay the collectives of ONE iteration of the port's distributed
    MG-CG on `rank`: CG over the sharded operator, MG as its
    preconditioner, `cfg` an MGConfig (the default one if None), fields of
    `itemsize` bytes. `pre_itemsize` is the pre-smooth's (None: the bf16
    of the 512^3-class f32 default, else cfg.pre_dtype's, else itemsize).

    The iteration, mirroring solvers.cg, solvers.mg and
    parallel.dist_stencil:
      * the matvec: one face exchange of the fine block (K2);
      * on each distributed level, a visit: the pre-smooth (SOR 2 pre - 1
        colour exchanges, the first colour being closed form; Jacobi
        pre - 1; Chebyshev degree - 1), the residual (one), the
        restriction's halo pad (each split axis in turn, on the block the
        earlier axes grew), the child's correction, the prolongation's pad
        of the coarse block where the child is distributed, and the
        post-smooth (SOR 2 post, Jacobi post, Chebyshev degree);
      * W-cycles: a child at depth <= w_depth is visited twice, with one
        matvec of the child between (the correction form);
      * one gather where the replicated tail starts (the coarse field), or
        at the coarse solve of a distributed coarsest level; an uneven fine
        level gathers its residual instead, a fine level that does not
        split evenly its input;
      * CG's all-reduces: pAp, then ||r||^2, sum(r), <r, M r>, sum(M r)
        stacked in one; a third, the explicit projection, on an uneven
        grid.
    The norm type is the default (unpreconditioned).
    """
    from poissbox_tpu_torch.solvers.mg import MGConfig

    cfg = cfg or MGConfig()
    if cfg.smoother not in ("sor", "jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {cfg.smoother!r}")
    if cfg.cycle not in ("v", "w"):
        raise ValueError(f"unknown cycle {cfg.cycle!r}")
    n, pgrid = tuple(int(v) for v in n), tuple(int(p) for p in pgrid)
    world = math.prod(pgrid)
    coords = _coords(rank, pgrid)
    split = [d for d in range(3) if pgrid[d] > 1]
    uneven = any(nd % p for nd, p in zip(n, pgrid))
    pre, post = _resolve_sweeps(cfg, n)
    e = _itemsize(cfg.dtype) if cfg.dtype else itemsize
    if pre_itemsize is None:
        if cfg.pre_dtype:
            pre_itemsize = _itemsize(cfg.pre_dtype)
        elif not cfg.dtype and min(n) >= 512 and itemsize == 4:
            pre_itemsize = 2       # mg.auto_bf16_presmooth
        else:
            pre_itemsize = e
    levels = _levels(n, pgrid, cfg)
    last = len(levels) - 1
    recs: list[Collective] = []

    def block(shape):
        return tuple(axis_boxes(s, p)[c][1] for s, p, c in zip(shape, pgrid, coords))

    def face(shape, d, es):
        return es * math.prod(s for k, s in enumerate(shape) if k != d)

    def exchange(shape, es, times=1):
        for _ in range(times):
            recs.extend(exchange_records(shape, {d: face(shape, d, es) for d in split}))

    def pad(shape, es):
        grown = list(shape)
        for d in range(3):
            if d in split:
                recs.extend(exchange_records(grown, {d: face(grown, d, es)}))
            grown[d] += 2

    def gather(shape, es):
        big = tuple(-(-s // p) for s, p in zip(shape, pgrid))
        recs.append(Collective("gather", es * math.prod(big), shape=big, ranks=world))

    def smooth(sweeps, zero_guess):
        if sweeps <= 0:
            return 0
        if cfg.smoother == "sor":
            return 2 * sweeps - 1 if zero_guess else 2 * sweeps
        if cfg.smoother == "jacobi":
            return sweeps - 1 if zero_guess else sweeps
        degree = max(2 * sweeps, 2)
        return degree - 1 if zero_guess else degree

    def cycle(idx):
        shape, dist = levels[idx]
        if not dist:
            return                       # replicated from here down
        blk = block(shape)
        if idx == last:
            gather(shape, e)             # the coarse solve's gather
            return
        exchange(blk, pre_itemsize, smooth(pre, True))
        exchange(blk, e)                 # the residual
        cshape, cdist = levels[idx + 1]
        if uneven and idx == 0:
            gather(shape, e)             # restricted replicated
        else:
            pad(blk, e)
            if not cdist:
                gather(cshape, e)
        cycle(idx + 1)
        if cfg.cycle == "w" and idx + 1 <= cfg.w_depth and idx + 1 < last:
            if cdist:
                exchange(block(cshape), e)   # the child's correction matvec
            cycle(idx + 1)
        if cdist:
            pad(block(cshape), e)
        exchange(blk, e, smooth(post, False))

    exchange(block(n), itemsize)         # the matvec
    # the preconditioner: gathered in and cut out where the fine level
    # does not split evenly
    if levels[0][1]:
        cycle(0)
        for _ in range(cfg.cycles - 1):
            exchange(block(n), e)
            cycle(0)
    else:
        gather(n, e)
    recs.append(Collective("all_reduce", itemsize, ranks=world))
    if uneven:
        recs.append(Collective("all_reduce", itemsize, ranks=world))
    recs.append(Collective("all_reduce", 4 * itemsize, ranks=world))

    faces = [c for c in recs if c.op == "face"]
    ab = [0, 0, 0]
    for c in faces:
        ab[c.dim] += c.bytes
    return CommModel(
        permute_count=len(faces), permute_bytes=sum(ab),
        gather_bytes=sum(c.bytes * c.ranks for c in recs if c.op == "gather"),
        axis_bytes=tuple(ab), levels=tuple(levels),
        exchange_count=sum(1 for c in recs if c.op == "exchange"),
        allreduce_count=sum(1 for c in recs if c.op == "all_reduce"),
        records=tuple(recs))


def _coords(rank: int, pgrid: Sequence[int]) -> tuple[int, int, int]:
    """ProcessGrid.coords_of: the rank's (ix, iy, iz), z fastest."""
    if not 0 <= rank < math.prod(pgrid):
        raise ValueError(f"rank {rank} outside process grid {tuple(pgrid)}")
    rest, iz = divmod(rank, pgrid[2])
    ix, iy = divmod(rest, pgrid[1])
    return ix, iy, iz


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Weak/strong-scaling prediction for one configuration."""

    n: tuple
    pgrid: tuple
    compute_s: float          # per-iteration compute at this local size
    comm_s: float             # per-iteration wire time (max over axes)
    gather_s: float
    efficiency_overlapped: float   # faces hidden behind the kernels
    efficiency_serial: float       # no overlap (lower bound)


def predict_efficiency(n: Sequence[int], pgrid: Sequence[int], compute_s_per_it: float,
                       card: str, cfg=None, itemsize: int = 4,
                       model: Optional[CommModel] = None) -> Prediction:
    """Efficiency of one MG-CG iteration at global size `n` over `pgrid`
    on cards named `card` (a :data:`LINK_BW` key), the JAX package's
    arithmetic.

    `compute_s_per_it` is the measured per-iteration compute for the LOCAL
    block (weak scaling: one card's time at the local size; strong: one
    card's time at `n` over the ranks). The wire time is the largest of
    the axes' face bytes over the link bandwidth; the gather's bytes over
    the same bandwidth do not overlap the level change they feed. The
    overlapped time is max(compute, comm) + gather, the serial one
    compute + comm + gather.
    """
    m = model or mgcg_iteration_model(n, pgrid, cfg, itemsize)
    bw = link_bandwidth(card)
    comm = max(m.axis_bytes) / bw if any(m.axis_bytes) else 0.0
    gather = m.gather_bytes / bw
    t_overlap = max(compute_s_per_it, comm) + gather
    t_serial = compute_s_per_it + comm + gather
    return Prediction(
        n=tuple(n), pgrid=tuple(pgrid), compute_s=compute_s_per_it,
        comm_s=comm, gather_s=gather,
        efficiency_overlapped=compute_s_per_it / t_overlap,
        efficiency_serial=compute_s_per_it / t_serial)
