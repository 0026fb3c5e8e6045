"""The port's pencil layouts and transposes in one process, against the
JAX package.

No process group here: every rank's plan is made for that rank
(``ProcessGrid(pgrid, rank)``), each rank packs its chunks, and the test
hands every chunk to the rank it is addressed to, as ``all_to_all_single``
would; the layouts and blocks are held to the JAX package's
``pencil_spec`` on its virtual CPU devices. The transposes over real gloo
ranks run in tests/test_torch_dist*.py.
"""

import math

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from poissbox_tpu.mesh import Grid3D as JGrid
from poissbox_tpu.mesh import make_device_mesh
from poissbox_tpu.parallel.pencil import pencil_spec as j_pencil_spec
from poissbox_tpu_torch.mesh import Grid3D, ProcessGrid, make_process_grid
from poissbox_tpu_torch.parallel import pencil
from poissbox_tpu_torch.solvers import fft
from poissbox_tpu_torch.utils import census

# (process grid, a global shape every layout divides)
CASES = [((4, 2, 1), (16, 8, 12)), ((2, 2, 2), (8, 12, 16)), ((2, 1, 2), (16, 16, 18)),
         ((3, 1, 1), (12, 9, 6)), ((1, 2, 2), (6, 8, 12)), ((8, 1, 1), (16, 16, 8))]
NAMES = ("x", "y", "z")


def _as_names(spec):
    """A port layout in the JAX package's PartitionSpec entries."""
    return tuple(None if not t else (NAMES[t[0]] if len(t) == 1 else
                                     tuple(NAMES[a] for a in t)) for t in spec)


@pytest.mark.parametrize("pgrid,shape", CASES, ids=[f"{p}" for p, _ in CASES])
@pytest.mark.parametrize("local_dim", [None, 0, 1, 2])
def test_layouts_and_blocks_match_jax(pgrid, shape, local_dim):
    jg = JGrid(shape, mesh=make_device_mesh(pgrid))
    jspec = jg.spec if local_dim is None else j_pencil_spec(jg, local_dim)
    spec = pencil.pencil_spec(pgrid, local_dim)
    want = tuple(jspec) + (None,) * (3 - len(jspec))
    assert _as_names(spec) == want
    idx = NamedSharding(jg.mesh, jspec).devices_indices_map(shape)
    for r, dev in enumerate(jg.mesh.devices.flat):
        starts, counts = pencil.block_of(shape, pgrid, spec, r)
        jslices = [sl.indices(n) for sl, n in zip(idx[dev], shape)]
        assert [(s, c) for s, c in zip(starts, counts)] == [
            (a, b - a) for a, b, _ in jslices]


def test_home_blocks_are_the_owned_boxes():
    for pgrid, n in [((3, 1, 1), (64, 64, 64)), ((3, 2, 1), (24, 17, 9)),
                     ((2, 2, 2), (16, 16, 16))]:
        for r in range(math.prod(pgrid)):
            g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, r))
            assert pencil.block_of(n, pgrid, pencil.pencil_spec(g, None), r) == g.box_of(r)


def _exchange(fields_of, pgrid, shape, src, dst):
    """One simulated change src -> dst: every rank's fields -> every
    rank's new blocks, and the elements each rank sent to others."""
    size = math.prod(pgrid)
    plans = [pencil.plan(ProcessGrid(pgrid, r), shape, src, dst) for r in range(size)]
    packed = [pencil.pack(fields_of[r], plans[r]) for r in range(size)]
    outs = []
    for r in range(size):
        p = plans[r]
        parts = []
        for s in p["members"]:
            send, sizes, _ = packed[s]
            chunk = torch.split(send, sizes)[plans[s]["members"].index(r)]
            parts.append(chunk)
        sizes = pencil.recv_sizes(fields_of[r], p)
        assert [t.numel() for t in parts] == sizes
        recv = torch.cat(parts)
        new = packed[r][2]
        pencil.unpack(recv, sizes, new, p)
        outs.append(new)
    return outs, [sum(packed[r][1]) for r in range(size)]


@pytest.mark.parametrize("pgrid,shape", CASES, ids=[f"{p}" for p, _ in CASES])
def test_round_trip_through_every_pencil(pgrid, shape):
    """home -> Z -> Y -> X -> home with two fields (one chunk for both):
    after each change every rank holds the global fields' block of the new
    layout, and the bytes each change sends are the shape model's."""
    rng = np.random.default_rng(7)
    glob = [torch.as_tensor(rng.standard_normal(shape)) for _ in range(2)]
    size = math.prod(pgrid)
    cur = None

    def cut(t, spec, r):
        (s, c) = pencil.block_of(shape, pgrid, spec, r)
        return t[s[0]:s[0] + c[0], s[1]:s[1] + c[1], s[2]:s[2] + c[2]].contiguous()

    home = pencil.pencil_spec(pgrid, None)
    fields = [[g.shard(t) for t in glob] for g in
              (Grid3D(shape, device="cpu", mesh=make_process_grid(pgrid, r))
               for r in range(size))]
    for r in range(size):
        assert all(torch.equal(f, cut(t, home, r)) for f, t in zip(fields[r], glob))
    for nxt in (2, 1, 0, None):
        src, dst = pencil.pencil_spec(pgrid, cur), pencil.pencil_spec(pgrid, nxt)
        if src == dst:
            cur = nxt
            continue
        fields, sent = _exchange(fields, pgrid, shape, src, dst)
        for r in range(size):
            for f, t in zip(fields[r], glob):
                assert torch.equal(f, cut(t, dst, r))
        # rank 0 against the model, one field at a time
        kept = math.prod(max(0, min(p + c, q + d) - max(p, q)) for p, c, q, d in zip(
            *pencil.block_of(shape, pgrid, src, 0), *pencil.block_of(shape, pgrid, dst, 0)))
        assert sent[0] == 2 * (math.prod(pencil.block_of(shape, pgrid, src, 0)[1]) - kept)
        cur = nxt


@pytest.mark.parametrize("pgrid,shape", CASES, ids=[f"{p}" for p, _ in CASES])
def test_complex_fields_and_trailing_dims_ride_along(pgrid, shape):
    rng = np.random.default_rng(9)
    glob = torch.as_tensor(rng.standard_normal(shape + (2,)))
    size = math.prod(pgrid)
    src, dst = pencil.pencil_spec(pgrid, None), pencil.pencil_spec(pgrid, 0)

    def cut(spec, r):
        (s, c) = pencil.block_of(shape, pgrid, spec, r)
        return glob[s[0]:s[0] + c[0], s[1]:s[1] + c[1], s[2]:s[2] + c[2]].contiguous()

    outs, _ = _exchange([[cut(src, r)] for r in range(size)], pgrid, shape, src, dst)
    for r in range(size):
        assert torch.equal(outs[r][0], cut(dst, r))


def test_groups_are_rows_columns_planes_or_the_world():
    """The ranks of a change are those that differ only in the axes it
    moves: the (2,2,1) Laplacian's Z->Y change pairs ranks along y, its
    Y->X and X->home changes take all four."""
    spec = lambda ld: pencil.pencil_spec((2, 2, 1), ld)
    assert pencil.moving_axes(spec(2), spec(1)) == {1}
    assert pencil.moving_axes(spec(1), spec(0)) == {0, 1}
    assert pencil.moving_axes(spec(0), spec(None)) == {0, 1}
    assert pencil._members((2, 2, 1), 0, frozenset({1})) == (0, 1)
    assert pencil._members((2, 2, 1), 2, frozenset({1})) == (2, 3)
    assert pencil._members((2, 2, 2), 5, frozenset({2})) == (4, 5)
    assert pencil._members((2, 2, 2), 5, frozenset({0})) == (1, 5)
    assert pencil.moving_axes(pencil.pencil_spec((4, 1, 1), None),
                              pencil.pencil_spec((4, 1, 1), 2)) == set()


@pytest.mark.parametrize("pgrid", [(2, 2, 1), (2, 2, 2), (3, 1, 1), (2, 1, 2), (3, 2, 1),
                                   (4, 2, 1), (1, 2, 2)])
def test_pencil_ok_exactly_where_no_block_is_ragged(pgrid):
    for shape in [(16, 16, 16), (16, 16, 18), (12, 12, 12), (18, 18, 18), (16, 16, 9),
                  (64, 64, 64), (8, 12, 6), (24, 24, 24), (10, 20, 30)]:
        ragged = False
        for ld in pencil.ROUTE:
            spec = pencil.pencil_spec(pgrid, ld)
            counts = {pencil.block_of(shape, pgrid, spec, r)[1]
                      for r in range(math.prod(pgrid))}
            ragged |= len(counts) > 1
        assert pencil.pencil_ok(shape, pgrid) == (not ragged), (shape, pgrid)


@pytest.mark.parametrize("shape,pgrid,route", [
    ((32, 32, 32), (2, 2, 1), "packed"), ((16, 16, 16), (2, 2, 2), "packed"),
    ((16, 16, 18), (2, 1, 2), "complex"), ((18, 18, 18), (3, 2, 1), "complex"),
    ((16, 16, 16), (3, 1, 1), "gather"), ((32, 32, 32), (4, 1, 1), "packed"),
    ((16, 16, 14), (2, 2, 1), "complex"), ((64, 64, 64), (3, 1, 1), "gather")])
def test_fft_route(shape, pgrid, route):
    assert fft.fft_route(shape, pgrid) == route


def test_bytes_model_of_the_headline_laplacian():
    """The 512^3 f32 (2,2,1) compact Laplacian: rank 0 sends 2 x 64 MiB
    (Z->Y), 2 x 96 MiB (Y->X) and 64 MiB (X->home) in 3 calls; the packed
    FFT's four body changes 64 + 96 + 96 + 64 MiB."""
    mib = 2 ** 20
    assert census.pencil_bytes_model((512,) * 3, (2, 2, 1), 4, "lapl") == (3, 384 * mib)
    assert census.pencil_bytes_model((512,) * 3, (2, 2, 1), 4, "packed") == (4, 320 * mib)
