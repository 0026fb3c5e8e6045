"""The port's multi-process layer in one process, against the JAX package.

No process group here: every rank's block is cut from a global field, and
its halo planes with it (``halo.faces_from_global``), so the
correction-form arithmetic is checked apart from the exchange, on every
block of (8,1,1), (4,2,1), (2,2,2), (3,1,1) and (3,2,1), against the JAX
package's sharded operators on its virtual CPU devices (the padded layout
of parallel/uneven.py where the process grid does not divide the grid).
The exchange itself and the solves run over real gloo ranks in
tests/test_torch_dist*.py.
"""

import dataclasses
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.mesh import Grid3D as JGrid
from poissbox_tpu.mesh import make_device_mesh
from poissbox_tpu.parallel import decomp as jdecomp
from poissbox_tpu.parallel import dist_stencil as jds
from poissbox_tpu.parallel import uneven as jue
from poissbox_tpu.parallel.halo import _shift_perms as j_shift_perms
from poissbox_tpu.solvers import mg as jmg
from poissbox_tpu_torch import interop, mesh
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.mesh import Grid3D, ProcessGrid, make_process_grid
from poissbox_tpu_torch.ops.compact import make_compact_laplacian_operator
from poissbox_tpu_torch.ops import stencil, stencil_cuda
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.parallel import decomp, dist_stencil as ds, halo, uneven
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers import ksp, mg
from poissbox_tpu_torch.solvers.gmres import gmres
from poissbox_tpu_torch.solvers.pipecg import pipecg
from poissbox_tpu_torch.solvers.richardson import richardson
from poissbox_tpu_torch.solvers.mg import MGConfig

LENGTH = (1.0, 1.3, 0.7)
PGRIDS = {(8, 1, 1): (16, 12, 8), (4, 2, 1): (16, 12, 8), (2, 2, 2): (16, 12, 8),
          (3, 1, 1): (16, 12, 8), (3, 2, 1): (16, 12, 10)}
W, WJ = 1.0, 0.8


# ---------------------------------------------------------------------------
# the planner copy
# ---------------------------------------------------------------------------

SHAPES = [(64, 64, 64), (32, 32, 32), (48, 40, 96), (24, 16, 8), (17, 9, 5), (8, 8, 8)]


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 5, 6, 7, 8])
def test_decompose_3d_matches_jax(ndev):
    for shape in SHAPES:
        assert decomp.decompose_3d(ndev, shape) == jdecomp.decompose_3d(ndev, shape)


@pytest.mark.parametrize("pgrid", [(3, 1, 1), (3, 2, 1), (2, 2, 2), (4, 2, 1), (1, 1, 8)])
def test_owned_boxes_and_dofs_match_jax(pgrid):
    for shape in SHAPES:
        assert decomp.owned_boxes(shape, pgrid) == jdecomp.owned_boxes(shape, pgrid)
        assert decomp.dof_distribution(shape, pgrid) == jdecomp.dof_distribution(shape, pgrid)


@pytest.mark.parametrize("n,p", [(64, 3), (16, 3), (24, 8), (7, 1), (10, 4), (5, 5)])
def test_uneven_plan_matches_jax(n, p):
    assert uneven.axis_plan(n, p) == jue.axis_plan(n, p)
    for pgrid in ((p, 1, 1), (1, p, 2)):
        assert uneven.is_uneven((n, 12, 8), pgrid) == jue.is_uneven((n, 12, 8), pgrid)


@pytest.mark.parametrize("pgrid", [(8, 1, 1), (3, 1, 1), (2, 2, 2), (4, 2, 1)])
def test_sor_parity_local_ok_matches_jax(pgrid):
    for n in ((16, 16, 16), (24, 24, 24), (16, 12, 8), (64, 64, 64)):
        g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, 0))
        jg = JGrid(n, mesh=make_device_mesh(pgrid))
        assert ds.sor_parity_local_ok(g) == jds.sor_parity_local_ok(jg)


def test_reference_split():
    assert decomp.decompose_3d(3, (64, 64, 64)) == (3, 1, 1)
    assert decomp.dof_distribution((64, 64, 64), (3, 1, 1)) == [90112, 86016, 86016]
    grids = [Grid3D((64,) * 3, device="cpu", mesh=ProcessGrid((3, 1, 1), r))
             for r in range(3)]
    assert [g.local_shape for g in grids] == [(22, 64, 64), (21, 64, 64), (21, 64, 64)]
    assert [g.offset for g in grids] == [(0, 0, 0), (22, 0, 0), (43, 0, 0)]
    assert [uneven.color_offset(g) for g in grids] == [0, 0, 1]
    assert grids[0].dof_counts() == [90112, 86016, 86016] and grids[0].uneven


# ---------------------------------------------------------------------------
# the process grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pgrid", list(PGRIDS))
def test_neighbours_follow_the_shift_permutations(pgrid):
    """Rank r's neighbours along an axis are where JAX's periodic shift
    sends its planes, counted along that axis of the C-order grid."""
    size = int(np.prod(pgrid))
    for r in range(size):
        pg = ProcessGrid(pgrid, r)
        for axis in range(3):
            fwd, bwd = j_shift_perms(pgrid[axis])
            c = pg.coords[axis]
            prev, nxt = pg.neighbors(axis)
            assert pg.coords_of(nxt)[axis] == dict(fwd)[c]
            assert pg.coords_of(prev)[axis] == dict(bwd)[c]
            assert pg.rank_of(pg.coords_of(nxt)) == nxt
    assert halo.halo_exchange_spec(ProcessGrid(pgrid, 0)) == tuple(
        (d if p > 1 else None, p) for d, p in enumerate(pgrid))


def test_process_grid_without_a_group():
    assert mesh.world_size() == 1
    assert make_process_grid((1, 1, 1)) == ProcessGrid((1, 1, 1), 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_process_grid((2, 1, 1))
    with pytest.raises(ValueError, match="outside"):
        ProcessGrid((2, 1, 1), 2)
    g = Grid3D((8, 8, 8), device="cpu").with_mesh()
    assert g.pgrid == (1, 1, 1) and not g.distributed
    f = np.arange(512.0).reshape(8, 8, 8)
    assert torch.equal(g.unshard(g.shard(f)), torch.as_tensor(f))


def test_interop_rank_blocks_match_jax_shards():
    pgrid, n = (4, 2, 1), (16, 12, 8)
    jg = JGrid(n, mesh=make_device_mesh(pgrid))
    a = np.random.default_rng(3).standard_normal(n)
    arr = jg.shard(jnp.asarray(a))
    devs = list(np.asarray(jg.mesh.devices).ravel())
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    blocks = interop.rank_blocks(arr, n, pgrid)
    for r, blk in enumerate(blocks):
        np.testing.assert_array_equal(blk, shards[devs[r]])
        g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, r))
        np.testing.assert_array_equal(interop.shard_numpy(a, g).numpy(), blk)
    np.testing.assert_array_equal(interop.assemble_blocks(blocks, n, pgrid), a)
    odd = interop.rank_blocks(a[:, :, :7], (16, 12, 7), (3, 1, 1))
    assert [b.shape for b in odd] == [(6, 12, 7), (5, 12, 7), (5, 12, 7)]


# ---------------------------------------------------------------------------
# init_process_group
# ---------------------------------------------------------------------------

def test_init_process_group_noop_single_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    called = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: called.append(1))
    mesh.init_process_group(device="cpu")
    assert not called and not torch.distributed.is_initialized()


def test_init_process_group_explicit_failure_raises(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no cluster")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="no cluster"):
        mesh.init_process_group("tcp://127.0.0.1:1", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="together"):
        mesh.init_process_group("tcp://127.0.0.1:1", 2, device="cpu")


def test_init_process_group_explicit_unreachable_raises():
    """Rank 1 of 2 with nobody serving the store: a real failure within
    the timeout, never swallowed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(Exception):
        mesh.init_process_group(f"tcp://127.0.0.1:{port}", 2, 1, device="cpu",
                                timeout=2)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the correction-form arithmetic on every block
# ---------------------------------------------------------------------------

def _inputs(n):
    rng = np.random.default_rng(sum(n))
    return {k: rng.standard_normal(n) for k in ("u", "b")}


@functools.lru_cache(maxsize=None)
def _jax_ops(pgrid):
    """The JAX package's sharded operators on `pgrid`, global numpy."""
    n = PGRIDS[pgrid]
    jg = JGrid(n, length=LENGTH, mesh=make_device_mesh(pgrid))
    f = _inputs(n)
    u, b = (jg.shard(jnp.asarray(f[k])) for k in ("u", "b"))

    def ops(u, b):
        if jg.uneven:
            au = jue.apply_laplacian_uneven(u, jg)
            return {"apply": au, "apply_dot": au, "dot": jnp.sum(u * au),
                    "residual": jue.residual_uneven(u, b, jg),
                    "jacobi": jue.jacobi_sweep_uneven(u, b, jg, WJ),
                    "sor0": jue.sor_sweep_uneven(u, b, jg, W, 0),
                    "sor1": jue.sor_sweep_uneven(u, b, jg, W, 1)}
        y, dot = jds.apply_laplacian_dot_sharded(u, jg)
        return {"apply": jds.apply_laplacian_sharded(u, jg), "apply_dot": y, "dot": dot,
                "residual": jds.residual_sharded(u, b, jg),
                "jacobi": jds.jacobi_sweep_sharded(u, b, jg, WJ),
                "sor0": jds.sor_sweep_sharded(u, b, jg, W, 0),
                "sor1": jds.sor_sweep_sharded(u, b, jg, W, 1)}

    return {k: (float(v) if v.ndim == 0 else np.asarray(jg.unshard(v)))
            for k, v in jax.jit(ops)(u, b).items()}


def _port_op(op, ub, bb, g, faces, impl):
    if op == "apply":
        return ds.apply_laplacian_sharded(ub, g, local_impl=impl, faces=faces)
    if op == "apply_dot":
        return ds.apply_laplacian_dot_sharded(ub, g, local_impl=impl, reduce=False,
                                              faces=faces)
    if op == "residual":
        return ds.residual_sharded(ub, bb, g, local_impl=impl, faces=faces)
    if op == "jacobi":
        return ds.jacobi_sweep_sharded(ub, bb, g, WJ, local_impl=impl, faces=faces)
    return ds.sor_sweep_sharded(ub, bb, g, W, int(op[-1]), local_impl=impl, faces=faces)


@pytest.mark.parametrize("op", ["apply", "apply_dot", "residual", "jacobi", "sor0", "sor1"])
@pytest.mark.parametrize("pgrid", list(PGRIDS))
def test_correction_form_matches_jax_on_every_block(pgrid, op):
    """Each rank's block from its kernel (the plain version: the card's
    call graph) or the roll form, with halos cut from the global field,
    equals the JAX package's sharded result there (<= 1e-12 relative);
    apply_dot's partial dots sum to its global dot."""
    n = PGRIDS[pgrid]
    want = _jax_ops(pgrid)
    f = {k: torch.as_tensor(v) for k, v in _inputs(n).items()}
    scale = np.abs(want[op]).max()
    for impl in ("cuda", "roll"):
        dot = 0.0
        for r in range(int(np.prod(pgrid))):
            g = Grid3D(n, length=LENGTH, device="cpu", mesh=ProcessGrid(pgrid, r))
            out = _port_op(op, g.shard(f["u"]), g.shard(f["b"]), g,
                           halo.faces_from_global(f["u"], g), impl)
            if op == "apply_dot":
                out, part = out
                dot += float(part)
            box = g.shard(np.array(want[op])).numpy()
            assert np.abs(out.numpy() - box).max() <= 1e-12 * scale, (impl, r)
        if op == "apply_dot":
            assert abs(dot - want["dot"]) <= 1e-12 * abs(want["dot"])


def test_faces_from_global_match_the_padded_block():
    """The correction form's halos are the halo-padded block's faces."""
    for pgrid, n in PGRIDS.items():
        u = torch.as_tensor(_inputs(n)["u"])
        for r in range(int(np.prod(pgrid))):
            g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, r))
            pad = halo.pad_from_global(u, g, 1)
            inner = tuple(slice(1, -1) for _ in range(3))
            for d, (left, right) in halo.faces_from_global(u, g).items():
                sl = list(inner)
                sl[d] = slice(0, 1)
                assert torch.equal(left, pad[tuple(sl)])
                sl[d] = slice(pad.shape[d] - 1, pad.shape[d])
                assert torch.equal(right, pad[tuple(sl)])


@pytest.mark.parametrize("pgrid", [(3, 1, 1), (3, 2, 1), (2, 2, 2)])
def test_colour_mask_is_the_global_parity(pgrid):
    n = PGRIDS[pgrid]
    i, j, k = np.meshgrid(*(np.arange(m) for m in n), indexing="ij")
    par = (i + j + k) % 2
    for r in range(int(np.prod(pgrid))):
        g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, r))
        for c in (0, 1):
            want = g.shard((par == c).astype(np.float64))
            assert torch.equal(uneven.color_mask(g, c, torch.float64), want)


# the boxes of the red-black mask checks: the reference's 64^3 split
# (offsets 0, 22, 43: an odd one), (3,2,1) and (2,2,2) (even offsets), and
# odd y and z offsets (7) on (1,3,3)
MASK_BOXES = [((3, 1, 1), (64, 64, 64)), ((3, 2, 1), (24, 24, 24)),
              ((2, 2, 2), (16, 16, 16)), ((1, 3, 3), (8, 21, 21))]
ODD_OFFSETS = {(3, 1, 1), (1, 3, 3)}


def _full_field_face_masks(shape, dims, colour, dtype):
    """The face masks as they were built before: a full int64 parity field
    of the block, its face planes read."""
    par = stencil_cuda.colour_parity(shape, "cpu")
    return {d: ((par.narrow(d, 0, 1) == colour).to(dtype),
                (par.narrow(d, shape[d] - 1, 1) == colour).to(dtype)) for d in dims}


def _full_field_sor_sweep(x, b, g, weight, color, impl, faces):
    """sor_sweep_sharded as it was formulated before, on full-field parity
    masks: the reference the face-index masks must reproduce bit for bit."""
    winv = ds._winv(g, weight)
    lc = int(color) ^ ds.offset_parity(g)
    if impl == "cuda":
        out = stencil_cuda.sor_sweep_cuda(x, b, g.deltas, weight, lc)
    else:
        mask = (stencil_cuda.colour_parity(x.shape, x.device) == lc).to(x.dtype)
        out = x + (winv * mask) * (b - stencil.apply_laplacian(x, g.deltas))
    diffs = ds._diffs(x, faces)
    masks = _full_field_face_masks(tuple(x.shape), tuple(diffs), lc, x.dtype)
    return ds._apply_corrections(out, diffs, ds._invs(g), scale=-winv, masks=masks)


@pytest.mark.parametrize("pgrid,n", MASK_BOXES)
def test_face_masks_match_the_full_field_parity(pgrid, n):
    """The split faces' masks from the faces' own indices, and
    uneven.color_mask from a parity plane and k's parity, equal the
    full-field int64 parity's on every box, odd offsets included."""
    odd = 0
    for r in range(int(np.prod(pgrid))):
        g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, r))
        shape, dims = tuple(g.local_shape), tuple(halo.sharded_dims(g.mesh))
        odd += ds.offset_parity(g)
        for c in (0, 1):
            lc = c ^ ds.offset_parity(g)
            for dtype in (torch.float32, torch.float64, torch.bfloat16):
                got = ds._face_color_masks(shape, dims, lc, dtype, torch.device("cpu"))
                want = _full_field_face_masks(shape, dims, lc, dtype)
                assert list(got) == list(want)
                for d in dims:
                    for a, w in zip(got[d], want[d]):
                        assert a.dtype == w.dtype and torch.equal(a, w)
                old = (stencil_cuda.colour_parity(shape, "cpu") == lc).to(dtype)
                new = uneven.color_mask(g, c, dtype)
                assert new.dtype == old.dtype and torch.equal(new, old)
    assert (odd > 0) == (pgrid in ODD_OFFSETS)


@pytest.mark.parametrize("pgrid,n", MASK_BOXES)
def test_sharded_colour_update_matches_full_field_form(pgrid, n):
    """sor_sweep_sharded, with halos cut from the global field, is
    bit-equal on every box to its former full-field-parity formulation,
    through the kernel's call graph (the plain K11) and the roll form, in
    float64 and float32."""
    f = _inputs(n)
    for dtype in (torch.float64, torch.float32):
        u, bg = (torch.as_tensor(f[k]).to(dtype) for k in ("u", "b"))
        for r in range(int(np.prod(pgrid))):
            g = Grid3D(n, length=LENGTH, device="cpu", mesh=ProcessGrid(pgrid, r))
            faces = halo.faces_from_global(u, g)
            ub, bb = g.shard(u), g.shard(bg)
            for c in (0, 1):
                for impl in ("cuda", "roll"):
                    got = ds.sor_sweep_sharded(ub, bb, g, W, c, local_impl=impl, faces=faces)
                    want = _full_field_sor_sweep(ub, bb, g, W, c, impl, faces)
                    assert torch.equal(got, want), (pgrid, r, c, impl, dtype)


# ---------------------------------------------------------------------------
# the distributed levels' transfers and level stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pgrid", [(8, 1, 1), (4, 2, 1), (2, 2, 2)])
def test_padded_transfers_match_jax(pgrid):
    """The halo-padded local restriction and prolongation equal the JAX
    package's global roll-form restrict/prolong on every block."""
    n = PGRIDS[pgrid]
    f = _inputs(n)["u"]
    c = np.random.default_rng(5).standard_normal(tuple(m // 2 for m in n))
    want_r = np.asarray(jmg.restrict(jnp.asarray(f)))
    want_p = np.asarray(jmg.prolong(jnp.asarray(c)))
    ft, ct = torch.as_tensor(f), torch.as_tensor(c)
    for r in range(int(np.prod(pgrid))):
        g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, r))
        gc = dataclasses.replace(g, n=tuple(m // 2 for m in n))
        got_r = mg.restrict_padded(halo.pad_from_global(ft, g, 1))
        np.testing.assert_allclose(got_r.numpy(), gc.shard(want_r).numpy(),
                                   rtol=0, atol=1e-14)
        got_p = mg.prolong_padded(halo.pad_from_global(ct, gc, 1))
        np.testing.assert_allclose(got_p.numpy(), g.shard(want_p).numpy(),
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("n,pgrid", [(512, (2, 2, 1)), (64, (3, 1, 1)), (64, (2, 2, 2)),
                                     (32, (4, 1, 1)), (24, (8, 1, 1)), (48, (3, 2, 1)),
                                     (16, (2, 2, 2))])
def test_level_stack_matches_jax(n, pgrid):
    """Which levels run distributed: the JAX package's policy."""
    jg = JGrid((n,) * 3, mesh=make_device_mesh(pgrid))
    want = [lv.grid is not None for lv in jmg._build_levels(jg.n, jg.deltas,
                                                            jmg.MGConfig(), grid=jg)]
    g = Grid3D((n,) * 3, device="cpu", mesh=ProcessGrid(pgrid, 0))
    got = mg._build_levels(g.n, g.deltas, MGConfig(), grid=g)
    assert [lv.grid is not None for lv in got] == want
    assert [lv.shape for lv in got] == [lv.shape for lv in jmg._build_levels(
        jg.n, jg.deltas, jmg.MGConfig(), grid=jg)]


# ---------------------------------------------------------------------------
# what runs across ranks, and what raises
# ---------------------------------------------------------------------------

def _dist_operator(pgrid=(2, 1, 1), n=(8, 8, 8)):
    """A distributed operator (no collective runs until it is applied)."""
    g = Grid3D(n, device="cpu", mesh=ProcessGrid(pgrid, 0))
    return g, make_laplacian_operator(g)


def test_distributed_operator_binds_the_sharded_forms():
    g, A = _dist_operator()
    assert A.allreduce is not None and A.ndof == 512 and A.direct_solve is not None
    assert getattr(A.nullspace, "is_constant_projector", False)
    gu, Au = _dist_operator((3, 1, 1), (8, 8, 8))
    assert not getattr(Au.nullspace, "is_constant_projector", False)   # as in JAX
    with pytest.raises(ValueError, match="process grid"):
        make_laplacian_operator(Grid3D((8,) * 3, device="cpu"), impl="dist")


def test_distributed_compact_operator_binds_the_pencil_forms():
    """Order 6 over several ranks: compact_dist's Laplacian, the pencil
    FFT as its direct solve, the global projector and the reductions; only
    K15's methods run there."""
    g = Grid3D((8,) * 3, device="cpu", mesh=ProcessGrid((2, 1, 1), 0))
    A = make_compact_laplacian_operator(g)
    assert A.allreduce is not None and A.ndof == 512 and A.direct_solve is not None
    assert getattr(A.nullspace, "is_constant_projector", False)
    for method in ("pallas", "pscan"):
        with pytest.raises(NotImplementedError, match="K15"):
            make_compact_laplacian_operator(g, method=method)


@pytest.mark.parametrize("ksp_type", ["pipecg", "gmres", "richardson", "fft"])
def test_other_krylov_types_raise_across_ranks(ksp_type):
    """Every -ksp_type builds a solver over a process grid (no collective
    runs until it solves): PIPECG, GMRES and Richardson on rank blocks,
    the FFT direct solve by the pencil FFT."""
    g, A = _dist_operator()
    opts = Options(["-ksp_type", ksp_type, "-pc_type", "none"])
    solver = ksp.make_solver(A, opts, grid=g)
    assert callable(solver) and solver.opts.ksp_type == ksp_type
    assert solver.M is None


def _identity_reduced(A):
    """`A` with identity all-reduces: one device taken through the
    reduction points of a solve across ranks."""
    return dataclasses.replace(A, allreduce=lambda t: t, allreduce_max=lambda t: t)


@pytest.mark.parametrize("method", ["pipecg", "gmres_mg", "gmres_none", "richardson",
                                    "refine"])
def test_direct_calls_refuse_rank_blocks(method):
    """An identity all-reduce takes each method through the stacked
    reduction points it runs across ranks; on one device the iterates are
    bit for bit the same (GMRES both ways: with MG, and -pc_type none,
    where K2's partial <V_j, A V_j> rides the Gram-Schmidt all-reduce)."""
    s = PoissonSolver((16,) * 3, dtype=torch.float64, device="cpu",
                      options=Options(["-ksp_rtol", "1e-8"]))
    b = s.rhs_for(s.random_solution(3))
    M = s._solver.M
    # -pc_type none: the operator that binds K2 (its plain version here)
    A = make_laplacian_operator(s.grid, impl="cuda") if method == "gmres_none" else s.A
    A_id = _identity_reduced(A)
    if method == "refine":
        from poissbox_tpu_torch.solvers.refine import refine
        M32 = mg.make_mg_preconditioner(s.grid.n, s.grid.deltas, MGConfig(),
                                        dtype=torch.float32, device="cpu")
        r0, r1 = (refine(op, lambda r, op=op: cg(op, r, M=M32, rtol=1e-6, max_it=50), b)
                  for op in (A, A_id))
        assert (r0.outer_iterations, r0.inner_iterations) == (
            r1.outer_iterations, r1.inner_iterations)
        assert r0.inner_iterations > 0
        assert torch.equal(r0.x, r1.x) and torch.equal(r0.history, r1.history)
        return
    fn, kw = {"pipecg": (pipecg, dict(M=M)), "richardson": (richardson, dict(M=M)),
              "gmres_mg": (gmres, dict(M=M)),
              "gmres_none": (gmres, dict(max_it=40))}[method]
    assert (A.apply_dot is not None) == (method == "gmres_none")
    r0 = fn(A, b, rtol=1e-8, **kw)
    r1 = fn(A_id, b, rtol=1e-8, **kw)
    assert int(r0.iterations) == int(r1.iterations) > 0
    assert torch.equal(r0.x, r1.x)
    assert torch.equal(r0.history.nan_to_num(), r1.history.nan_to_num())


def test_one_device_cg_is_unchanged_by_the_reduction_points():
    """An identity all-reduce takes CG through the stacked reduction
    points; on one device the iterates are bit for bit the same."""
    s = PoissonSolver((16,) * 3, dtype=torch.float64, device="cpu",
                      options=Options(["-ksp_rtol", "1e-10"]))
    u = s.random_solution(3)
    b = s.rhs_for(u)
    M = s._solver.M
    A_id = dataclasses.replace(s.A, allreduce=lambda t: t)
    for flexible in (False, True):
        r0 = cg(s.A, b, M=M, rtol=1e-10, flexible=flexible)
        r1 = cg(A_id, b, M=M, rtol=1e-10, flexible=flexible)
        assert int(r0.iterations) == int(r1.iterations) > 0
        assert torch.equal(r0.x, r1.x)
        assert torch.equal(r0.history.nan_to_num(), r1.history.nan_to_num())
