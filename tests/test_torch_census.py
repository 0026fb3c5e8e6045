"""The port's census and scaling model (poissbox_tpu_torch.utils.census,
utils.scaling) in one process: the shape models moved out of
chip_smoke.py keep their values, the MG-CG iteration model's level stack
equals the JAX package's, its face bytes equal the whole-cycle shape model,
and the efficiency arithmetic equals the JAX package's field for field. The
census of real ranks against the model: tests/test_torch_dist*.py."""

import math

import pytest

from poissbox_tpu.solvers.mg import MGConfig as JMGConfig
from poissbox_tpu.utils import scaling as jscaling
from poissbox_tpu_torch.solvers.mg import MGConfig
from poissbox_tpu_torch.utils import census, scaling
from poissbox_tpu_torch.utils.census import Collective

MIB = 2 ** 20
CYCLES = {"V11": dict(pre_smooth=1, post_smooth=1), "V33": dict(pre_smooth=3, post_smooth=3),
          "W": dict(cycle="w")}
GRIDS = [((64,) * 3, (2, 2, 2)), ((128,) * 3, (4, 2, 1)), ((512,) * 3, (2, 2, 1)),
         ((64,) * 3, (2, 2, 1))]


def test_moved_models_keep_their_values():
    """The values the pencil tests and path (m) held the models to while
    they lived in chip_smoke.py."""
    assert census.pencil_bytes_model((512,) * 3, (2, 2, 1), 4, "lapl") == (3, 384 * MIB)
    assert census.pencil_bytes_model((512,) * 3, (2, 2, 1), 4, "packed") == (4, 320 * MIB)
    assert census.exchange_bytes_model(512, (2, 2, 1), 4, 2, 1, 1) == (2097152, 13305536)
    assert census.krylov_work(["-ksp_type", "cg"], 7) == (9, 8)


@pytest.mark.parametrize("cycle", tuple(CYCLES))
@pytest.mark.parametrize("n,pgrid", GRIDS, ids=[f"{n[0]}-{''.join(map(str, p))}"
                                                for n, p in GRIDS])
def test_level_stack_equals_jax(n, pgrid, cycle):
    got = scaling.mgcg_iteration_model(n, pgrid, MGConfig(**CYCLES[cycle]))
    want = jscaling.mgcg_iteration_model(n, pgrid, JMGConfig(**CYCLES[cycle]))
    assert got.levels == want.levels


@pytest.mark.parametrize("n,pgrid,itemsize,pre", [
    (512, (2, 2, 1), 4, 2), (64, (3, 1, 1), 8, 8), (64, (2, 2, 2), 8, 8),
    (256, (2, 2, 1), 4, 4), (32, (4, 1, 1), 8, 8), (24, (3, 2, 1), 8, 8)])
def test_face_bytes_equal_the_cycle_shape_model(n, pgrid, itemsize, pre):
    """One iteration's face bytes are one matvec and one V-cycle of
    exchange_bytes_model (rank 0, V-cycle, the auto sweep counts)."""
    sweeps = 1 if n >= 512 else (2 if n >= 256 else 3)
    mv, v = census.exchange_bytes_model(n, pgrid, itemsize, pre, sweeps, sweeps)
    m = scaling.mgcg_iteration_model((n,) * 3, pgrid, itemsize=itemsize, pre_itemsize=pre)
    assert m.permute_bytes == mv + v
    assert m.permute_bytes == census.census(m.records)["face"]["bytes"]


def test_headline_iteration():
    """512^3 f32 on (2,2,1), rank 0: 57 exchanges (1 matvec, 56 a
    V-cycle), 2 all-reduces, the 4^3 coarse field gathered."""
    m = scaling.mgcg_iteration_model((512,) * 3, (2, 2, 1))
    assert (m.exchange_count, m.allreduce_count) == (57, 2)
    assert m.gather_bytes == 4 * 4 ** 3
    assert census.max_gather_bytes(m.records) == 4 * 4 ** 3
    assert all(dist for _, dist in m.levels)


def test_model_scales_with_grid():
    """The JAX package's test_model_scales_with_grid, on the port's model."""
    cfg = MGConfig(pre_smooth=1, post_smooth=1)
    a = scaling.mgcg_iteration_model((64, 64, 64), (2, 2, 2), cfg)
    b = scaling.mgcg_iteration_model((128, 128, 128), (2, 2, 2), cfg)
    assert b.permute_bytes > 3.5 * a.permute_bytes
    w1 = scaling.mgcg_iteration_model((128, 128, 128), (2, 2, 2), cfg)
    w2 = scaling.mgcg_iteration_model((256, 256, 256), (4, 4, 4), cfg)
    assert w2.axis_bytes[0] == pytest.approx(w1.axis_bytes[0], rel=0.25)


def test_uneven_ranks_differ():
    """(3,1,1) at 64^3: rank 0's box is 22 planes, rank 2's 21; the fine
    residual is gathered (the whole field), a third all-reduce projects."""
    m0 = scaling.mgcg_iteration_model((64,) * 3, (3, 1, 1), itemsize=8, rank=0)
    m2 = scaling.mgcg_iteration_model((64,) * 3, (3, 1, 1), itemsize=8, rank=2)
    assert m0.permute_bytes == m2.permute_bytes       # x faces: 64 x 64 either way
    assert census.census_by_shape(m0.records).keys() == {(22, 64, 64)}
    assert census.census_by_shape(m2.records).keys() == {(21, 64, 64)}
    assert m0.allreduce_count == 3 and m0.gather_bytes == 3 * 8 * 22 * 64 * 64


@pytest.mark.parametrize("n,pgrid,t_it", [((512,) * 3, (2, 2, 1), 0.0101),
                                          ((1024, 1024, 512), (2, 2, 1), 0.0101),
                                          ((64,) * 3, (2, 2, 2), 1e-4),
                                          ((128,) * 3, (4, 2, 1), 3e-6)])
def test_prediction_equals_jax(monkeypatch, n, pgrid, t_it):
    """Fed one CommModel and a link of 4.5e10 B/s (v5e's ICI entry), the
    port's Prediction is the JAX package's, field for field."""
    monkeypatch.setitem(scaling.LINK_BW, "test card", 4.5e10)
    m = scaling.mgcg_iteration_model(n, pgrid)
    got = scaling.predict_efficiency(n, pgrid, t_it, "test card", model=m)
    want = jscaling.predict_efficiency(n, pgrid, t_it, chip="v5e", model=m)
    for f in ("compute_s", "comm_s", "gather_s", "efficiency_overlapped",
              "efficiency_serial"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12, abs=0.0), f
    assert (got.n, got.pgrid) == (want.n, want.pgrid)


def test_unknown_card_raises():
    assert scaling.LINK_BW["NVIDIA H100 80GB HBM3"] == 450e9
    with pytest.raises(KeyError):
        scaling.predict_efficiency((64,) * 3, (2, 2, 1), 1e-3, "a card nobody measured")


def test_recording_windows():
    """record() counts with no window open, and every open window (they
    nest) receives the records; an exchange is one "exchange" record and
    two "face" records a split dim."""
    from poissbox_tpu_torch.parallel import halo

    before = dict(halo.COUNTS)
    census.record("all_reduce", 32, ranks=4)
    assert halo.COUNTS["allreduces"] == before["allreduces"] + 1
    with census.recording() as outer:
        census.record("exchange", 2 * (80 + 40), shape=(4, 5, 2), faces={0: 80, 1: 40})
        with census.recording() as inner:
            census.record("gather", 64, shape=(2, 2, 2), ranks=8)
    assert halo.COUNTS["exchanges"] == before["exchanges"] + 1
    assert halo.COUNTS["bytes"] == before["bytes"] + 240
    assert inner == [Collective("gather", 64, shape=(2, 2, 2), ranks=8)]
    assert census.census(outer) == {"exchange": {"count": 1, "bytes": 240},
                                    "face": {"count": 4, "bytes": 240},
                                    "gather": {"count": 1, "bytes": 64}}
    assert census.census_by_dim(outer) == {0: {"count": 2, "bytes": 160},
                                           1: {"count": 2, "bytes": 80}}
    assert census.census(outer, shape=(2, 2, 2)) == {"gather": {"count": 1, "bytes": 64}}
    assert census.max_gather_bytes(outer) == 512
    with pytest.raises(ValueError):
        census.record("broadcast", 8)
    for k, v in before.items():     # leave the counters as they were
        halo.COUNTS[k] = v


def test_subtract_is_one_iteration():
    a = [Collective("all_reduce", 8), Collective("all_reduce", 8), Collective("face", 4, 0)]
    assert census.subtract(a, a[:1]) == [Collective("all_reduce", 8), Collective("face", 4, 0)]
    with pytest.raises(ValueError):
        census.subtract(a[:1], [Collective("face", 4, 1)])


def test_pencil_lapl_model():
    """3 all-to-alls on (2,2,1), 4 with every axis split, none on the
    gather route (a layout that does not divide)."""
    from poissbox_tpu_torch.mesh import Grid3D, ProcessGrid

    for pgrid, n, calls in (((2, 2, 1), 32, 3), ((2, 2, 2), 16, 4), ((3, 1, 1), 16, 0)):
        g = Grid3D((n,) * 3, device="cpu", mesh=ProcessGrid(pgrid, 0))
        got = census.pencil_lapl_model(g, 8)
        assert got["count"] == calls
        assert (got["count"], got["bytes"]) == census.pencil_bytes_model(
            (n,) * 3, pgrid, 8, "lapl" if calls else "gather")
    assert math.isclose(census.pencil_lapl_model(
        Grid3D((512,) * 3, device="cpu", mesh=ProcessGrid((2, 2, 1), 3)), 4)["bytes"],
        384 * MIB)


def test_utils_exports_the_modules():
    """utils imports census and scaling; halo.COUNTS is the census's dict."""
    from poissbox_tpu_torch import utils
    from poissbox_tpu_torch.parallel import halo

    assert utils.census is census and utils.scaling is scaling
    assert halo.COUNTS is census.COUNTS
