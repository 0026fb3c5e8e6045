"""The port's native (C++) host components: the ctypes-bound planner and
options database (poissbox_tpu_torch/native) against their Python twins in
the port (parallel/decomp.py, config.Options) and in the JAX package
(poissbox_tpu.parallel.decomp, poissbox_tpu.config.Options), the cases of
tests/test_native.py. The library is built in a fixture: a failed build
fails these tests."""

import itertools

import pytest

from poissbox_tpu.config import Options as JOptions
from poissbox_tpu.parallel import decomp as jdecomp
from poissbox_tpu_torch import native
from poissbox_tpu_torch.config import Options
from poissbox_tpu_torch.mesh import Grid3D, ProcessGrid
from poissbox_tpu_torch.parallel import decomp
from poissbox_tpu_torch.utils import census

SHAPES = [(64, 64, 64), (128, 64, 32), (60, 60, 60), (256, 256, 256)]
DOF_CASES = [((64, 64, 64), (2, 2, 2)), ((65, 64, 63), (3, 2, 1)), ((7, 7, 7), (2, 2, 2)),
             ((64, 64, 64), (3, 1, 1))]
OPTION_CASES = [
    ["-ksp_type", "cg", "-ksp_rtol", "1e-9"],
    ["-ksp_monitor", "-pc_type", "mg"],
    ["-ksp_rtol=1e-8", "-mg_levels", "3"],
    ["-ksp_shift", "-1.5e-3"],          # a negative number as a value
    ["stray", "-flag1", "-flag2", "val"],
    ["-a", "-b", "-c", "x", "-d=e"],
]


@pytest.fixture(scope="module", autouse=True)
def built():
    return native.build()


def test_library_is_the_ports_own(built):
    """Built from the port's sources into poissbox_tpu_torch/_build under
    a hashed name; the JAX package's library is never the one loaded."""
    assert built == native.library_path()
    assert built.parent.name == "_build" and built.parent.parent.name == "poissbox_tpu_torch"
    assert built.name.startswith("libpoissbox_native_") and native.available()
    assert native._load()._name == str(built)


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 6, 8, 16, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_decompose_matches_python(ndev, shape):
    got = native.decompose_3d(ndev, shape)
    assert got == decomp.python_decompose_3d(ndev, shape)
    assert got == jdecomp.decompose_3d(ndev, shape)


def test_decompose_dispatches_to_the_native_planner(monkeypatch):
    """decomp.decompose_3d runs the built library, and a failure there
    raises (no fall-back to the Python planner)."""
    calls = []
    monkeypatch.setattr(native, "decompose_3d", lambda n, s: calls.append((n, s)) or (9, 9, 9))
    assert decomp.decompose_3d(3, (64, 64, 64)) == (9, 9, 9) and calls

    def fail(n, s):
        raise OSError("the library failed")
    monkeypatch.setattr(native, "decompose_3d", fail)
    with pytest.raises(OSError):
        decomp.decompose_3d(3, (64, 64, 64))


def test_reference_dof_split():
    # reference README.md:25-33
    assert native.dof_distribution((64, 64, 64), (3, 1, 1)) == [90112, 86016, 86016]


@pytest.mark.parametrize("shape,pgrid", [((10, 7, 5), (3, 2, 1)), ((64, 64, 64), (3, 1, 1)),
                                         ((16, 9, 20), (2, 3, 4))])
def test_owned_boxes_match_python(shape, pgrid):
    py, jpy = decomp.owned_boxes(shape, pgrid), jdecomp.owned_boxes(shape, pgrid)
    for coord in itertools.product(*(range(p) for p in pgrid)):
        assert native.owned_box(shape, pgrid, coord) == py[coord] == jpy[coord]


@pytest.mark.parametrize("shape,pgrid", DOF_CASES)
def test_dof_distribution_matches_python(shape, pgrid):
    got = native.dof_distribution(shape, pgrid)
    assert got == decomp.dof_distribution(shape, pgrid) == jdecomp.dof_distribution(shape, pgrid)


@pytest.mark.parametrize("ndev,shape", [(128, (2, 2, 2)), (5, (4, 4, 4))])
def test_invalid_rejected(ndev, shape):
    with pytest.raises(ValueError):
        native.decompose_3d(ndev, shape)
    with pytest.raises(ValueError):
        decomp.python_decompose_3d(ndev, shape)


def test_halo_bytes():
    # each local block of 64^3 over (2,2,1) is (32, 32, 64): x and y send
    # 2 * 32*64 planes of f32
    got = native.halo_bytes((64, 64, 64), (2, 2, 1), width=1, itemsize=4)
    assert got == [2 * 32 * 64 * 4, 2 * 32 * 64 * 4, 0]


@pytest.mark.parametrize("shape,pgrid,itemsize", [((64, 64, 64), (2, 2, 1), 4),
                                                  ((32, 16, 24), (2, 2, 2), 8),
                                                  ((48, 32, 32), (4, 1, 1), 8)])
def test_halo_bytes_match_the_census_model(shape, pgrid, itemsize):
    """On an even decomposition the planner's exchange bytes are one
    exchange of census.halo_model, every rank."""
    for rank in range(pgrid[0] * pgrid[1] * pgrid[2]):
        g = Grid3D(shape, device="cpu", mesh=ProcessGrid(pgrid, rank))
        assert sum(native.halo_bytes(shape, pgrid, 1, itemsize)) == \
            census.halo_model(g, itemsize)["bytes"]


@pytest.mark.parametrize("argv", OPTION_CASES)
def test_parse_matches_python(argv):
    nat = native.NativeOptions(argv).as_dict()
    assert nat == Options(argv).as_dict() == JOptions(argv).as_dict()


def test_set_get_roundtrip():
    db = native.NativeOptions()
    db.set("-ksp_rtol", 1e-10)
    db.set("monitor", True)
    assert db.has("ksp_rtol") and db.has("-monitor")
    assert db.get("ksp_rtol") == "1e-10"
    assert db.get("monitor") is True
    assert db.get("absent", "fallback") == "fallback"


def test_overwrite_keeps_order():
    db = native.NativeOptions(["-a", "1", "-b", "2"])
    db.set("a", "3")
    assert db.keys() == ["a", "b"]
    assert db.get("a") == "3"
