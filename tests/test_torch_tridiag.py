"""The port's tridiagonal solvers against the JAX package, in float64:
the plain stack (ops.tridiag: tdma, tdma_periodic, TridiagFactor with
seq/pscan, the sweeps) and CudaTridiagFactor's plain versions of K13
(Thomas), K14 (circulant PCR) and K16 (the twisted factorization), held
to PallasTridiagFactor in interpret mode (Thomas and babe in float64, to
1e-12 relative; its PCR kernel takes float32 only, so PCR is compared in
float32 too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poissbox_tpu.ops import tridiag as jtri
from poissbox_tpu.ops.tridiag_pallas import PallasTridiagFactor
from poissbox_tpu_torch.ops import stencil_cuda, tridiag, tridiag_cuda
from poissbox_tpu_torch.ops.tridiag_cuda import CudaTridiagFactor

TOL = 1e-12


def rhs(shape, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape)


def compact_system(n, alpha=3.0 / 10.0, dtype=np.float64):
    return (np.full(n, alpha, dtype), np.ones(n, dtype), np.full(n, alpha, dtype))


def general_system(n, seed=3):
    """Diagonally dominant, not constant (Thomas only)."""
    g = np.random.default_rng(seed)
    a, c = g.uniform(-0.4, 0.4, n), g.uniform(-0.4, 0.4, n)
    return a, g.uniform(1.0, 2.0, n), c


def t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("shape,axis", [((16, 8, 12), 0), ((8, 16, 12), 1),
                                        ((8, 12, 16), 2), ((16,), 0)],
                         ids=["axis0", "axis1", "axis2", "1d"])
def test_factors_match_pallas_thomas(shape, axis, periodic):
    """Every port solver (CudaTridiagFactor thomas/pcr/auto on the CPU,
    TridiagFactor seq/pscan) against the Pallas Thomas kernel."""
    n = shape[axis]
    sysm = compact_system(n) if periodic else general_system(n)
    d = rhs(shape, 4)
    ref = np.asarray(PallasTridiagFactor(*map(jnp.asarray, sysm), periodic=periodic,
                                         algorithm="thomas").solve(jnp.asarray(d), axis))
    algos = ["thomas", "babe", "auto"] + (["pcr"] if periodic else [])
    for alg in algos:
        fac = CudaTridiagFactor(*t(*sysm), periodic=periodic, algorithm=alg)
        close(fac.solve(torch.as_tensor(d), axis).numpy(), ref)
    for method in ("seq", "pscan"):
        fac = tridiag.TridiagFactor(*t(*sysm), periodic=periodic, method=method)
        close(fac.solve(torch.as_tensor(d), axis).numpy(), ref)


@pytest.mark.parametrize("n", [16, 40])
def test_pcr_matches_pallas_pcr_f32(n):
    """K14's plain version against the Pallas PCR kernel in float32 (at
    n = 40 the JAX package refuses PCR — Mosaic's extent gate — so the
    reference there is its Thomas kernel)."""
    sysm = compact_system(n, 9.0 / 62.0, np.float32)
    d = rhs((n, 8, 16), 5).astype(np.float32)
    alg = "pcr" if n == 16 else "thomas"
    ref = np.asarray(PallasTridiagFactor(*map(jnp.asarray, sysm), periodic=True,
                                         algorithm=alg).solve(jnp.asarray(d), 0))
    fac = CudaTridiagFactor(*t(*sysm), periodic=True)
    assert fac.algorithm == "pcr"
    got = fac.solve(torch.as_tensor(d), 0)
    assert got.dtype == torch.float32
    close(got.numpy(), ref, 2e-6)


def test_algorithm_selection():
    per = t(*compact_system(40))
    assert CudaTridiagFactor(*per, periodic=True).algorithm == "pcr"
    assert CudaTridiagFactor(*per, periodic=False).algorithm == "thomas"
    assert CudaTridiagFactor(*t(*general_system(40)), periodic=True).algorithm == "thomas"
    with pytest.raises(ValueError):
        CudaTridiagFactor(*t(*general_system(16)), periodic=True, algorithm="pcr")
    babe = CudaTridiagFactor(*per, periodic=True, algorithm="babe")
    assert babe.algorithm == "babe" and babe.babe_m == 19
    assert len(babe.babe) == 4 and babe.babe[3].shape == (43,)   # corr: n + 3
    with pytest.raises(ValueError):
        CudaTridiagFactor(*per, periodic=True, algorithm="cr")


@pytest.mark.parametrize("n", [32, 33])
@pytest.mark.parametrize("periodic", [True, False])
def test_babe_matches_pallas_babe(periodic, n):
    """K16's plain version against the Pallas babe kernel on a
    variable-coefficient system: an even and an odd split (m = 15 at both
    n, the upward sweep one row longer at 33), to 1e-12 relative."""
    sysm = general_system(n, seed=n)
    d = rhs((n, 8, 16), 9)
    ref = PallasTridiagFactor(*map(jnp.asarray, sysm), periodic=periodic,
                              algorithm="babe").solve(jnp.asarray(d), 0)
    fac = CudaTridiagFactor(*t(*sysm), periodic=periodic, algorithm="babe")
    assert fac.babe_m == (n - 2) // 2
    close(fac.solve(torch.as_tensor(d), 0).numpy(), ref)
    # the setup's operands equal the JAX package's
    jfac = PallasTridiagFactor(*map(jnp.asarray, sysm), periodic=periodic,
                               algorithm="babe")
    for got, want in zip(fac.babe, (jfac.babe_wv, jfac.babe_binv, jfac.babe_ca,
                                    jfac.babe_corr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_babe_small_and_moved_axes():
    """The twisted solve at the smallest splits (n = 2, 3, 4: m = 0, 0, 1)
    and along a moved axis, against the plain Thomas solve."""
    for n in (2, 3, 4):
        sysm = general_system(n, seed=n)
        d = torch.as_tensor(rhs((n, 5), n))
        for periodic in (True, False):
            got = CudaTridiagFactor(*t(*sysm), periodic=periodic, algorithm="babe").solve(d, 0)
            ref = tridiag.TridiagFactor(*t(*sysm), periodic=periodic, method="seq").solve(d, 0)
            close(got.numpy(), ref.numpy())
    d = torch.as_tensor(rhs((6, 7, 33), 10))
    sysm = general_system(33)
    close(CudaTridiagFactor(*t(*sysm), periodic=True, algorithm="babe").solve(d, 2).numpy(),
          tridiag.TridiagFactor(*t(*sysm), periodic=True, method="seq").solve(d, 2).numpy())


def test_cuda_factor_on_cpu_launches_nothing():
    d = torch.as_tensor(rhs((16, 4, 4), 6))
    stencil_cuda.reset_launches()
    for alg in ("thomas", "pcr", "babe"):
        CudaTridiagFactor(*t(*compact_system(16)), periodic=True,
                          algorithm=alg).solve(d)
    assert not any(stencil_cuda.LAUNCHES.values())


@pytest.mark.parametrize("method", ["seq", "pscan"])
def test_tdma_and_sweeps_match_jax(method):
    n = 12
    a, b, c = general_system(n, 7)
    d = rhs((n, 5), 8)
    close(tridiag.tdma(*t(a, b, c, d), axis=0, method=method).numpy(),
          jtri.tdma(*map(jnp.asarray, (a, b, c, d)), axis=0, method=method))
    close(tridiag.tdma_periodic(*t(a, b, c, d), axis=0, method=method).numpy(),
          jtri.tdma_periodic(*map(jnp.asarray, (a, b, c, d)), axis=0,
                             method=method))
    bm, dm = tridiag.fwd_sweep(*t(a, b, c, d), axis=0, method=method)
    jbm, jdm = jtri.fwd_sweep(*map(jnp.asarray, (a, b, c, d)), axis=0, method=method)
    close(bm.numpy(), jbm)
    close(dm.numpy(), jdm)
    close(tridiag.bwd_sweep(bm, torch.as_tensor(c), dm, axis=0, method=method).numpy(),
          jtri.bwd_sweep(jbm, jnp.asarray(c), jdm, axis=0, method=method))


def test_linrec_rejects_unknown_method():
    with pytest.raises(ValueError):
        tridiag.tdma(*t(*general_system(8)), torch.ones(8), method="cr")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [8, 33, 64, 96])
def test_babe_strip_mirror_matches_plain(n, dtype):
    """K16's strip kernel mirrored on the CPU (babe_strip_mirror: loads
    from both ends by chunks, both eliminations in place, the middle row,
    the outward back substitution, the corrected store) at 32 and 16
    lanes, periodic and not, bit for bit equal to the plain version; n =
    33 is the odd split, and 37 lines leave a ragged last block."""
    d = torch.as_tensor(rhs((n, 37), n), dtype=dtype)
    for periodic in (True, False):
        sysm = general_system(n, seed=n + 1)
        fac = CudaTridiagFactor(*(torch.as_tensor(v, dtype=dtype) for v in sysm),
                                periodic=periodic, algorithm="babe")
        ops = fac._on("cpu", "babe")
        ref = tridiag_cuda.babe_plain(*ops, d, fac.babe_m)
        for lanes in (32, 16):
            got = tridiag_cuda.babe_strip_mirror(*ops, d, fac.babe_m, lanes=lanes)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (periodic, lanes)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_babe_strip_mirror_smallest_splits(n):
    """The strip mirror where the two halves are one or two rows long."""
    d = torch.as_tensor(rhs((n, 5), n))
    for periodic in (True, False):
        fac = CudaTridiagFactor(*t(*general_system(n, seed=n)), periodic=periodic,
                                algorithm="babe")
        ops = fac._on("cpu", "babe")
        assert torch.equal(tridiag_cuda.babe_strip_mirror(*ops, d, fac.babe_m),
                           tridiag_cuda.babe_plain(*ops, d, fac.babe_m))


def _thomas_ops(n, dtype, periodic, variable):
    """K13's factor vectors on the CPU: the bench's constant system or a
    variable-coefficient one."""
    sysm = general_system(n, seed=n + 2) if variable else compact_system(n)
    fac = CudaTridiagFactor(*(torch.as_tensor(v, dtype=dtype) for v in sysm),
                            periodic=periodic, algorithm="thomas")
    return fac._on("cpu", "thomas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 33, 64, 96])
def test_thomas_strip_mirror_matches_plain(n, dtype):
    """K13's strip kernel mirrored on the CPU (thomas_strip_mirror: chunked
    loads, the forward sweep in place once a chunk lands, the back
    substitution on the strip, the corrected store) at 32 and 16 lanes,
    periodic and not, constant and variable coefficients, bit for bit
    equal to the plain version; n = 2..5 are the smallest chunks, 33 and 96
    leave a ragged chunk, and 37 lines a ragged last block."""
    d = torch.as_tensor(rhs((n, 37), n), dtype=dtype)
    for periodic in (True, False):
        for variable in (False, True):
            ops = _thomas_ops(n, dtype, periodic, variable)
            ref = tridiag_cuda.thomas_plain(*ops, d)
            for lanes in (32, 16):
                got = tridiag_cuda.thomas_strip_mirror(*ops, d, lanes=lanes)
                assert got.dtype == ref.dtype and torch.equal(got, ref), (
                    periodic, variable, lanes)


def test_thomas_strip_mirror_catches_a_short_wait(monkeypatch):
    """The mirror shows the fault it is there for: a sweep that waits for
    one group fewer (not group c itself) reads rows that have not landed,
    and the result differs from the plain version."""
    ops = _thomas_ops(64, torch.float64, True, True)
    d = torch.as_tensor(rhs((64, 37), 3))
    ref = tridiag_cuda.thomas_plain(*ops, d)
    assert torch.equal(tridiag_cuda.thomas_strip_mirror(*ops, d), ref)
    wait = tridiag_cuda._Feed.wait
    monkeypatch.setattr(tridiag_cuda._Feed, "wait", lambda self, k: wait(self, k and k + 1))
    assert not torch.equal(tridiag_cuda.thomas_strip_mirror(*ops, d), ref)


class _FakeLib:
    """The kernel library's entries that K13's route calls, recorded: the
    strip lanes to answer and the launch's error code."""

    def __init__(self, lanes, err=0):
        self.lanes, self.err, self.calls = lanes, err, []

    def poissbox_strip_lanes(self, *args):
        self.calls.append(("strip_lanes",) + args)
        return self.lanes

    def poissbox_thomas(self, *args):
        self.calls.append(("thomas",) + args)
        return self.err

    def poissbox_error_string(self, err):
        return b"fake error"


@pytest.fixture
def fake_lib(monkeypatch):
    """Installs a _FakeLib as the loaded library (no card, no nvcc) and
    stands a null stream and device 0 in for the card's."""
    from poissbox_tpu_torch.ops import _build

    def install(lanes, err=0):
        lib = _FakeLib(lanes, err)
        monkeypatch.setattr(_build, "load", lambda: lib)
        monkeypatch.setattr(_build, "stream", lambda t: None)
        monkeypatch.setattr(tridiag_cuda, "_index", lambda device: 0)
        tridiag_cuda._strip_lanes.cache_clear()
        return lib

    yield install
    tridiag_cuda._strip_lanes.cache_clear()


@pytest.mark.parametrize("lanes,key", [(32, "tridiag.thomas"), (16, "tridiag.thomas"),
                                       (0, "tridiag.thomas.long")])
def test_thomas_route_asks_strip_lanes(fake_lib, lanes, key):
    """K13's launch asks strip_lanes with its own mode code (5) and counts
    the strip kernel as tridiag.thomas, the streaming one as .long; the
    C entry takes (dtype, device, stream, d, x, w, binv, cb, corr, n, Q)."""
    lib = fake_lib(lanes)
    assert tridiag_cuda._MODES["thomas"] == 5
    assert tridiag_cuda.strip_lanes("thomas", 64, 4096, torch.float64, "cuda:0") == lanes
    assert lib.calls[-1] == ("strip_lanes", 1, 5, 64, 4096, 0)
    fac = CudaTridiagFactor(*t(*compact_system(64)), periodic=True, algorithm="thomas")
    d2 = torch.as_tensor(rhs((64, 96), 5))
    stencil_cuda.reset_launches()
    fac._launch(d2, fac._on("cpu", "thomas"), babe=False)
    assert stencil_cuda.LAUNCHES[key] == 1 and sum(stencil_cuda.LAUNCHES.values()) == 1
    name, *args = lib.calls[-1]
    assert name == "thomas" and len(args) == 11 and args[0] == 1 and args[-2:] == [64, 96]


def test_thomas_launch_error_raises(fake_lib):
    """A launch that fails raises; nothing falls back to the plain version."""
    fake_lib(32, err=9)
    fac = CudaTridiagFactor(*t(*compact_system(16)), periodic=True, algorithm="thomas")
    stencil_cuda.reset_launches()
    with pytest.raises(RuntimeError, match="tridiag.thomas launch failed"):
        fac._launch(torch.as_tensor(rhs((16, 8), 2)), fac._on("cpu", "thomas"), babe=False)
    assert not any(stencil_cuda.LAUNCHES.values())
