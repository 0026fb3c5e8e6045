"""ctypes bindings of the port's native (C++) host components (port of
:mod:`poissbox_tpu.native`).

The reference's native layer is PETSc + MPI (C); this package holds the
port's own copies of the JAX package's two host-side native components:
the grid-decomposition planner (DMDA analogue, ``decomp.cpp``) and the
runtime options database (PETSc options-DB analogue, ``options.cpp``),
compiled into one shared library and loaded with ctypes. Each has a
pure-Python twin with identical semantics
(:mod:`poissbox_tpu_torch.parallel.decomp`,
:class:`poissbox_tpu_torch.config.Options`), held to it by
tests/test_torch_native.py and ``chip_smoke.py``'s native phase.

Build: at first use of a native function, or by :func:`build`, never at
import. It runs ``$CXX`` (``g++`` by default) with the JAX package's
Makefile flags (:data:`CXXFLAGS`) and writes the library into
``poissbox_tpu_torch/_build/`` under a name that hashes the sources and
the flags, so an edited source rebuilds. A failed build raises.
:func:`available` says whether the library is built;
``parallel.decomp.decompose_3d`` takes the native planner then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = ("decomp.cpp", "options.cpp")
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-Werror", "-shared")
_BOOL_TRUE = "\x01true"  # marker for value-less flags (options.cpp)

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last compile


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """The library's path: a hash of the sources, the compiler and the
    flags in its name."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    h.update(" ".join((_compiler(),) + CXXFLAGS).encode())
    return BUILD_DIR / f"libpoissbox_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the built one matches the sources;
    returns its path. A failed compile raises RuntimeError with the
    compiler's output."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.so")
    t0 = time.perf_counter()
    cmd = [_compiler(), *CXXFLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {exc}") from exc
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)    # atomic: a concurrent build writes the same file
    build_seconds = time.perf_counter() - t0
    return path


def available() -> bool:
    """True when the library for these sources is built (nothing is
    compiled here)."""
    return _lib is not None or library_path().exists()


def _load() -> ctypes.CDLL:
    """The library, built first where it is not."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    lib.pb_decompose_3d.restype = ctypes.c_int
    lib.pb_decompose_3d.argtypes = [i64, i64, i64, i64, p64, p64, p64]
    lib.pb_owned_box.restype = ctypes.c_int
    lib.pb_owned_box.argtypes = [i64] * 9 + [p64]
    lib.pb_dof_distribution.restype = ctypes.c_int
    lib.pb_dof_distribution.argtypes = [i64] * 6 + [p64]
    lib.pb_halo_bytes.restype = ctypes.c_int
    lib.pb_halo_bytes.argtypes = [i64] * 8 + [p64]
    lib.pb_options_create.restype = ctypes.c_void_p
    lib.pb_options_create.argtypes = []
    lib.pb_options_destroy.restype = None
    lib.pb_options_destroy.argtypes = [ctypes.c_void_p]
    lib.pb_options_parse.restype = ctypes.c_int
    lib.pb_options_parse.argtypes = [ctypes.c_void_p, i64,
                                     ctypes.POINTER(ctypes.c_char_p)]
    lib.pb_options_set.restype = ctypes.c_int
    lib.pb_options_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p]
    lib.pb_options_has.restype = ctypes.c_int
    lib.pb_options_has.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pb_options_get.restype = i64
    lib.pb_options_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, i64]
    lib.pb_options_count.restype = i64
    lib.pb_options_count.argtypes = [ctypes.c_void_p]
    lib.pb_options_key_at.restype = i64
    lib.pb_options_key_at.argtypes = [ctypes.c_void_p, i64, ctypes.c_char_p,
                                      i64]
    _lib = lib
    return lib


# -- decomposition planner ---------------------------------------------------

def decompose_3d(ndev: int, shape: Sequence[int]) -> tuple[int, int, int]:
    """(px, py, pz) for `ndev` ranks on grid `shape`
    (``parallel.decomp.decompose_3d``'s rule)."""
    lib = _load()
    px, py, pz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.pb_decompose_3d(ndev, *map(int, shape),
                             ctypes.byref(px), ctypes.byref(py),
                             ctypes.byref(pz))
    if rc:
        raise ValueError(f"cannot decompose {ndev} devices over {tuple(shape)}")
    return (px.value, py.value, pz.value)


def owned_box(shape, pgrid, coord) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """((xs, ys, zs), (xn, yn, zn)) of process coordinate `coord`."""
    lib = _load()
    out = (ctypes.c_int64 * 6)()
    rc = lib.pb_owned_box(*map(int, shape), *map(int, pgrid),
                          *map(int, coord), out)
    if rc:
        raise ValueError(f"bad owned-box query {pgrid} {coord}")
    return (int(out[0]), int(out[1]), int(out[2])), \
           (int(out[3]), int(out[4]), int(out[5]))


def dof_distribution(shape, pgrid) -> list[int]:
    """Per-rank DoF counts in rank order."""
    lib = _load()
    n = int(pgrid[0] * pgrid[1] * pgrid[2])
    out = (ctypes.c_int64 * n)()
    rc = lib.pb_dof_distribution(*map(int, shape), *map(int, pgrid), out)
    if rc:
        raise ValueError(f"bad dof query {shape} {pgrid}")
    return [int(v) for v in out]


def halo_bytes(shape, pgrid, width: int = 1, itemsize: int = 4) -> list[int]:
    """Bytes a rank sends an exchange along each axis (both directions,
    0 on an unsplit axis), for the largest owned box."""
    lib = _load()
    out = (ctypes.c_int64 * 3)()
    rc = lib.pb_halo_bytes(*map(int, shape), *map(int, pgrid),
                           width, itemsize, out)
    if rc:
        raise ValueError("bad halo query")
    return [int(v) for v in out]


# -- options database --------------------------------------------------------

class NativeOptions:
    """ctypes wrapper over the C++ options database (options.cpp).

    Same parse semantics as poissbox_tpu_torch.config.Options; value-less
    boolean flags come back as Python True.
    """

    def __init__(self, argv: Sequence[str] | None = None):
        lib = _load()
        self._lib = lib
        self._db = lib.pb_options_create()
        if argv:
            enc = [a.encode() for a in argv]
            arr = (ctypes.c_char_p * len(enc))(*enc)
            lib.pb_options_parse(self._db, len(enc), arr)

    def __del__(self):
        if getattr(self, "_db", None):
            self._lib.pb_options_destroy(self._db)
            self._db = None

    def has(self, key: str) -> bool:
        return bool(self._lib.pb_options_has(self._db, key.encode()))

    def set(self, key: str, value) -> None:
        v = _BOOL_TRUE if value is True else str(value)
        self._lib.pb_options_set(self._db, key.encode(), v.encode())

    def get(self, key: str, default=None):
        need = self._lib.pb_options_get(self._db, key.encode(), None, 0)
        if need < 0:
            return default
        buf = ctypes.create_string_buffer(need + 1)
        self._lib.pb_options_get(self._db, key.encode(), buf, need + 1)
        val = buf.value.decode()
        return True if val == _BOOL_TRUE else val

    def keys(self) -> list[str]:
        n = int(self._lib.pb_options_count(self._db))
        out = []
        for i in range(n):
            need = self._lib.pb_options_key_at(self._db, i, None, 0)
            buf = ctypes.create_string_buffer(need + 1)
            self._lib.pb_options_key_at(self._db, i, buf, need + 1)
            out.append(buf.value.decode())
        return out

    def as_dict(self) -> dict:
        return {k: self.get(k) for k in self.keys()}
