"""Build and load the Hopper kernels of the port.

The CUDA sources under ``poissbox_tpu_torch/csrc`` are compiled at first
use with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, which :mod:`ctypes` loads. Nothing here includes PyTorch's
headers, so a build takes seconds, not the minutes that
``torch.utils.cpp_extension.load`` needs.

The library lands in ``poissbox_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that hashes the sources and the flags, so an
edited source rebuilds and an unchanged one loads the cached file. A
missing ``nvcc`` or a failed build raises: nothing falls back to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("stencil7.cu", "rbsor.cu")
HEADERS = ("common.cuh",)
# --fmad=false keeps every a*b+c as a rounded multiply and a rounded add,
# the grouping the plain PyTorch versions (and the Pallas kernels) use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last nvcc run


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default
    install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of poissbox_tpu_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpoissbox_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the cached one matches the sources."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    log = path.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}); log in {log}:\n"
                           + proc.stderr[-4000:])
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes for every entry: pointers and the stream as c_void_p (an
    untyped int argument would be cut to 32 bits)."""
    i, d, p = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    lib.poissbox_num_blocks.argtypes = [i, i, i]
    lib.poissbox_num_blocks.restype = i
    lib.poissbox_error_string.argtypes = [i]
    lib.poissbox_error_string.restype = ctypes.c_char_p
    lib.poissbox_stencil7.argtypes = [i, i, i, p, p, p, p, p, i, i, i, d, d, d, d]
    lib.poissbox_stencil7.restype = i
    lib.poissbox_rbsor.argtypes = ([i, i, i, i, p] + [p] * 9 + [i, i, i]
                                   + [d] * 6 + [i])
    lib.poissbox_rbsor.restype = i


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib
