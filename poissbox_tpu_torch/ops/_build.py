"""Build and load the Hopper kernels of the port.

The CUDA sources under ``poissbox_tpu_torch/csrc`` are compiled at first
use with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, which :mod:`ctypes` loads: one ``nvcc -c`` per source, all
started together, then one link. Nothing here includes PyTorch's headers,
so a build takes seconds, not the minutes that
``torch.utils.cpp_extension.load`` needs.

The library lands in ``poissbox_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that hashes the sources and the flags, so an
edited source rebuilds and an unchanged one loads the cached file. A
missing ``nvcc`` or a failed build raises: nothing falls back to the plain
PyTorch versions.

This module is the only one that knows the library's C interface: besides
the entries' ``argtypes`` it holds the dtype codes, the pointer and stream
marshalling, the error strings and the launch counts. Each wrapper
(``stencil_cuda``, ``transfer_cuda``, ``compact_pcr``, ``tridiag_cuda``,
``spectral_cuda``, ``gmres_cuda``) checks its own arguments and calls
:func:`launch`, which counts every launch in :data:`LAUNCHES` under the key
the wrapper names (its kernel and mode), so a run can show which kernels
its path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("stencil7.cu", "rbsor.cu", "xfer.cu", "cgupd.cu", "compact.cu",
           "tridiag.cu", "spectral.cu", "gmres.cu")
HEADERS = ("common.cuh",)
# --fmad=false keeps every a*b+c as a rounded multiply and a rounded add,
# the grouping the plain PyTorch versions (and the Pallas kernels) use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last nvcc run

# dtype codes of the C interface (csrc/common.cuh DType)
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# successful launches by key ("<kernel>.<mode>", as each wrapper names them)
LAUNCHES: collections.Counter = collections.Counter()


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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libpoissbox_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the cached one matches the sources."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    # one compiler per source, all at once; then one link
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    steps = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        steps.append((c, p.returncode, out, err))
    if all(rc == 0 for _, rc, _, _ in steps):
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.returncode, proc.stdout, proc.stderr))
    build_seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = path.with_suffix(".log")
    log.write_text("".join(" ".join(c) + "\n" + out + err
                           for c, _, out, err in steps))
    failed = [(c, rc, err) for c, rc, _, err in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        c, rc, err = failed[0]
        raise RuntimeError(f"{c[-1]}: nvcc failed (exit {rc}); log in {log}:\n"
                           + err[-4000:])
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
    ll = ctypes.c_longlong
    lib.poissbox_stencil7.argtypes = [i, i, i, p, p, p, p, p, i, i, i] + [d] * 5
    lib.poissbox_stencil7.restype = i
    lib.poissbox_pupd_dot.argtypes = [i, i] + [p] * 7 + [i, i, i] + [d] * 4
    lib.poissbox_cheb.argtypes = [i, i, i, p] + [p] * 5 + [i, i, i] + [d] * 6
    lib.poissbox_cheb.restype = i
    lib.poissbox_pupd_dot.restype = i
    lib.poissbox_rbsor_sweep.argtypes = ([i, i, i, i, i, p] + [p] * 9 + [i, i, i]
                                         + [d] * 6 + [i])
    lib.poissbox_rbsor_sweep.restype = i
    lib.poissbox_rbsor_sweep_blocks.argtypes = [i, i, i]
    lib.poissbox_rbsor_sweep_blocks.restype = i
    lib.poissbox_rbsor_colour.argtypes = [i, i, i, p, p, p, p, i, i, i] + [d] * 6 + [i]
    lib.poissbox_rbsor_colour.restype = i
    lib.poissbox_xfer.argtypes = [i, i, i, i, i, p, p, p, p, i, i, i] + [d] * 5
    lib.poissbox_xfer.restype = i
    lib.poissbox_cgupd_blocks.argtypes = [ll, i]
    lib.poissbox_cgupd_blocks.restype = i
    lib.poissbox_cgupd.argtypes = [i, i] + [p] * 10 + [ll]
    lib.poissbox_cgupd.restype = i
    lib.poissbox_compact.argtypes = ([i, i, p, p, i] + [p] * 6
                                     + [ll, i, ll, i, i])
    lib.poissbox_compact.restype = i
    lib.poissbox_thomas.argtypes = [i, i, p] + [p] * 6 + [i, ll]
    lib.poissbox_thomas.restype = i
    lib.poissbox_babe.argtypes = [i, i, p] + [p] * 6 + [i, i, ll]
    lib.poissbox_babe.restype = i
    lib.poissbox_compact_thomas.argtypes = ([i, i, i, p] + [p] * 6 + [p] * 8
                                            + [d, d, i, i] * 2 + [i, ll])
    lib.poissbox_compact_thomas.restype = i
    lib.poissbox_strip_lanes.argtypes = [i, i, i, ll, i]
    lib.poissbox_strip_lanes.restype = i
    lib.poissbox_symbol_scale.argtypes = [i, i, i, p, p, p, p, d] + [i] * 6
    lib.poissbox_symbol_scale.restype = i
    lib.poissbox_gmres_blocks.argtypes = [i, i, i, i, ll, i]
    lib.poissbox_gmres_blocks.restype = i
    lib.poissbox_gmres_dots.argtypes = [i, i, i] + [p] * 4 + [i, ll, i]
    lib.poissbox_gmres_dots.restype = i
    lib.poissbox_gmres_update.argtypes = [i, i, i] + [p] * 6 + [i, ll, i]
    lib.poissbox_gmres_update.restype = i

def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer (None: a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of t's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, what: str) -> None:
    """Raise RuntimeError naming `what` if a library call returned the
    CUDA error `err`."""
    if err != 0:
        msg = load().poissbox_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch(entry: str, key: str, *args) -> None:
    """Call the library's `entry` with `args`; raise naming `key` if it
    fails, else count one launch of `key`."""
    err = getattr(load(), entry)(*args)
    if err:
        raise_on(err, key)
    LAUNCHES[key] += 1


def reset_launches() -> None:
    LAUNCHES.clear()
