"""Runtime options database — the PETSc options-DB replacement.

The reference's *entire* configuration system is PETSc's string-keyed
options database: every object opts in via SetFromOptions (reference
src/poissbox.f90:201,223,231,235,295) and the solver of record is assembled
from CLI flags (`-ksp_type cg -pc_type gamg -mg_coarse_sub_pc_type svd
-mg_levels_ksp_rtol 1.0e-4 -mg_levels_ksp_type richardson
-mg_levels_pc_type sor`, reference README.md:42-49). :class:`Options`
reproduces those semantics — string keys, leading-dash CLI syntax, value-less
boolean flags (`-ksp_monitor`), typed getters with defaults — and
:class:`SolverOptions` is the typed view the solvers consume.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Optional, Sequence


def _looks_like_flag(tok: str) -> bool:
    """A token starting with '-' is a flag unless it parses as a number
    (so `-ksp_shift -1.5e-3` works)."""
    if not tok.startswith("-") or len(tok) == 1:
        return False
    try:
        float(tok)
        return False
    except ValueError:
        return True


class Options:
    """String-keyed runtime options with PETSc-style CLI parsing."""

    def __init__(self, source: Mapping[str, Any] | Sequence[str] | None = None):
        self._db: dict[str, Any] = {}
        # consumption tracking for the `-options_left` analogue: PETSc
        # reports options that were set but never queried by any object
        # (reference src/poissbox.f90:295 wires every object through the
        # same DB; a misspelled flag is a silent no-op without this)
        self._used: set[str] = set()
        if source is None:
            return
        if isinstance(source, Mapping):
            self._db.update({k.lstrip("-"): v for k, v in source.items()})
        else:
            self._parse(list(source))

    def _parse(self, argv: Iterable[str]) -> None:
        toks = list(argv)
        i = 0
        while i < len(toks):
            tok = toks[i]
            if not _looks_like_flag(tok):
                i += 1
                continue  # ignore stray positionals, as PETSc does
            key = tok.lstrip("-")
            if "=" in key:
                key, val = key.split("=", 1)
                self._db[key] = val
                i += 1
            elif i + 1 < len(toks) and not _looks_like_flag(toks[i + 1]):
                self._db[key] = toks[i + 1]
                i += 2
            else:
                self._db[key] = True  # value-less boolean flag
                i += 1

    # -- accessors -----------------------------------------------------------
    def has(self, key: str) -> bool:
        return key.lstrip("-") in self._db

    def set(self, key: str, value: Any) -> None:
        self._db[key.lstrip("-")] = value

    def get(self, key: str, default: Any = None) -> Any:
        k = key.lstrip("-")
        if k in self._db:
            self._used.add(k)
        return self._db.get(k, default)

    def get_str(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        return int(v) if not isinstance(v, bool) else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        return float(v) if not isinstance(v, bool) else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, bool):
            return v
        return str(v).lower() in ("1", "true", "yes", "on")

    def as_dict(self) -> dict[str, Any]:
        return dict(self._db)

    # -- `-options_left` analogue ---------------------------------------------
    def used_keys(self) -> set[str]:
        return set(self._used)

    def unused_keys(self) -> list[str]:
        """Options set but never queried — typos, misspellings, and flags no
        object consumed (PETSc `-options_left` semantics)."""
        return sorted(k for k in self._db if k not in self._used
                      and k not in ("options_left", "options_error_if_unused"))

    def check_unused(self, error: bool | None = None) -> list[str]:
        """Warn (or raise) listing options nothing consumed.

        `error=None` reads `-options_error_if_unused` from the DB itself;
        call after solver assembly, as the reference's PetscFinalize does
        with `-options_left` (PETSc options-DB semantics, reference
        src/poissbox.f90:295).
        """
        left = self.unused_keys()
        if error is None:
            error = self.get_bool("options_error_if_unused")
        if left:
            msg = ("option(s) set but never used: "
                   + " ".join(f"-{k}" for k in left))
            if error:
                raise ValueError(msg)
            import warnings
            warnings.warn(msg, stacklevel=2)
        return left

    def __repr__(self) -> str:
        return f"Options({self._db!r})"


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Typed solver configuration assembled from an options database.

    Defaults mirror PETSc's: ksp_type gmres (PETSc's default KSP), rtol 1e-5,
    pc_type none. The reference's recommended configuration maps to
    ksp_type=cg, pc_type=mg with richardson+sor level smoothers and an SVD
    coarse solve (reference README.md:42-47).
    """

    ksp_type: str = "gmres"        # cg | fcg | pipecg | gmres | fgmres | richardson | fft
    ksp_norm_type: str = "unpreconditioned"  # unpreconditioned | natural (cg)
    ksp_rtol: float = 1.0e-5
    ksp_atol: float = 1.0e-50
    ksp_max_it: int = 10000
    ksp_monitor: bool = False
    ksp_converged_reason: bool = False
    ksp_view: bool = False         # print the assembled solver (KSPView)
    pc_type: str = "none"          # none | jacobi | mg
    mg_levels: int = 0             # 0 = auto (coarsen to the smallest grid)
    mg_levels_ksp_type: str = "richardson"
    mg_levels_pc_type: str = "sor"  # sor (red-black) | jacobi
    # Level-solve stopping controls (PETSc stops at rtol OR max_it,
    # whichever binds first; reference README.md:43-44 sets rtol 1e-4).
    # Negative = UNSET: when neither is given, the sweep count is resolved
    # size-aware by solvers.mg._resolve_sweeps (V(1,1) at 512^3-class,
    # V(2,2) at 256^3-class, V(3,3) below — the measured end-to-end
    # optima), so the options entry point and MGConfig() defaults build
    # the same cycle.
    # Explicit flags take the calibrated sweeps_for_level_rtol path.
    mg_levels_ksp_max_it: int = -1
    mg_levels_ksp_rtol: float = -1.0
    mg_levels_damping: float = 1.0  # richardson damping / jacobi weight
    mg_coarse_pc_type: str = "svd"  # svd | direct
    mg_transfers: str = "auto"      # auto | roll | matmul (auto: matmul on CUDA)
    mg_impl: str = "auto"           # auto | roll | cuda level operators (pallas = cuda)
    mg_cycles: int = 1              # V-cycles per preconditioner application
    mg_cycle: str = "v"             # v | w (W revisits sub-fine levels twice)
    mg_cycle_dtype: str = ""        # "" = field dtype | bfloat16 | float32
    mg_pre_dtype: str = ""          # pre-smoother dtype (output stays exact)
    gmres_restart: int = 30

    @classmethod
    def from_options(cls, opts: Options) -> "SolverOptions":
        d = {}
        for f in dataclasses.fields(cls):
            if not opts.has(f.name):
                continue
            if f.type in ("float", float):
                d[f.name] = opts.get_float(f.name)
            elif f.type in ("int", int):
                d[f.name] = opts.get_int(f.name)
            elif f.type in ("bool", bool):
                d[f.name] = opts.get_bool(f.name)
            else:
                d[f.name] = opts.get_str(f.name)
        return cls(**d)
