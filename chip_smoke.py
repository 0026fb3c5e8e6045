#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Drives poissbox_tpu_torch on the card, through the hand-written kernels,
and fails loudly if any phase fails:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the kernels from poissbox_tpu_torch/csrc with nvcc
     (one compiler per source, in parallel);
  2b. native planner: builds the port's C++ library (poissbox_tpu_torch/
     native: decomp.cpp, options.cpp) with g++ and holds decompose_3d,
     owned_box, dof_distribution and halo_bytes to the Python planner on
     every decomposition of paths (m) and (n) and the weak-scaling rung
     (at the end of the run, NativeOptions to config.Options on every argv
     list the run parsed);
  3. kernels: every stencil7 epilogue (K12's p-update prologue
     included), rbsor mode (K11's single colour update and the one-launch
     sweeps), xfer leg and the CG update against its plain PyTorch version
     on the same card (64^3 f64, 256^3 f32, an anisotropic grid; the bf16
     modes on the f32 cases and 512^3; the stencil7 epilogues, bf16 too, at
     (48, 40, 96) f32; KA, KB and K6 also at a ragged (40, 36, 52) in f64
     and f32, at 4^3 and 8^3 f64 and at odd (6, 5, 7) extents; KA's grid
     against ops/stencil_cuda.ka_blocks), then kernel, plain and bound
     times at 256^3 f32 and, for the modes of the 512^3 path (and K2, K12),
     at 512^3 f32, with K2's share of its floor; K1 beside Conv3d; K11 bit
     for bit at every distributed block (DIST_BLOCKS), (6, 5, 7), (9, 6, 5),
     (40, 36, 52), (64, 32, 48), 256^3 and 512^3 in f32, f64
     (below 256^3) and bf16, both colours, cubic cells and not, and
     timed in bf16 at the (2, 2, 1) block of 512^3
     and at 512^3, in f32 at 256^3 and the block; then the
     one-launch general sweep against two K11 launches at 256^3 f32 and
     512^3 bf16, seven pairs in turns;
  4. transfers: the banded-matrix y/z transfers against the roll form in
     f32 with TF32 allowed globally (the contractions must not use it),
     and their times against the roll form's;
  5. compact and tridiagonal kernels: K15 (lapl, grad, div, interp, op_1d:
     compact.z/y/x; the register kernel for lines of 32 m points, the tile
     kernel for the rest, each case printing the kernels it took and the
     tile kernel's lane widths held bit-equal), K13/K14/K16
     (tridiag.thomas/pcr/babe; K13 also on a non-periodic and on a
     variable-coefficient system, periodic and not) and K17's four modes
     (tridiag.compact/dual/chain/sum) against their plain versions at 64^3
     f64, (48, 40, 96) f32 and f64 (both K15 kernels in one Laplacian),
     (33, 20, 24) f64 (an odd split for K16), 96^3 f32, 256^3 f32 and
     512^3 f32 and f64, K13-K17 bit for bit; sweep, Laplacian and solve
     times with their bounds and each K15 sweep's share of its floor
     (512^3 f64: the sweeps and the Laplacian), K13/K14/K16 beside
     torch.linalg.lu_solve; K13's, K16's and K17's strip kernels timed at
     every size the paths give them (64^3 f64, 96^3, 256^3 and 512^3 f32,
     512^3 f64) with the lanes they take and their share of the floor;
  3b. the spectral solves' symbol multiply (csrc/spectral.cu), both
     forms, bit for bit against its plain version at 512^3 f32, 64^3 f64
     and an odd length along z ((48, 40, 97) f32 and f64, anisotropic
     cells), then timed at 512^3 f32 against its byte floor (each
     complex64 of the half spectrum read once and written once);
  5b. K13's, K16's and K17's strip kernels: every variant (32 or 16
     lanes, staggered workers or not) and the streaming kernel at the same
     five sizes, each held bit-equal to its plain version once, then timed
     in turns; then lines too long for a strip ((2048, 16, 16)
     f32, (1024, 16, 16) f64) through the streaming kernels (the .long
     counters), bit-equal to the plain versions;
  6. paths, each with the launch counters reset before and read after
     (failing if a red-black sweep took two launches), each checked against
     the plain PyTorch path on the card (impl="roll", transfers="roll"; for
     the compact operator method="pscan"), with warm solve times:
       (a)   MG-CG through the fused transfer legs (K6/K7): 64^3 f64 rtol
             1e-8 (6 iterations), 256^3 f32 rtol 1e-6 (5), the demo at 64^3;
             after the counted run, a torch.profiler breakdown of one warm
             256^3 solve, the demo with -log_view, and the utils on the
             card: check_field on the 64^3 solution, and the NaN checks
             raising FloatingPointError on a 64^3 b that holds a NaN (and,
             once turned off, the solve stopping with DIVERGED_NAN);
       (a/r) the same solves with -mg_transfers roll through the kernels;
       (b)   512^3 f32 rtol 1e-6, the default MGConfig: V(1,1), bf16
             pre-smooth, K5 storing x1 in bf16, K6/K7 reading it (7); a
             torch.profiler breakdown of one warm solve;
       (b/r) the same with -mg_transfers roll (CG then takes K8);
       (b/s) 512^3 f32 with the bf16 pre-smooth of the Chebyshev smoother
             (KA's bf16 residual), of two-sweep Jacobi (K10 in bf16) and of
             two-sweep SOR (K4 in bf16);
       (c)   256^3 f32 rtol 1e-6 with -mg_levels_pc_type jacobi: K10 on
             every level, CG on K8 and apply_dots;
       (d)   PoissonSolver(order=6), CG + the 2nd-order GMG: 64^3 f64 rtol
             1e-8, 256^3 f32 rtol 1e-3 (what f32 can certify there), 48^3
             f64 rtol 1e-8 (K15's tile kernel; the others take the
             register kernel); a torch.profiler breakdown of one warm
             256^3 solve;
       (e)   -ksp_type fft at 512^3 f32, order 2 and order 6; FCG with
             -pc_type fft on order 6 at 256^3 f32 and f64;
       (f)   the batched periodic tridiagonal solve of the JAX package's
             bench at 512^3 f32 and at 64^3 f64: CudaTridiagFactor, PCR
             (auto), Thomas (K13) and the twisted factorization (K16), K13
             and K16 on their strip kernels; after the path's counters are
             read, K16 timed against K13;
       (g)   GMRES(30), the default KSP: with -pc_type mg at 64^3 f64 rtol
             1e-8 and 512^3 f32 rtol 1e-6 (a 31-field basis, 16.6 GB),
             with -pc_type none at 64^3 f64 for 60 iterations (K2 through
             use_fused; history against the plain path's), the demo;
             FGMRES(30) + MG at 64^3 f64 rtol 1e-8 and 512^3 f32 rtol 1e-6
             (the bf16 pre-smooth; V's and Z's 61 fields, 32.7 GB), each
             held to the true residual <= 1.01 rtol, and its -ksp_view;
       (h)   PIPECG + MG at 64^3 f64 and 256^3 f32, Richardson + MG at
             256^3 f32;
       (i)   CG with the deferred p-update (K12 bound on the operator) at
             256^3 and 512^3 f32, and 512^3 with roll transfers (K8 +
             K12): the eager path's iterations, warm deferred vs eager;
       (j)   solve_refined (float32 MG-CG inner solves, float64 residuals)
             to 1e-12 at 512^3 beside float64 MG-CG, and at 128^3 against
             the plain path;
       (k)   solve_checkpointed at 256^3 f32, every 2 iterations, in a
             temporary directory: killed after chunk 0 and resumed equals
             the uninterrupted run; a b one ulp away starts fresh;
       (l)   order 6 through K17: the compact operator with
             method="pallas" (the JAX package's layout-cycled Thomas
             pipeline) solved by CG + GMG at 64^3 f64 rtol 1e-8, 256^3 and
             96^3 f32 rtol 1e-3 (K17's launches printed by size), with the
             K15 path's iterations on the same b; then K17's Laplacian
             against K15's at 512^3 f32 and f64, seven pairs in turns.

  7. distributed Krylov solves, path (m): the parent builds the library,
     runs each case on one rank (the reference: iterations, x, b = A u by
     K1, the warm wall), then spawns one process a rank (`--dist-worker`,
     each within DIST_TIMEOUT) that drives PoissonSolver(shard=pgrid):
     (2,2,1) 512^3 f32 rtol 1e-6, the default cycle: MG-CG (7 iterations,
     as one rank), PIPECG, GMRES(30) (its pre-smooth in float32) and
     Richardson + MG, solve_refined to 1e-12 (float64 b), the MG-CG solve
     with -log_view (the table printed by rank 0 alone, its events and
     counts the one-rank table's, its GDoF/s the global DoF count's), and
     at 256^3 f32 solve_checkpointed every 2 iterations, killed after
     chunk 0 and resumed (bit-equal to the uninterrupted run) and over a b
     one ulp away on rank 1 (every rank starts fresh); (3,1,1) 64^3 f64
     rtol 1e-8, the reference's 90112/86016/86016 split, the matvec within
     1e-13 of one rank's K1: MG-CG (6 iterations, the JAX package's count
     there), with the Jacobi smoother (K10, 7, the one-rank count), PIPECG
     and GMRES(30) + MG, and GMRES -pc_type none to rtol 1e-5 (K2 in the
     Gram-Schmidt step); (2,2,2) 64^3 f64 MG-CG, 8 ranks (6). On every
     rank the counters are reset before rhs_for + the run + residual_norm
     and read after; rank 0's counts and the sums over ranks are printed
     with the exchanges, all-reduces, the face bytes (held to
     exchange_bytes_model times each method's matvecs and V-cycles,
     krylov_work) and halo.staged, and each case's kernels (K1, K9 and
     K11, or K10; K2 and K8 under CG; K2 without a preconditioner) must
     show launches on every rank; the iterations must equal the one-rank
     run's; x must be within 100 rtol of the one-rank x. With one card
     the ranks share it over gloo, every face staged through pinned host
     buffers (walls printed, no speed figure); with two cards or more the
     same cases also run over NCCL, one rank a card (a group of more ranks
     than cards is skipped there). The kernels of the path are also held
     to their plain versions at the ranks' block shapes (DIST_BLOCKS) in
     phase 3, K11 in bf16 timed at the (2,2,1) block of 512^3.
     Path (n), order 6 and the FFT across ranks, in the same groups after
     path (m)'s cases (PENCIL_CASES; the four-rank group also takes the
     process grid (2,1,2)), each beside the parent's one-rank solve: over
     gloo on one card (2,2,1) 256^3 f32 order 6 by CG + GMG (4
     iterations), -ksp_type fft (the packed route) and FCG + -pc_type
     fft, order 2 by -ksp_type fft, (2,1,2) (16,16,18) f64 -ksp_type fft
     of both orders (the complex route), (3,1,1) 64^3 f64 order 6 by CG +
     GMG (the gather route); over NCCL, where there are four cards, the
     512^3 f32 cases instead of the 256^3 ones. Every case: the
     distributed compact Laplacian gathered against one rank's K15
     Laplacian of the same u (relative RMS within 50 eps, max|diff|
     printed), rank 0's all-to-alls and bytes of one Laplacian, one FFT
     solve and the counted window against pencil_bytes_model, K15
     launched on every rank, iterations equal to one rank's, residuals within
     1.01 rtol (-ksp_type fft: twice one rank's), warm walls beside one
     rank's. Phase 3 holds K15's Laplacian sweeps to their plain versions
     at the pencil block shapes (PENCIL_BLOCKS), bit for bit.
     The census (utils.census), each path (m) case: one MG-CG iteration's
     collectives (windows of 2 and 1 iterations, the difference) equal
     utils.scaling.mgcg_iteration_model on every rank, record for record,
     and the largest gather is the replicated tail's field; a case that is
     not MG-CG is held by the MG-CG solve of its grid, dtype and MG
     options. For 512^3 (2,2,1) MG-CG the census by level (block shape,
     exchanges, face messages, bytes, mean bytes a message, the exchanges
     whose messages are all under 64 KiB). With four cards over NCCL:
     the strong-scaling prediction (scaling.predict_efficiency, LINK_BW of
     the card) against the measured efficiency of that case, and the weak
     rung, (1024, 1024, 512) f32 MG-CG to rtol 1e-6 on (2,2,1) (512^3 a
     card; three warm solves; true residual <= 1.01 rtol; its census held
     to the model too), its predicted efficiency against one card's 512^3
     wall over the four-card wall; skipped, and saying so, with fewer
     cards.

The last two lines of standard output are a JSON object with one entry
per kernel mode (with its launches by rank in each case of paths (m) and
(n) that launched it, under dist_launches), then {"ok": true, "device":
{...}}.

    python3 chip_smoke.py
    python3 chip_smoke.py --dist-only   # device, build, native planner and
                                        # phase 7 alone: over NCCL on two
                                        # cards or more
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from poissbox_tpu_torch import checkpoint
from poissbox_tpu_torch.api import PoissonSolver
from poissbox_tpu_torch import native
from poissbox_tpu_torch.config import Options as _Options
from poissbox_tpu_torch.config import SolverOptions
from poissbox_tpu_torch.mesh import Grid3D
from poissbox_tpu_torch.ops import _build
from poissbox_tpu_torch.ops import compact
from poissbox_tpu_torch.ops import compact_pcr as cp
from poissbox_tpu_torch.ops import spectral_cuda
from poissbox_tpu_torch.ops import stencil_cuda as sc
from poissbox_tpu_torch.ops import transfer_cuda as tc
from poissbox_tpu_torch.ops import tridiag_cuda
from poissbox_tpu_torch.ops.coefficients import compact_grad_coeffs, compact_interp_coeffs
from poissbox_tpu_torch.ops.compact import make_compact_laplacian_operator
from poissbox_tpu_torch.ops.stencil import make_laplacian_operator
from poissbox_tpu_torch.ops.tridiag_cuda import CudaTridiagFactor
from poissbox_tpu_torch.parallel.decomp import (dof_distribution, owned_boxes,
                                                python_decompose_3d)
from poissbox_tpu_torch.parallel.pencil import block_of, pencil_ok, pencil_spec
from poissbox_tpu_torch.solvers import fft, ksp
from poissbox_tpu_torch.solvers import mg
from poissbox_tpu_torch.solvers.cg import cg
from poissbox_tpu_torch.solvers.gmres import clamp_restart
from poissbox_tpu_torch.solvers.refine import refine
from poissbox_tpu_torch.solvers.result import ConvergedReason
from poissbox_tpu_torch.utils import check_field, debugging, enable_nan_checks, profiling
from poissbox_tpu_torch.utils import census, scaling
from poissbox_tpu_torch.utils.census import (exchange_bytes_model, krylov_work,
                                             pencil_bytes_model)

BF16 = torch.bfloat16
DEVICE = "cuda"   # every field and solver of the script lives on the card
# every argv list this process parses, for the native options database's
# check (native_options_phase)
ARGVS: list = []


def Options(argv):
    """config.Options of `argv`, the list kept in ARGVS."""
    ARGVS.append(list(argv))
    return _Options(argv)

# fields: max|kernel - plain| <= FIELD_TOL * max|plain|; reductions:
# |kernel - plain| <= RED_TOL * |plain|. The kernels keep the plain
# versions' grouping and are built without FMA contraction, so the only
# difference is the order of summation in the reductions, and for bf16
# a tie at the store (one bf16 ulp, 2^-7 of the field's max at most).
FIELD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, BF16: 2.0 ** -7}
RED_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# banded-matrix transfers against the roll form, float32
MM_TOL = 1e-6
# the kernels whose fields must equal their plain versions bit for bit
# (KA's epilogues, K11's colour update, K15 on both of its kernels, K14,
# K13, K16 and K17 on their strip and streaming kernels, and the spectral
# symbol multiply)
BIT_EQUAL = ("stencil7.", "rbsor.general", "compact.", "tridiag.", "spectral.")

PALLAS = "poissbox_tpu/ops/stencil_pallas.py"
INPLACE = "poissbox_tpu/ops/stencil_inplace.py"
PCR = "poissbox_tpu/ops/compact_pcr.py"
TRI = "poissbox_tpu/ops/tridiag_pallas.py"
KERNELS = {   # launch counter -> (source, TPU kernel(s) it replaces)
    "stencil7.apply": ("stencil7.cu", f"{PALLAS}:348, {INPLACE}:389"),
    "stencil7.apply_dot": ("stencil7.cu", f"{PALLAS}:369, {PALLAS}:409, {INPLACE}:389"),
    "stencil7.pupd_dot": ("stencil7.cu", f"{PALLAS}:471, {PALLAS}:515, {INPLACE}:642"),
    "stencil7.residual": ("stencil7.cu", f"{PALLAS}:649"),
    "stencil7.jacobi": ("stencil7.cu", f"{PALLAS}:655, {INPLACE}:247"),
    "stencil7.residual.bf16": ("stencil7.cu", f"{PALLAS}:649"),
    "stencil7.jacobi.bf16": ("stencil7.cu", f"{PALLAS}:655, {INPLACE}:247"),
    "rbsor.general": ("rbsor.cu", f"{PALLAS}:663"),
    "rbsor.general.bf16": ("rbsor.cu", f"{PALLAS}:663"),
    "rbsor.zero": ("rbsor.cu", f"{PALLAS}:690"),
    "rbsor.zero.bf16": ("rbsor.cu", f"{PALLAS}:690"),
    "rbsor.sweep": ("rbsor.cu", f"{PALLAS}:848, {INPLACE}:275"),
    "rbsor.sweep.bf16": ("rbsor.cu", f"{PALLAS}:848, {INPLACE}:275"),
    "rbsor.dots": ("rbsor.cu", f"{PALLAS}:848, {INPLACE}:275"),
    "rbsor.zero_update": ("rbsor.cu", f"{PALLAS}:758, {INPLACE}:679"),
    "rbsor.zero_update.narrow": ("rbsor.cu", f"{PALLAS}:758, {INPLACE}:679"),
    "xfer.restrict": ("xfer.cu", f"{PALLAS}:971"),
    "xfer.restrict.bf16u": ("xfer.cu", f"{PALLAS}:971"),
    "xfer.prolong_add": ("xfer.cu", f"{PALLAS}:1044"),
    "xfer.prolong_add.bf16u": ("xfer.cu", f"{PALLAS}:1044"),
    "cgupd": ("cgupd.cu", f"{PALLAS}:596"),
    "compact.z": ("compact.cu", f"{PCR}:282"),
    "compact.y": ("compact.cu", f"{PCR}:282"),
    "compact.x": ("compact.cu", f"{PCR}:304, {PCR}:431"),
    "tridiag.thomas": ("tridiag.cu", f"{TRI}:293"),
    "tridiag.pcr": ("compact.cu", f"{TRI}:303"),
    "tridiag.babe": ("tridiag.cu", f"{TRI}:330"),
    "tridiag.compact": ("tridiag.cu", f"{TRI}:381"),
    "tridiag.dual": ("tridiag.cu", f"{TRI}:459"),
    "tridiag.chain": ("tridiag.cu", f"{TRI}:467"),
    "tridiag.sum": ("tridiag.cu", f"{TRI}:475"),
    "tridiag.thomas.long": ("tridiag.cu", f"{TRI}:293"),
    "tridiag.babe.long": ("tridiag.cu", f"{TRI}:330"),
    "tridiag.compact.long": ("tridiag.cu", f"{TRI}:381"),
    "tridiag.dual.long": ("tridiag.cu", f"{TRI}:459"),
    "tridiag.chain.long": ("tridiag.cu", f"{TRI}:467"),
    "tridiag.sum.long": ("tridiag.cu", f"{TRI}:475"),
    "spectral.compact": ("spectral.cu", "none (the JAX package builds the symbol "
                         "with jnp: poissbox_tpu/solvers/fft.py:465)"),
    "spectral.sum": ("spectral.cu", "none (the JAX package builds the symbol with "
                     "jnp: poissbox_tpu/solvers/fft.py:34)"),
}
# K13's, K16's and K17's modes, their streaming kernels' counters beside
STRIP_KEYS = ("tridiag.thomas", "tridiag.babe", "tridiag.compact", "tridiag.dual",
              "tridiag.chain", "tridiag.sum")
# kernels that no path launches, and why (the idle check skips them; each
# is still held to its plain version and timed)
OFF_PATH = {f"{k}.long": "the streaming kernel takes lines too long for two strip "
                         "workers a block (LONG_CASES); no counted path has such "
                         "lines (lapl_pairs' 512^3 f64 Laplacian gives sum's two "
                         "columns a lane to it)"
            for k in STRIP_KEYS}
# K17's modes: field passes at the floor (inputs read once, outputs
# written once) and operations a point (7 for the RHS taps, 2 forward, 3
# back, 2 correction per operator; the sum's tap sum and final add)
K17_MODES = {"compact": (2, 14), "dual": (3, 28), "chain": (2, 28), "sum": (4, 30)}
# the modes of the 512^3 path, timed at 512^3 (the rest at 256^3)
AT_512 = ("rbsor.zero.bf16", "rbsor.sweep.bf16", "rbsor.zero_update.narrow",
          "xfer.restrict.bf16u", "xfer.prolong_add.bf16u",
          "stencil7.residual.bf16", "stencil7.jacobi.bf16")
# float32 sweep modes that paths (b) and (g) launch at 512^3, where the
# sweep kernel's grid takes its largest x chunk: checked there, timed at
# 256^3
CHECK_512 = ("rbsor.zero", "rbsor.sweep", "rbsor.dots")
# the card's peaks (H100 SXM data sheet): HBM bytes/s, f32 operations/s
# outside the tensor cores (the kernels' arithmetic is f32 or f64; every
# timed case is f32 or bf16 stored, f32 computed)
HBM_BPS = 3.35e12
F32_OPS = 67e12
# the bench's periodic tridiagonal system (alpha, 1, alpha), alpha the
# compact first derivative's (bench.py:198-200)
ALPHA_TRI = 9.0 / 62.0
W = 1.0        # SOR weight of the solver of record
WJ = 8.0 / 9.0  # damped-Jacobi weight of the Jacobi smoother
ALPHA = 0.37   # CG step for the fused-update checks
BETA, ZSHIFT = 0.61, 0.013   # CG's (beta, zshift) for the K12 checks


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def mode_calls(deltas, narrow: bool):
    """(name, inputs, operations per point, kernel call, plain call) per
    mode; with `narrow` (float32 cases) the bf16 modes too. A timed name
    is the counter's own; a sweep mode's time is the wrapper's, one launch
    (the whole TPU kernel: K3, K4, K5). The
    inputs (each read once) and the outputs (each written once) give the
    mode's byte bound; the operations, its arithmetic bound."""
    d = deltas
    calls = [
        ("stencil7.apply", ["u"], 10, lambda f: sc.apply_laplacian_cuda(f["u"], d),
         lambda f: sc.apply_laplacian_plain(f["u"], d)),
        ("stencil7.apply_dot", ["u"], 12,
         lambda f: sc.apply_laplacian_dot_cuda(f["u"], d),
         lambda f: sc.apply_laplacian_dot_plain(f["u"], d)),
        # K12: p' (3 operations a point), the star (10), the dot (2)
        ("stencil7.pupd_dot", ["u", "p"], 15,
         lambda f: sc.pupdate_lapl_dot_cuda(f["u"], f["p"], f["beta"], f["zs"], d),
         lambda f: sc.pupdate_lapl_dot_plain(f["u"], f["p"], f["beta"], f["zs"], d)),
        ("stencil7.residual", ["u", "b"], 11,
         lambda f: sc.residual_cuda(f["u"], f["b"], d),
         lambda f: sc.residual_plain(f["u"], f["b"], d)),
        ("stencil7.jacobi", ["u", "b"], 13,
         lambda f: sc.jacobi_sweep_cuda(f["u"], f["b"], d, WJ),
         lambda f: sc.jacobi_sweep_plain(f["u"], f["b"], d, WJ)),
        ("xfer.restrict", ["u", "b"], 13,
         lambda f: tc.residual_xrestrict_cuda(f["u"], f["b"], d),
         lambda f: tc.residual_xrestrict_plain(f["u"], f["b"], d)),
        ("xfer.prolong_add", ["u", "e"], 3, lambda f: tc.xprolong_add_cuda(f["u"], f["e"]),
         lambda f: tc.xprolong_add_plain(f["u"], f["e"])),
        ("cgupd", ["u", "p", "r", "ap"], 7,
         lambda f: sc.cg_fused_update_cuda(f["alpha"], f["u"], f["p"], f["r"], f["ap"]),
         lambda f: sc.cg_fused_update_plain(f["alpha"], f["u"], f["p"], f["r"],
                                            f["ap"])),
        ("rbsor.dots/multisweep3", ["u", "b"], 45,
         lambda f: sc.sor_rb_multisweep_cuda(f["u"], f["b"], d, W, 3, dots=True),
         lambda f: sc.sor_rb_multisweep_plain(f["u"], f["b"], d, W, 3, dots=True)),
    ]
    for colour in (0, 1):
        # K11: one colour update (half the points updated, all copied)
        calls.append((f"rbsor.general/colour={colour}", ["u", "b"], 7,
                      lambda f, c=colour: sc.sor_sweep_cuda(f["u"], f["b"], d, W, c),
                      lambda f, c=colour: sc.sor_sweep_plain(f["u"], f["b"], d, W, c)))
    for rev in (False, True):
        calls += [
            (f"rbsor.zero/rev={rev}", ["b"], 13,
             lambda f, rev=rev: sc.sor_rb_zero_sweep_cuda(f["b"], d, W, rev),
             lambda f, rev=rev: sc.sor_rb_zero_sweep_plain(f["b"], d, W, rev)),
            (f"rbsor.zero_update/rev={rev}", ["r", "ap"], 17,
             lambda f, rev=rev: sc.sor_rb_zero_update_cuda(
                 f["r"], f["ap"], f["alpha"], d, W, rev),
             lambda f, rev=rev: sc.sor_rb_zero_update_plain(
                 f["r"], f["ap"], f["alpha"], d, W, rev)),
            (f"rbsor.sweep/rev={rev}", ["u", "b"], 13,
             lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u"], f["b"], d, W, rev),
             lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u"], f["b"], d, W, rev)),
            (f"rbsor.dots/rev={rev}", ["u", "b"], 16,
             lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u"], f["b"], d, W, rev,
                                                     dots=True),
             lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u"], f["b"], d, W, rev,
                                                      dots=True)),
        ]
        if narrow:
            calls += [
                (f"rbsor.zero.bf16/rev={rev}", ["b16"], 13,
                 lambda f, rev=rev: sc.sor_rb_zero_sweep_cuda(f["b16"], d, W, rev),
                 lambda f, rev=rev: sc.sor_rb_zero_sweep_plain(f["b16"], d, W, rev)),
                (f"rbsor.sweep.bf16/rev={rev}", ["u16", "b16"], 13,
                 lambda f, rev=rev: sc.sor_rb_sweep_cuda(f["u16"], f["b16"], d, W, rev),
                 lambda f, rev=rev: sc.sor_rb_sweep_plain(f["u16"], f["b16"], d, W,
                                                          rev)),
                (f"rbsor.zero_update.narrow/rev={rev}", ["r", "ap"], 17,
                 lambda f, rev=rev: sc.sor_rb_zero_update_cuda(
                     f["r"], f["ap"], f["alpha"], d, W, rev, out_dtype=BF16),
                 lambda f, rev=rev: sc.sor_rb_zero_update_plain(
                     f["r"], f["ap"], f["alpha"], d, W, rev, out_dtype=BF16)),
            ]
    if narrow:
        calls += [
            ("xfer.restrict.bf16u", ["u16", "b"], 13,
             lambda f: tc.residual_xrestrict_cuda(f["u16"], f["b"], d),
             lambda f: tc.residual_xrestrict_plain(f["u16"], f["b"], d)),
            ("xfer.prolong_add.bf16u", ["u16", "e"], 3,
             lambda f: tc.xprolong_add_cuda(f["u16"], f["e"]),
             lambda f: tc.xprolong_add_plain(f["u16"], f["e"])),
            ("stencil7.residual.bf16", ["u16", "b16"], 11,
             lambda f: sc.residual_cuda(f["u16"], f["b16"], d),
             lambda f: sc.residual_plain(f["u16"], f["b16"], d)),
            ("stencil7.jacobi.bf16", ["u16", "b16"], 13,
             lambda f: sc.jacobi_sweep_cuda(f["u16"], f["b16"], d, WJ),
             lambda f: sc.jacobi_sweep_plain(f["u16"], f["b16"], d, WJ)),
        ]
    return calls


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the bytes over the HBM rate or
    the operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def share(bd: dict, ms: float) -> str:
    """The kernel's share of its floor: bound over measured time."""
    return f"{100 * bd['bound_ms'] / ms:.1f} % of its floor"


def out_bytes(out) -> int:
    """Bytes written: every field output (reductions are a few scalars)."""
    return sum(t.nbytes for t in as_tuple(out) if t.dim() > 0)


def conv_star(deltas, dtype):
    """One library call for K1: Conv3d with the 7-point star as its
    weights, circular padding (the periodic boundary), no bias."""
    ivx, ivy, ivz = (1.0 / float(dd) ** 2 for dd in deltas)
    w = torch.zeros(3, 3, 3, dtype=torch.float64)
    w[0, 1, 1] = w[2, 1, 1] = ivx
    w[1, 0, 1] = w[1, 2, 1] = ivy
    w[1, 1, 0] = w[1, 1, 2] = ivz
    w[1, 1, 1] = -2.0 * (ivx + ivy + ivz)
    conv = torch.nn.Conv3d(1, 1, 3, padding=1, padding_mode="circular",
                           bias=False).to(device=DEVICE, dtype=dtype)
    conv.requires_grad_(False)
    conv.weight.copy_(w.view(1, 1, 3, 3, 3))
    return lambda u: conv(u[None, None])[0, 0]


def fields(shape, dtype, seed):
    """Seeded inputs on the card; the offset keeps the sums well away from
    zero, so a relative tolerance on them is meaningful."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda s=shape: torch.rand(s, generator=g, dtype=dtype, device=DEVICE) * 2 - 0.75
    f = {"u": mk(), "b": mk(), "r": mk(), "ap": mk(), "p": mk(),
         "e": mk((shape[0] // 2,) + tuple(shape[1:])),
         "alpha": torch.tensor(ALPHA, dtype=dtype, device=DEVICE),
         "beta": torch.tensor(BETA, dtype=dtype, device=DEVICE),
         "zs": torch.tensor(ZSHIFT, dtype=dtype, device=DEVICE)}
    if dtype == torch.float32:
        f["u16"], f["b16"] = f["u"].to(BF16), f["b"].to(BF16)
    return f


def compare(name, got, ref) -> float:
    """Max abs field error; raises when a field or reduction is off."""
    worst = 0.0
    for g, r in zip(as_tuple(got), as_tuple(ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{r.dtype}{tuple(r.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite output")
        err = float((g.double() - r.double()).abs().max())
        if r.dim() == 0:
            rel = err / abs(float(r))
            if not rel <= RED_TOL[r.dtype]:
                raise AssertionError(f"{name}: reduction {float(g)!r} vs "
                                     f"{float(r)!r}, relative {rel:.3e}")
        else:
            scale = float(r.double().abs().max())
            if not err <= FIELD_TOL[r.dtype] * scale:
                raise AssertionError(f"{name}: {r.dtype} field max|diff| "
                                     f"{err:.3e} > {FIELD_TOL[r.dtype]:g} * "
                                     f"{scale:.3e}")
            worst = max(worst, err)
    return worst


def median_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device time of one call, from CUDA events around each of
    `reps` back-to-back calls after `warm` warm-up calls."""
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


# KB's and K6's cases beyond the path shapes: a ragged (y, z) tile in f64
# and f32 (the bf16 modes too), the 4^3 and 8^3 levels, where the 2-cell
# halo wraps past the whole axis, and odd (y, z) extents, cubic cells and
# not, where two z-adjacent cells across the wrap share a colour
SMALL_CASES = [((40, 36, 52), (1.0, 1.0, 1.0), torch.float64),
               ((40, 36, 52), (1.0, 1.0, 1.0), torch.float32),
               ((4, 4, 4), (1.0, 1.0, 1.0), torch.float64),
               ((8, 8, 8), (1.0, 1.0, 1.0), torch.float64),
               ((6, 5, 7), (6.0, 5.0, 7.0), torch.float64),
               ((6, 5, 7), (1.0, 1.0, 1.0), torch.float32)]


def check_kernels() -> dict:
    """Phase 3: every mode against its plain version; returns, per launch
    counter, the max abs error over the cases and, at the mode's path
    shape (512^3 for AT_512, 256^3 otherwise), its time, the plain
    version's, its bound and, for K1, the library call's."""
    cases = [((64, 64, 64), (1.0, 1.0, 1.0), torch.float64),
             *SMALL_CASES,
             ((64, 32, 48), (1.0, 0.75, 1.5), torch.float64),
             ((64, 32, 48), (1.0, 0.75, 1.5), torch.float32),
             ((48, 40, 96), (1.0, 1.0, 1.0), torch.float32),
             ((256, 256, 256), (1.0, 1.0, 1.0), torch.float32),
             ((512, 512, 512), (1.0, 1.0, 1.0), torch.float32)]
    stats = {k: {"max_abs_err": 0.0, "library_ms": None} for k in KERNELS}
    for shape, length, dtype in cases:
        gz, gy, gx, _ = sc.ka_blocks(shape)
        if _build.load().poissbox_num_blocks(*shape) != gz * gy * gx:
            raise AssertionError(f"KA's grid at {shape}: the library's block count "
                                 f"differs from ka_blocks' {gz * gy * gx}")
        deltas = Grid3D(shape, length, DEVICE).deltas
        f = fields(shape, dtype, seed=sum(shape))
        n = shape[0] if len(set(shape)) == 1 else 0
        for name, ins, ops, kern, plain in mode_calls(deltas, dtype == torch.float32):
            key = name.split("/")[0]
            if n == 512 and key not in AT_512 + CHECK_512 and not key.startswith(
                    ("xfer.", "cgupd", "stencil7.jacobi", "stencil7.apply_dot",
                     "stencil7.pupd_dot")):
                continue      # at 512^3, only the modes of the 512^3 paths
            if shape == (48, 40, 96) and not key.startswith("stencil7."):
                continue      # the compact cases' shape: KA's epilogues, bf16 too
            if (shape, length, dtype) in SMALL_CASES and not key.startswith(
                    ("rbsor.", "xfer.restrict", "stencil7.")):
                continue      # KA's, KB's and K6's ragged and wrapped-halo cases
            got = kern(f)
            err = compare(f"{name} {shape} {dtype}", got, plain(f))
            torch.cuda.synchronize()
            if key.startswith(BIT_EQUAL) and err != 0.0:
                raise AssertionError(f"{name} {shape} {dtype}: field max|diff| {err:.3e}, "
                                     "not bit-equal")
            st = stats[key]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            # a sweep mode's row takes the rev=False sweep, K11's the
            # colour-0 update
            record = "/" not in name or name.endswith(("rev=False", "colour=0"))
            timed = record and not (n == 512 and key in CHECK_512) and key not in K11_KEYS
            if n in (256, 512) and timed:
                ms, plain_ms = median_ms(lambda: kern(f)), median_ms(lambda: plain(f))
                bd = bound(sum(f[k].nbytes for k in ins) + out_bytes(got),
                           ops * f["u"].numel())
                print(f"  {name:32s} {n}^3 f32: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                      f"({bd['bound_by']}), {share(bd, ms)}, max|diff| {err:.3e}")
                if record and n == (512 if key in AT_512 else 256):
                    st.update(ms=ms, plain_ms=plain_ms, **bd)
            del got
        if n == 256:
            lib = conv_star(deltas, dtype)
            with torch.no_grad():
                y = lib(f["u"])
                ref = sc.apply_laplacian_plain(f["u"], deltas)
                rel = float((y - ref).abs().max()) / float(ref.abs().max())
                if not rel <= 1e-5:
                    raise AssertionError(f"Conv3d star: relative {rel:.3e} from K1's plain")
                lib_ms = median_ms(lambda: lib(f["u"]))
            stats["stencil7.apply"]["library_ms"] = lib_ms
            print(f"  stencil7.apply library (Conv3d, circular, TF32 off) 256^3 "
                  f"f32: {lib_ms:.4f} ms, relative diff {rel:.2e}")
        del f
        torch.cuda.empty_cache()
        print(f"  all modes agree at {shape} {dtype}, lengths {length}", flush=True)
    return stats


SPECTRAL_CASES = [((512, 512, 512), (1.0, 1.0, 1.0), torch.float32),
                  ((64, 64, 64), (1.0, 1.0, 1.0), torch.float64),
                  ((48, 40, 97), (1.0, 0.75, 1.5), torch.float32),
                  ((48, 40, 97), (1.0, 0.75, 1.5), torch.float64),
                  ((9, 7, 13), (1.0, 0.75, 1.5), torch.float32)]
# operations a mode: S (compact 5 products and 2 sums; 7-point 2 sums),
# the test, the reciprocal and the two scalings
SPECTRAL_OPS = {"compact": 11, "sum": 6}


def check_spectral(stats: dict) -> None:
    """Phase 3b: the symbol multiply of both forms bit for bit against its
    plain version on the card (SPECTRAL_CASES, the tables from
    fft.symbol_tables), on cuFFT's layout of the half spectrum (the half
    axis outermost) and on the C-order one (rows of nz/2 + 1; (9, 7, 13)
    leaves an odd count of complex64 values), then its time at 512^3 f32
    beside the plain version's and its floor."""
    for shape, length, dtype in SPECTRAL_CASES:
        deltas = Grid3D(shape, length, DEVICE).deltas
        g = torch.Generator(device=DEVICE).manual_seed(sum(shape))
        b = torch.rand(shape, generator=g, dtype=dtype, device=DEVICE) * 2 - 1
        xhat = torch.fft.rfftn(b)
        del b
        for form in spectral_cuda.FORMS:
            key = f"spectral.{form}"
            tables, peak, rel = fft.symbol_tables(shape, deltas, dtype, DEVICE, form)
            for layout in (xhat, xhat.contiguous()):
                got = spectral_cuda.symbol_scale(layout.clone(), tables, peak, rel, form)
                ref = spectral_cuda.symbol_scale_plain(layout.clone(), tables, peak, rel,
                                                       form)
                err = compare(f"{key} {shape} {dtype}", torch.view_as_real(got),
                              torch.view_as_real(ref))
                if err != 0.0 or not torch.equal(got == 0, ref == 0):
                    raise AssertionError(
                        f"{key} {shape} {dtype}, axes in memory "
                        f"{spectral_cuda.memory_order(layout)}: max|diff| {err:.3e}, "
                        "not bit-equal")
                zeros = int((ref == 0).sum())
                del got, ref
            st = stats[key]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if shape == (512, 512, 512):
                buf = xhat.clone()
                ms = median_ms(lambda: spectral_cuda.symbol_scale(buf, tables, peak, rel, form))
                plain_ms = median_ms(lambda: spectral_cuda.symbol_scale_plain(
                    buf, tables, peak, rel, form))
                del buf
                bd = bound(2 * xhat.nbytes, SPECTRAL_OPS[form] * xhat.numel())
                st.update(ms=ms, plain_ms=plain_ms, **bd)
                print(f"  {key:32s} 512^3 f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                      f"ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), "
                      f"{share(bd, ms)}")
            print(f"  {key} bit-equal at {shape} {dtype}, axes in memory "
                  f"{spectral_cuda.memory_order(xhat)} and C order ({zeros} modes "
                  "dropped)", flush=True)
        del xhat
        torch.cuda.empty_cache()


def check_contractions() -> None:
    """Phase 4: restrict_mm/prolong_mm equal the roll transfers in f32
    with torch's TF32 switch on (the contractions set full float32
    themselves), and their times against the roll form's."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g = torch.Generator(device=DEVICE).manual_seed(7)
        for n, axes in ((256, (0, 1, 2)), (256, (1, 2)), (512, (1, 2))):
            fine = (n // 2, n, n) if axes == (1, 2) else (n,) * 3
            coarse = tuple(s // 2 if a in axes else s for a, s in enumerate(fine))
            f = torch.rand(fine, generator=g, device=DEVICE) * 2 - 1
            c = torch.rand(coarse, generator=g, device=DEVICE) * 2 - 1
            for what, mm, roll, x in (
                    ("restrict", mg.restrict_mm, mg.restrict, f),
                    ("prolong", mg.prolong_mm, mg.prolong, c)):
                a, b = mm(x, axes=axes), roll(x, axes=axes)
                rel = float((a - b).abs().max()) / float(b.abs().max())
                if not rel <= MM_TOL:
                    raise AssertionError(f"{what}_mm {n}^3 axes {axes}: relative "
                                         f"{rel:.3e} from the roll form")
                t_mm = median_ms(lambda: mm(x, axes=axes), reps=9)
                t_roll = median_ms(lambda: roll(x, axes=axes), reps=9)
                print(f"  {what} axes {axes} on {tuple(x.shape)}: matmul "
                      f"{t_mm:.4f} ms, roll {t_roll:.4f} ms, relative diff "
                      f"{rel:.2e}", flush=True)
            del f, c
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# K15's and K17's cases: every line length and dtype the paths give them
# (96^3 f32 is path (l)'s, 512^3 f64 the Laplacian of lapl_pairs), mixed
# register and tile lines ((48, 40, 96)) and an odd split for K16
COMPACT_CASES = [((64, 64, 64), torch.float64), ((48, 40, 96), torch.float32),
                 ((48, 40, 96), torch.float64), ((33, 20, 24), torch.float64),
                 ((96, 96, 96), torch.float32), ((256, 256, 256), torch.float32),
                 ((512, 512, 512), torch.float32), ((512, 512, 512), torch.float64)]
LAPL_KEYS = ("compact.z", "compact.y", "compact.x")   # lapl_sweeps' order
# the sizes at which the paths launch K16 and K17 (path (f): 512^3 f32,
# 64^3 f64; path (l): 64^3 f64, 256^3 and 96^3 f32; lapl_pairs: 512^3 f32
# and f64), each timed with its share of the floor
STRIP_TIMED = (((64, 64, 64), torch.float64), ((96, 96, 96), torch.float32),
               ((256, 256, 256), torch.float32), ((512, 512, 512), torch.float32),
               ((512, 512, 512), torch.float64))
# lines too long for two strip workers a block: K16's and K17's streaming
# kernels (the .long counters)
LONG_CASES = [((2048, 16, 16), torch.float32), ((1024, 16, 16), torch.float64)]


def program_ops(program) -> int:
    """Operations per point of one K15 sweep: 7 for the RHS taps (1 for
    the scale of a plain solve), 3 a PCR step, 1 for the final scale (3
    for the exact pairing), 1 for each summed term."""
    total = 0
    for out in program:
        total += len(out) - 1
        for _, specs in out:
            for _, b, _, _, (fs, _, aF) in specs:
                total += (1 if b is None else 7) + 3 * len(fs) + (1 if aF == 0.0 else 3)
    return total


def tridiag_system(n: int, dtype):
    """(a, b, c) of the bench's periodic (alpha, 1, alpha) system."""
    a = torch.full((n,), ALPHA_TRI, dtype=dtype)
    return a, torch.ones(n, dtype=dtype), a.clone()


def general_system(n: int, dtype, seed: int):
    """A diagonally dominant system with variable coefficients (numpy
    seed `seed`): a, c uniform(-0.4, 0.4), b uniform(1, 2)."""
    g = np.random.default_rng(seed)
    a, c = g.uniform(-0.4, 0.4, n), g.uniform(-0.4, 0.4, n)
    return tuple(torch.as_tensor(v, dtype=dtype) for v in (a, g.uniform(1.0, 2.0, n), c))


def dense_circulant(n: int, dtype) -> torch.Tensor:
    """The same system as a dense n x n matrix on the card."""
    idx = torch.arange(n)
    m = torch.eye(n, dtype=torch.float64)
    m[idx, (idx + 1) % n] = ALPHA_TRI
    m[idx, (idx - 1) % n] = ALPHA_TRI
    return m.to(device=DEVICE, dtype=dtype)


def compact_calls(f, F, d):
    """(name, counters, kernel call, plain call) of K15's programs, the
    K13/K14/K16 solves and K17's modes on one field."""
    rt = cp._dtype_rtol(f.dtype)
    calls = [
        ("lapl", LAPL_KEYS, lambda: cp.lapl(f, d), lambda: cp.lapl(f, d, plain=True)),
        ("grad", LAPL_KEYS, lambda: cp.grad(f, d), lambda: cp.grad(f, d, plain=True)),
        ("div", LAPL_KEYS, lambda: cp.div(F, d), lambda: cp.div(F, d, plain=True)),
        ("interp-", LAPL_KEYS, lambda: cp.interp(f, -1),
         lambda: cp.interp(f, -1, plain=True)),
        ("interp+", LAPL_KEYS, lambda: cp.interp(f, +1),
         lambda: cp.interp(f, +1, plain=True)),
    ]
    for axis, key in ((2, "compact.z"), (1, "compact.y"), (0, "compact.x")):
        spec = cp.grad_spec(d[axis], +1, f.shape[axis], rt)
        calls.append((f"op_1d/axis={axis}", (key,),
                      lambda s=spec, a=axis: cp.op_1d(f, s, a),
                      lambda s=spec, a=axis: cp.op_1d(f, s, a, plain=True)))
    # K13 also on a non-periodic system and on variable coefficients,
    # periodic and not: the strip kernel's store skips the correction
    # where corr[1] == 0
    for alg, axis, per, var in (("thomas", 0, True, False), ("thomas", 0, False, False),
                                ("thomas", 0, True, True), ("thomas", 0, False, True),
                                ("pcr", 0, True, False), ("pcr", 2, True, False),
                                ("babe", 0, True, False), ("babe", 2, False, False)):
        n = f.shape[axis]
        sysm = general_system(n, f.dtype, n + 7) if var else tridiag_system(n, f.dtype)
        fac = CudaTridiagFactor(*sysm, periodic=per, algorithm=alg)
        calls.append((f"tridiag.{alg}/axis={axis}/periodic={per}"
                      + ("/variable" if var else ""), (f"tridiag.{alg}",),
                      lambda fac=fac, a=axis: fac.solve(f, a),
                      lambda fac=fac, a=axis: fac.solve(f, a, plain=True)))
    for mode, call in k17_calls(f, d).items():
        calls.append((f"tridiag.{mode}", (f"tridiag.{mode}",), call,
                      lambda call=call: call(plain=True)))
    return calls


def k17_calls(f, d) -> dict:
    """K17's four modes along axis 0 of f with the compact Laplacian's
    operators (their factors the "pallas" path's), as the pipeline calls
    them: mode -> call(plain=False)."""
    n, dt = f.shape[0], f.dtype
    oi, oip = (compact._op(compact_interp_coeffs(), st) for st in (-1, +1))
    og, ogp = (compact._op(compact_grad_coeffs(d[0]), st) for st in (-1, +1))
    fac = lambda op: compact._pfac(n, op[0], dt)
    g = torch.Generator(device=DEVICE).manual_seed(n + 5)
    fb, f3 = (torch.rand(f.shape, generator=g, dtype=dt, device=DEVICE) * 2 - 1
              for _ in range(2))
    return {
        "compact": lambda plain=False: fac(og).solve_compact(f, *og[1], plain=plain),
        "dual": lambda plain=False: tridiag_cuda.compact_dual(
            f, fac(oi), oi[1], fac(og), og[1], plain=plain),
        "chain": lambda plain=False: tridiag_cuda.compact_chain(
            f, fac(og), og[1], fac(ogp), ogp[1], plain=plain),
        "sum": lambda plain=False: tridiag_cuda.compact_sum(
            f, fb, f3, fac(oip), oip[1], fac(ogp), ogp[1], plain=plain),
    }


def check_compact(stats: dict) -> None:
    """Phase 5: K15's programs, K13/K14/K16 and K17's modes against their
    plain versions at every case, with the K15 kernels each case took
    (checked against compact_pcr.route) and, where a line takes the tile
    kernel, every lane width it is built for held bit-equal; at 256^3 and
    512^3 the times of each Laplacian sweep and the whole Laplacian and, in
    f32, those of the three solves (kernel, plain, lu_solve on the dense
    factor) and K17's modes, with their bounds. The JSON entries take the
    512^3 f32 times (the JAX package's bench size for compact_lapl and
    tridiag)."""
    for shape, dtype in COMPACT_CASES:
        g = torch.Generator(device=DEVICE).manual_seed(sum(shape) + 3)
        f = torch.rand(shape, generator=g, dtype=dtype, device=DEVICE) * 2 - 1
        F = torch.rand(shape + (3,), generator=g, dtype=dtype, device=DEVICE) * 2 - 1
        d = tuple(1.0 / n for n in shape)
        routes = {cp.route(n) for n in shape}
        for k in cp.ROUTE_LAUNCHES:
            cp.ROUTE_LAUNCHES[k] = 0
        for name, keys, kern, plain in compact_calls(f, F, d):
            err = compare(f"{name} {shape} {dtype}", kern(), plain())
            torch.cuda.synchronize()
            if keys[0].startswith(BIT_EQUAL) and err != 0.0:
                raise AssertionError(f"{name} {shape} {dtype}: field max|diff| {err:.3e}, "
                                     "not bit-equal")
            for key in keys:
                stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
        took = {k for k, v in cp.ROUTE_LAUNCHES.items() if v}
        if took != routes:
            raise AssertionError(f"K15 at {shape}: launched {took}, the extents take {routes}")
        if "tile" in routes:
            tile_widths(f, d)
        print(f"  compact and tridiagonal kernels agree at {shape} {dtype}; K15 "
              f"launches by kernel {dict(cp.ROUTE_LAUNCHES)} (lines "
              + ", ".join(f"{n}: {cp.route(n)}" for n in shape) + ")", flush=True)
        del F
        if shape[0] in (256, 512):
            time_compact(stats, f, d)
        if (shape, dtype) in STRIP_TIMED:
            time_strips(stats, f, d)
        del f
        torch.cuda.empty_cache()


def tile_widths(f, d) -> None:
    """The Laplacian with each lane width the tile kernel is built for on
    its sweeps (the register kernel's take none), bit-equal to the default
    one (tile_width picks the widest that lets two blocks share an SM)."""
    ref = cp.lapl(f, d)
    for w in cp.WIDTHS:
        out = [f]
        for program, axis in cp.lapl_sweeps(f.shape, d, f.dtype):
            tiled = cp.route(f.shape[axis]) == "tile"
            out = cp.sweep(program, out, axis, width=w if tiled else None)
        if not torch.equal(out[0], ref):
            raise AssertionError(f"compact lapl {tuple(f.shape)}: width {w} differs")


def time_compact(stats: dict, f, d) -> None:
    n = f.shape[0]
    f32 = f.dtype == torch.float32
    tag = f"{n}^3 {str(f.dtype).replace('torch.', '')}"
    record = n == 512 and f32
    fields = [f]
    for (program, axis), key in zip(cp.lapl_sweeps(f.shape, d, f.dtype), LAPL_KEYS):
        ins = fields
        outs = cp.sweep(program, ins, axis)
        ms = median_ms(lambda: cp.sweep(program, ins, axis))
        plain_ms = median_ms(lambda: cp.sweep_plain(program, ins, axis), reps=5)
        bd = bound((len(ins) + len(outs)) * f.nbytes, program_ops(program) * f.numel())
        print(f"  {key} (lapl sweep, {len(ins)}r {len(outs)}w, {cp.route(n)} kernel) {tag}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}), {share(bd, ms)}", flush=True)
        if record:
            stats[key].update(ms=ms, plain_ms=plain_ms, **bd)
        fields = outs
    del fields, outs, ins
    ms = median_ms(lambda: cp.lapl(f, d))
    floor = 10 * f.nbytes / HBM_BPS * 1e3
    if not f32:
        print(f"  compact lapl {tag}: kernels {ms:.4f} ms, bound (10 passes) {floor:.4f} ms, "
              f"{100 * floor / ms:.1f} % of it", flush=True)
        return
    plain_ms = median_ms(lambda: cp.lapl(f, d, plain=True), reps=5)
    pscan_ms = median_ms(lambda: make_compact_laplacian_operator(
        Grid3D(f.shape, device=DEVICE), method="pscan").apply(f), reps=3, warm=1)
    print(f"  compact lapl {tag}: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"pscan path {pscan_ms:.4f} ms, bound (10 passes) {floor:.4f} ms, "
          f"{100 * floor / ms:.1f} % of it", flush=True)
    B = f.reshape(n, -1)
    lu, piv = torch.linalg.lu_factor(dense_circulant(n, f.dtype))
    lib = lambda: torch.linalg.lu_solve(lu, piv, B)
    lib_ms = median_ms(lib)
    for alg in ("thomas", "pcr", "babe"):
        fac = CudaTridiagFactor(*tridiag_system(n, f.dtype), periodic=True,
                                algorithm=alg)
        x = fac.solve(f, 0)
        rel = float((lib().reshape(f.shape) - x).abs().max()) / float(x.abs().max())
        if not rel <= FIELD_TOL[f.dtype] * 10:
            raise AssertionError(f"lu_solve vs tridiag.{alg}: relative {rel:.3e}")
        ms = median_ms(lambda: fac.solve(f, 0))
        plain_ms = median_ms(lambda: fac.solve(f, 0, plain=True))
        ops = 7 if alg != "pcr" else program_ops((((0, (fac.pcr_spec,)),),))
        bd = bound(2 * f.nbytes, ops * f.numel())
        print(f"  tridiag.{alg} {n}^3 f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"lu_solve {lib_ms:.4f} ms (relative diff {rel:.2e}), bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})", flush=True)
        if record:
            stats[f"tridiag.{alg}"].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                           **bd)
        del x
    del lu, piv, B


def strip_calls(f, d) -> dict:
    """K13's and K16's periodic solves and K17's modes (k17_calls) along
    axis 0 of f: counter -> call(plain=False)."""
    calls = {}
    for alg in ("thomas", "babe"):
        fac = CudaTridiagFactor(*tridiag_system(f.shape[0], f.dtype), periodic=True,
                                algorithm=alg)
        calls[f"tridiag.{alg}"] = lambda plain=False, fac=fac: fac.solve(f, 0, plain=plain)
    calls.update({f"tridiag.{mode}": call for mode, call in k17_calls(f, d).items()})
    return calls


def strip_floor(key, f) -> dict:
    """K13's, K16's or K17's bound on f: its field passes and operations a
    point."""
    passes, ops = K17_MODES.get(key.split(".")[1], (2, 7))
    return bound(passes * f.nbytes, ops * f.numel())


def time_strips(stats: dict, f, d) -> None:
    """K13, K16 and K17's modes at one of their path sizes: kernel time,
    the strip lanes the route takes, bound and share of it; at 512^3 f32
    also the plain versions' times, and the JSON entries."""
    n, Q = f.shape[0], f.numel() // f.shape[0]
    tag = f"{n}^3 {str(f.dtype).replace('torch.', '')}"
    record = n == 512 and f.dtype == torch.float32
    for key, call in strip_calls(f, d).items():
        ms = median_ms(call)
        bd = strip_floor(key, f)
        mode = key.split(".")[1]
        lanes = tridiag_cuda.strip_lanes(mode, n, Q, f.dtype, f.device)
        route = f"{lanes}-lane strips" if lanes else "streaming kernel"
        line = (f"  {key} {tag}: kernel {ms:.4f} ms ({route}), bound "
                f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}), {share(bd, ms)}")
        if record:
            plain_ms = median_ms(lambda: call(plain=True), reps=3, warm=1)
            stats[key].update(ms=ms, plain_ms=plain_ms, **bd)
            line += f"; plain {plain_ms:.4f} ms"
        print(line, flush=True)


# the strip kernels' variants: (lanes, stagger), and lanes 0 for the
# streaming kernel (the design before the strips)
VARIANTS = ((32, 0), (32, 1), (16, 0), (16, 1), (0, -1))


def variant_name(lanes: int, stagger: int) -> str:
    return f"{lanes} lanes, stagger {stagger}" if lanes else "streaming"


def strip_variants(stats: dict, smi) -> None:
    """What chose the strip kernels' lanes and stagger, and what they
    replaced: at every size of STRIP_TIMED, K13, K16 and K17's modes on each
    variant (VARIANTS, forced through tridiag_cuda._forced_strip), each
    first held bit-equal to its plain version, then timed as the median of
    10 calls, in turns (the list, then the list reversed). A variant
    whose strip does not fit one worker a block (the rule the route uses)
    is said so before any launch; every launch error raises. The streaming
    kernels' JSON entries take their 512^3 f32 times."""
    for shape, dtype in STRIP_TIMED:
        g = torch.Generator(device=DEVICE).manual_seed(29)
        f = torch.rand(shape, generator=g, dtype=dtype, device=DEVICE) * 2 - 1
        d = tuple(1.0 / n for n in shape)
        n, tag = shape[0], f"{shape[0]}^3 {str(dtype).replace('torch.', '')}"
        record = n == 512 and dtype == torch.float32
        forced = lambda key, la, st: tridiag_cuda._forced_strip(
            key.split(".")[1], n, dtype, f.device, la, st)
        calls, ts = strip_calls(f, d), {}
        for key, call in calls.items():
            ref = call(plain=True)
            for la, st in VARIANTS:
                name = f"{key} {variant_name(la, st)}"
                counter = key if la else f"{key}.long"
                with forced(key, la, st) as fits:
                    if not fits:
                        print(f"  {tag} {name}: the strip does not fit one worker a block",
                              flush=True)
                        continue
                    before = sc.LAUNCHES[counter]
                    err = compare(f"{name} {tag}", call(), ref)
                torch.cuda.synchronize()
                if sc.LAUNCHES[counter] != before + 1:
                    raise AssertionError(f"{name} {tag} did not launch {counter}")
                if err != 0.0:
                    raise AssertionError(f"{name} {tag}: field max|diff| {err:.3e}, "
                                         "not bit-equal")
                stats[counter]["max_abs_err"] = max(stats[counter]["max_abs_err"], err)
                ts[name] = (key, la, st, [])
            del ref
        for order in (list(ts), list(ts)[::-1]):
            for name in order:
                key, la, st, v = ts[name]
                with forced(key, la, st):
                    v.append(median_ms(calls[key], reps=10, warm=2))
        for name, (key, la, st, v) in ts.items():
            ms = statistics.median(v)
            print(f"  {tag} {name}: {ms:.4f} ms ({' / '.join(f'{t:.4f}' for t in v)}), "
                  f"{share(strip_floor(key, f), ms)}", flush=True)
            if record and la == 0:
                stats[f"{key}.long"].update(ms=ms, plain_ms=stats[key]["plain_ms"],
                                            library_ms=stats[key]["library_ms"],
                                            **strip_floor(key, f))
        print(f"  ({smi})", flush=True)
        del f, calls
        torch.cuda.empty_cache()


def check_long(stats: dict) -> None:
    """K13, K16 and K17 on lines too long for two strip workers a block
    (LONG_CASES): the route must take the streaming kernels (.long
    counters), each field bit-equal to its plain version."""
    for shape, dtype in LONG_CASES:
        g = torch.Generator(device=DEVICE).manual_seed(sum(shape))
        f = torch.rand(shape, generator=g, dtype=dtype, device=DEVICE) * 2 - 1
        d = tuple(1.0 / n for n in shape)
        for key, call in strip_calls(f, d).items():
            before = sc.LAUNCHES[f"{key}.long"]
            err = compare(f"{key} {shape} {dtype}", call(), call(plain=True))
            torch.cuda.synchronize()
            if sc.LAUNCHES[f"{key}.long"] != before + 1:
                raise AssertionError(f"{key} at {shape} {dtype} did not take the streaming kernel")
            if err != 0.0:
                raise AssertionError(f"{key}.long {shape} {dtype}: field max|diff| {err:.3e}, "
                                     "not bit-equal")
            stats[f"{key}.long"]["max_abs_err"] = max(stats[f"{key}.long"]["max_abs_err"], err)
        print(f"  K13, K16 and K17 at {shape} {dtype} (lines of {shape[0]}): the streaming "
              "kernels, bit-equal to the plain versions", flush=True)
        del f


def rhs(solver, n, dtype):
    """b = A u for u uniform(-1, 1) from numpy seed 1, mean removed."""
    u = np.random.default_rng(1).uniform(-1.0, 1.0, (n,) * 3)
    u -= u.mean()
    return solver.rhs_for(torch.as_tensor(u, dtype=dtype, device=DEVICE))


def true_tol(extra) -> float:
    """The true relative residual a solve to rtol must reach, over rtol:
    1.01 for the methods that monitor the true residual (CG, PIPECG's
    recurrence, Richardson); 10 for GMRES, which stops on the
    preconditioned residual ||M r|| / ||M b||."""
    return 10.0 if "gmres" in extra else 1.01


def solve_case(n, dtype, rtol, extra, expect_its):
    """One solve through PoissonSolver on the card (MG-CG unless `extra`
    says another -ksp_type), checked; returns (solver, b, iterations)."""
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
            "-ksp_max_it", "50", *extra]
    solver = PoissonSolver((n,) * 3, options=Options(argv), dtype=dtype,
                           device=DEVICE)
    b = rhs(solver, n, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    its = int(res.iterations)
    t_solve = time.perf_counter() - t0
    rel = solver.residual_norm(res.x, b)
    if tuple(res.x.shape) != (n,) * 3 or not bool(torch.isfinite(res.x).all()):
        raise AssertionError(f"{n}^3: bad solution tensor")
    bad_its = expect_its is not None and its != expect_its
    if bad_its or not res.reason_enum() > 0 or not rel <= rtol * true_tol(extra):
        raise AssertionError(f"{n}^3 {dtype} {extra}: {its} iterations "
                             f"(expected {expect_its}), {res.reason_enum().name}, "
                             f"relative residual {rel:.3e} (rtol {rtol:g})")
    M = solver._solver.M
    print(f"  {n}^3 {dtype} rtol {rtol:g} {' '.join(extra)}: {its} iterations, "
          f"relative residual {rel:.3e}, monitored {float(res.residual_norm):.3e}, "
          f"first solve {t_solve * 1e3:.2f} ms"
          + (f", M: {M.resolved}" if M is not None else ""), flush=True)
    return solver, b, its


def run_path(label, cases, required, totals, demo=False, runner=None, routes=()):
    """Drive one path (`runner`, by default solve_case, on each case) with
    the counters reset before and read after; fail if a kernel the path
    needs was never launched, or a K15 kernel in `routes`. `demo` (True,
    or the demo's extra options) runs the demo at 64^3 too. Returns the
    runs."""
    print(f"-- path {label}", flush=True)
    sc.reset_launches()
    for k in cp.ROUTE_LAUNCHES:
        cp.ROUTE_LAUNCHES[k] = 0
    runs = [(runner or solve_case)(*c) for c in cases]
    if demo:
        from poissbox_tpu_torch import demo as demo_mod
        extra = [] if demo is True else list(demo)
        rel = demo_mod.run(Options(["-n", "64", "-device", DEVICE, *extra]))
        if not rel <= 1e-5 * true_tol(extra):
            raise AssertionError(f"demo {extra}: relative residual {rel:.3e}")
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    idle = [k for k in required if launches[k] == 0]
    idle += [f"K15 {r} kernel" for r in routes if cp.ROUTE_LAUNCHES[r] == 0]
    if idle:
        raise AssertionError(f"path {label}: kernels never launched: {idle}")
    if launches["rbsor.general"] or launches["rbsor.general.bf16"]:
        raise AssertionError(f"path {label}: a red-black sweep took two launches")
    print(f"  launches: { {k: v for k, v in launches.items() if v} }"
          + (f"; K15 by kernel {dict(cp.ROUTE_LAUNCHES)}"
             if any(cp.ROUTE_LAUNCHES.values()) else ""), flush=True)
    for k, v in launches.items():
        totals[k] += v
    return runs


def plain_solver(n, dtype, rtol, extra):
    """The same options on the plain PyTorch path on the card: the roll
    operator, impl='roll', transfers='roll' (`extra` may name another
    -ksp_type)."""
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
            "-ksp_max_it", "50", *extra, "-mg_impl", "roll",
            "-mg_transfers", "roll"]
    grid = Grid3D((n,) * 3, device=DEVICE)
    A = make_laplacian_operator(grid, impl="roll")
    return ksp.make_solver(A, SolverOptions.from_options(Options(argv)),
                           dtype=dtype, grid=grid)


def warm_ms(fns: dict, reps: int = 3) -> dict:
    """Median wall time (ms) of each solve, ending in a synchronise, with
    the variants taken in turns."""
    ts = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in ts.items()}


def compare_paths(runs, cases, smi, roll_runs=None):
    """Each solve against the plain path on the card (same iteration
    count), then warm solve medians: kernels, kernels with roll transfers
    (where given), plain."""
    for i, ((solver, b, its), (n, dtype, rtol, extra, _)) in enumerate(zip(runs, cases)):
        plain = plain_solver(n, dtype, rtol, extra)
        p_its = int(plain(b).iterations)
        if p_its != its:
            raise AssertionError(f"plain {n}^3 {extra}: {p_its} iterations, "
                                 f"kernel path {its}")
        fns = {"kernels": lambda: solver.solve(b)}
        if roll_runs is not None:
            rsolver, rb, _ = roll_runs[i]
            fns["kernels, roll transfers"] = lambda: rsolver.solve(rb)
        fns["plain"] = lambda: plain(b)
        med = warm_ms(fns)
        print(f"  {n}^3 {dtype} {' '.join(extra)}: {its} iterations both; warm "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
              + f" ({smi})", flush=True)


def smooth_u(grid, dtype):
    """The smooth manufactured field of the JAX package's compact Krylov
    test (tests/test_fft.py:144-146): sin/cos modes 1-3, mean removed.
    The order-6 Krylov path takes smooth right-hand sides (the staggered
    interpolation annihilates Nyquist modes)."""
    x, y, z = grid.coords(dtype=torch.float64)
    k = 2.0 * math.pi
    u = torch.sin(k * x) * torch.cos(2 * k * y) + torch.sin(3 * k * z) + torch.cos(k * (x + z))
    return (u - u.mean()).to(dtype)


def f32_operator_error(n: int) -> float:
    """||A32 u32 - A64 u64|| / ||A64 u64|| for the compact Laplacian on the
    smooth field: the relative residual below which no f32 solution can be
    certified at this size."""
    grid = Grid3D((n,) * 3, device=DEVICE)
    u = smooth_u(grid, torch.float64)
    b64 = cp.lapl(u, grid.deltas)
    b32 = cp.lapl(u.float(), grid.deltas)
    return float(torch.linalg.vector_norm(b32.double() - b64)
                 / torch.linalg.vector_norm(b64))


def solve6_case(n, dtype, rtol, argv):
    """One solve of PoissonSolver(order=6) on the card, checked; returns
    (solver, b, iterations)."""
    opts = Options(argv + ["-ksp_rtol", str(rtol), "-ksp_max_it", "200"])
    solver = PoissonSolver((n,) * 3, options=opts, dtype=dtype, device=DEVICE, order=6)
    b = solver.rhs_for(smooth_u(solver.grid, dtype))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    its = int(res.iterations)
    t_solve = time.perf_counter() - t0
    rel = solver.residual_norm(res.x, b)
    if tuple(res.x.shape) != (n,) * 3 or not bool(torch.isfinite(res.x).all()):
        raise AssertionError(f"order 6 {n}^3: bad solution tensor")
    if not res.reason_enum() > 0 or not rel <= rtol * 1.01:
        raise AssertionError(f"order 6 {n}^3 {dtype} {' '.join(argv)}: {its} "
                             f"iterations, {res.reason_enum().name}, relative "
                             f"residual {rel:.3e} (rtol {rtol:g})")
    print(f"  order 6 {n}^3 {dtype} rtol {rtol:g} {' '.join(argv)}: {its} iterations, "
          f"relative residual {rel:.3e}, first solve {t_solve * 1e3:.2f} ms", flush=True)
    return solver, b, its


def plain6(n, dtype, rtol, argv):
    """The same solve on the plain path on the card: the compact operator
    through the tridiagonal solves (method="pscan"), impl="roll",
    transfers="roll". Returns (operator, solver)."""
    grid = Grid3D((n,) * 3, device=DEVICE)
    A = make_compact_laplacian_operator(grid, method="pscan")
    opts = Options(argv + ["-ksp_rtol", str(rtol), "-ksp_max_it", "200",
                           "-mg_impl", "roll", "-mg_transfers", "roll"])
    return A, ksp.make_solver(A, SolverOptions.from_options(opts), dtype=dtype, grid=grid)


def compare6(runs, cases, smi) -> None:
    """Each order-6 solve against the plain path on the card (same
    iteration count), then warm solve medians, in turns."""
    for (solver, b, its), (n, dtype, rtol, argv) in zip(runs, cases):
        A, plain = plain6(n, dtype, rtol, argv)
        p_its = int(plain(b).iterations)
        if p_its != its:
            raise AssertionError(f"order 6 plain {n}^3 {dtype} {argv}: {p_its} "
                                 f"iterations, kernel path {its}")
        med = warm_ms({"kernels": lambda: solver.solve(b), "plain": lambda: plain(b)})
        print(f"  order 6 {n}^3 {dtype} {' '.join(argv)}: {its} iterations both; warm "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
              + f" ({smi})", flush=True)


def solve6_thomas_case(n, dtype, rtol, argv):
    """Path (l): the compact operator with method="pallas" (the JAX
    package's Thomas pipeline, on K17) solved by ksp.make_solver with
    `argv`, on path (d)'s b (the smooth field through K15's operator);
    checked by its true residual. Returns (solver, b, iterations)."""
    grid = Grid3D((n,) * 3, device=DEVICE)
    A = make_compact_laplacian_operator(grid, method="pallas")
    opts = Options(argv + ["-ksp_rtol", str(rtol), "-ksp_max_it", "200"])
    solver = ksp.make_solver(A, SolverOptions.from_options(opts), dtype=dtype, grid=grid)
    b = make_compact_laplacian_operator(grid)(smooth_u(grid, dtype))
    torch.cuda.synchronize()
    before = dict(sc.LAUNCHES)
    t0 = time.perf_counter()
    res = solver(b)
    t_solve = time.perf_counter() - t0
    its = int(res.iterations)
    k17 = {k: v - before[k] for k, v in sc.LAUNCHES.items()
           if k.startswith("tridiag.") and v != before[k]}
    rel = float(torch.linalg.vector_norm(A(res.x) - b) / torch.linalg.vector_norm(b))
    if (tuple(res.x.shape) != (n,) * 3 or not bool(torch.isfinite(res.x).all())
            or not res.reason_enum() > 0 or not rel <= rtol * 1.01):
        raise AssertionError(f"order 6 K17 {n}^3 {dtype}: {its} iterations, "
                             f"{res.reason_enum().name}, relative residual {rel:.3e}")
    print(f"  order 6 through K17 {n}^3 {dtype} rtol {rtol:g}: {its} iterations, relative "
          f"residual {rel:.3e}, first solve {t_solve * 1e3:.2f} ms; K17 launches at this "
          f"size {k17}", flush=True)
    return solver, b, its


def compare6_thomas(runs, cases, smi) -> None:
    """Path (l) against the K15 path (d), PoissonSolver(order=6), on the
    same b: equal iterations, then warm walls in turns."""
    for (solver, b, its), (n, dtype, rtol, argv) in zip(runs, cases):
        opts = Options(argv + ["-ksp_rtol", str(rtol), "-ksp_max_it", "200"])
        k15 = PoissonSolver((n,) * 3, options=opts, dtype=dtype, device=DEVICE, order=6)
        k15_its = int(k15.solve(b).iterations)
        if k15_its != its:
            raise AssertionError(f"order 6 {n}^3 {dtype}: K17 path {its} iterations, "
                                 f"K15 path {k15_its}")
        med = warm_ms({"K17 (method=pallas)": lambda: solver(b),
                       "K15 (auto)": lambda: k15.solve(b)})
        print(f"  order 6 {n}^3 {dtype}: {its} iterations both; warm "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items()) + f" ({smi})",
              flush=True)


def lapl_pairs(smi, n: int = 512) -> None:
    """The deciding measurement: K17's Laplacian (method="pallas", kernels
    and transposes) against K15's (method="auto") at n^3 in f32 and f64,
    seven pairs in turns, each call's time between CUDA events; the
    kernel launches of one call beside it."""
    for dtype in (torch.float32, torch.float64):
        grid = Grid3D((n,) * 3, device=DEVICE)
        g = torch.Generator(device=DEVICE).manual_seed(11)
        f = torch.rand((n,) * 3, generator=g, dtype=dtype, device=DEVICE) * 2 - 1
        d = grid.deltas
        fns = {"K17": lambda: compact.lapl(f, d, method="pallas"),
               "K15": lambda: compact.lapl(f, d, method="auto")}
        outs, launches = {}, {}
        for k, fn in fns.items():
            before = dict(sc.LAUNCHES)
            outs[k] = fn()
            torch.cuda.synchronize()
            launches[k] = {c: v - before[c] for c, v in sc.LAUNCHES.items() if v != before[c]}
        rel = float((outs["K17"] - outs["K15"]).abs().max() / outs["K15"].abs().max())
        if not rel <= 10 * FIELD_TOL[dtype]:
            raise AssertionError(f"K17 lapl vs K15 lapl {n}^3 {dtype}: relative {rel:.3e}")
        del outs
        ts = {k: [] for k in fns}
        for _ in range(7):
            for k, fn in fns.items():
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                ts[k].append(a.elapsed_time(b))
        wins = sum(x < y for x, y in zip(ts["K17"], ts["K15"]))
        print(f"  compact lapl {n}^3 {str(dtype).replace('torch.', '')}, K17 vs K15 "
              f"(relative diff {rel:.2e}): median [min, max] of 7 in turns "
              + ", ".join(f"{k} {statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}] ms "
                          f"({sum(launches[k].values())} counted launches: {launches[k]})"
                          for k, v in ts.items())
              + f"; K17 faster in {wins} of 7 ({smi})", flush=True)
        del f
        torch.cuda.empty_cache()


def sweep_pairs(smi) -> None:
    """KB's one-launch general sweep against the same sweep as two K11
    colour updates, at 256^3 f32 and 512^3 bf16: equal outputs, then seven
    pairs in turns, each call's device time between CUDA events (the mean
    of 10 back-to-back calls)."""
    for n, dtype in ((256, torch.float32), (512, BF16)):
        g = torch.Generator(device=DEVICE).manual_seed(n + 17)
        u, b = ((torch.rand((n,) * 3, generator=g, device=DEVICE) * 2 - 0.75).to(dtype)
                for _ in range(2))
        d = Grid3D((n,) * 3, device=DEVICE).deltas
        fns = {"one-pass sweep": lambda: sc.sor_rb_sweep_cuda(u, b, d, W),
               "two K11 launches": lambda: sc.sor_sweep_cuda(
                   sc.sor_sweep_cuda(u, b, d, W, 0), b, d, W, 1)}
        if not torch.equal(fns["one-pass sweep"](), fns["two K11 launches"]()):
            raise AssertionError(f"sweep {n}^3 {dtype}: one pass differs from two K11 launches")
        ts = {k: [] for k in fns}
        for _ in range(7):
            for k, fn in fns.items():
                ts[k].append(loop_ms(fn, reps=10))
        wins = sum(x < y for x, y in zip(ts["one-pass sweep"], ts["two K11 launches"]))
        print(f"  general sweep {n}^3 {str(dtype).replace('torch.', '')}, equal outputs; "
              "median [min, max] of 7 in turns "
              + ", ".join(f"{k} {statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}] ms"
                          for k, v in ts.items())
              + f"; one pass faster in {wins} of 7 ({smi})", flush=True)
        del u, b
        torch.cuda.empty_cache()


def log_view_demo(smi) -> None:
    """The demo with -log_view on the card, outside any counted path: the
    table's event lines must be there."""
    from poissbox_tpu_torch import demo as demo_mod
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rel = demo_mod.run(Options(["-n", "64", "-device", DEVICE, "-log_view",
                                    "-options_error_if_unused"]))
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("log_view:")]
    names = [ln.split()[1] for ln in lines[1:] if ln.startswith("log_view:   ")]
    if names != ["MatMult", "PCApply", "other", "setup", "solve"] or not rel <= 1e-5:
        raise AssertionError(f"demo -log_view: events {names}, relative residual {rel:.3e}")
    for ln in lines:
        print(f"  {ln}")
    print(f"  demo -n 64 -log_view: relative residual {rel:.3e} ({smi})", flush=True)


def utils_on_card(run, smi) -> None:
    """The utils on the card, outside any counted path: check_field on
    path (a)'s 64^3 f64 solution; then one NaN in its b: check_field
    refuses it, the solve with the NaN checks on raises FloatingPointError
    naming CG and iteration 0, and with them off stops with DIVERGED_NAN."""
    solver, b, _ = run
    n = b.shape[0]
    x = solver.solve(b).x
    check_field(x, shape=(n,) * 3, dtype=torch.float64, name="path (a) x")
    bn = b.clone()
    bn.view(-1)[bn.numel() // 3] = float("nan")
    try:
        check_field(bn, name="b")
        raise AssertionError("check_field passed a b that holds a NaN")
    except FloatingPointError:
        pass
    enable_nan_checks()
    try:
        solver.solve(bn)
        raise AssertionError("the NaN checks did not raise on a NaN b")
    except FloatingPointError as e:
        msg = str(e)
    finally:
        enable_nan_checks(False)
    res = solver.solve(bn)
    if not msg.startswith("cg: ") or "iteration 0 " not in msg or debugging.nan_checks_enabled():
        raise AssertionError(f"NaN checks: {msg!r}")
    if res.reason_enum() != ConvergedReason.DIVERGED_NAN or int(res.iterations) != 0:
        raise AssertionError(f"NaN b with the checks off: {res.reason_enum().name}, "
                             f"{int(res.iterations)} iterations")
    print(f"  utils {n}^3 f64: check_field passed the solution and refused a NaN b; NaN "
          f"checks on: {msg!r}; off: {res.reason_enum().name} after "
          f"{int(res.iterations)} iterations ({smi})", flush=True)


# kernel name -> group of the device-time breakdown (first match wins)
GROUPS = (("KB", ("sweep_kernel",)), ("K11", ("colour_kernel",)), ("K6", ("restrict_kernel",)),
          ("K7", ("prolong_add_kernel",)), ("KA", ("stencil7_kernel",)),
          ("K8", ("cgupd",)), ("K15", ("compact_reg_kernel", "compact_kernel")),
          ("contractions", ("gemm", "cutlass", "xmma", "sm90")))


def profile_solve(label, solver, b, smi) -> None:
    """One warm solve under torch.profiler: device time by group (the
    rest is torch's elementwise and reduction kernels), the kernel count,
    the wall of the profiled solve and the busy share: device time over
    the median wall of three unprofiled warm solves (the profiled wall
    carries the profiler's own host cost)."""
    solver.solve(b)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    warm = statistics.median(walls)
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    times = profiling.device_times(prof)
    if not times:
        print(f"  profile {label}: the profiler saw no device time", flush=True)
        return
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["elementwise and other"] = 0.0
    for kname, (_, us) in times.items():
        grp = next((name for name, keys in GROUPS if any(k in kname for k in keys)),
                   "elementwise and other")
        groups[grp] += us / 1e3
    dev = sum(groups.values())
    count = sum(c for c, _ in times.values())
    print(f"  profile {label}: {count} kernels, {dev:.2f} ms device; unprofiled warm "
          f"wall {warm:.2f} ms (busy {100 * dev / warm:.1f} %), profiled wall "
          f"{wall:.2f} ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()) + f" ms ({smi})", flush=True)


def fft_case(order: int, n: int, dtype, smi) -> None:
    """-ksp_type fft through PoissonSolver on the card: the relative
    residual, bounded by twice the plain path's on the same b (the plain
    operator measures it: roll for order 2, pscan for order 6), the warm
    solves in turns and the direct solve's own time."""
    solver = PoissonSolver((n,) * 3, options=Options(["-ksp_type", "fft"]),
                           dtype=dtype, device=DEVICE, order=order)
    grid = solver.grid
    if order == 2:
        g = torch.Generator(device=DEVICE).manual_seed(4)
        u = torch.rand(grid.n, generator=g, dtype=dtype, device=DEVICE) * 2 - 1
        u = u - u.mean()
        A = make_laplacian_operator(grid, impl="roll")
        direct = lambda v: fft.poisson_solve_fft(v, grid.deltas)
    else:
        u = smooth_u(grid, dtype)
        A = make_compact_laplacian_operator(grid, method="pscan")
        direct = lambda v: fft.compact_poisson_solve_fft(v, grid.deltas)
    b = solver.rhs_for(u)
    res = solver.solve(b)
    rel = solver.residual_norm(res.x, b)
    plain = ksp.make_solver(A, SolverOptions(ksp_type="fft"), dtype=dtype, grid=grid)
    xp = plain(b).x
    rel_p = float(torch.linalg.vector_norm(A(xp) - b) / torch.linalg.vector_norm(b))
    ok = (int(res.iterations) == 1 and bool(torch.isfinite(res.x).all())
          and rel <= 2.0 * rel_p)
    if not ok:
        raise AssertionError(f"fft order {order} {n}^3: relative residual {rel:.3e}, "
                             f"plain path {rel_p:.3e}")
    del xp
    med = warm_ms({"kernels": lambda: solver.solve(b), "plain": lambda: plain(b)})
    solve_ms = median_ms(lambda: direct(b))
    print(f"  fft order {order} {n}^3 {dtype}: relative residual {rel:.3e} (plain path "
          f"{rel_p:.3e}); direct solve {solve_ms:.4f} ms; warm -ksp_type fft "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items()) + f" ({smi})",
          flush=True)


def loop_ms(fn, reps: int = 200) -> float:
    """Device time of one call from `reps` back-to-back calls between two
    CUDA events: the kernel's time where it outlasts the host's enqueue of
    a call (about 10 us through the wrapper), the host's where it does not."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def tridiag_path(smi, n: int = 512, dtype=torch.float32):
    """Path (f): the JAX package's bench_tridiag case on the card, through
    CudaTridiagFactor: the periodic (alpha, 1, alpha) system at n^3
    solved along axis 0, by PCR (what "auto" picks), by Thomas and by the
    twisted factorization (K16); each against its plain version and by its
    own residual. Returns (factors by algorithm, d, tag) for tridiag_pairs."""
    g = torch.Generator(device=DEVICE).manual_seed(2)
    d = torch.rand((n,) * 3, generator=g, dtype=dtype, device=DEVICE)
    a, bb, c = tridiag_system(n, dtype)
    tag = f"{n}^3 {str(dtype).replace('torch.', '')}"
    facs = {}
    for alg in ("auto", "thomas", "babe"):
        fac = CudaTridiagFactor(a, bb, c, periodic=True, algorithm=alg)
        x = fac.solve(d, 0)
        err = compare(f"tridiag {fac.algorithm} path", x, fac.solve(d, 0, plain=True))
        if err != 0.0:
            raise AssertionError(f"tridiag {fac.algorithm} path {tag}: not bit-equal")
        r = ALPHA_TRI * (torch.roll(x, 1, 0) + torch.roll(x, -1, 0)) + x - d
        rel = float(r.abs().max()) / float(d.abs().max())
        if not rel <= (1e-5 if dtype == torch.float32 else 1e-12):
            raise AssertionError(f"tridiag {fac.algorithm}: residual {rel:.3e}")
        print(f"  tridiag {alg} -> {fac.algorithm} {tag}: max residual "
              f"{rel:.2e} of max|d| ({smi})", flush=True)
        facs[alg] = fac
    return facs, d, tag


def tridiag_pairs(runs, smi) -> None:
    """K16 against K13, both on their strip kernels, on path (f)'s
    systems, outside the path's counted run: the median of 25 calls
    between CUDA events and back-to-back launches, in turns (K13, K16,
    K16, K13)."""
    show = lambda v: " / ".join(f"{t:.4f}" for t in v)
    for facs, d, tag in runs:
        d2 = d.reshape(d.shape[0], -1)
        ev = {"thomas": [], "babe": []}
        loop = {"thomas": [], "babe": []}
        for alg in ("thomas", "babe", "babe", "thomas"):
            fac = facs[alg]
            ev[alg].append(median_ms(lambda: fac.solve(d, 0)))
            loop[alg].append(loop_ms(lambda: fac._solve_lines(d2, False)))
        print(f"  K16 vs K13 {tag} (strip kernels), in turns: median of 25 calls thomas "
              f"{show(ev['thomas'])} ms, babe {show(ev['babe'])} ms; back-to-back "
              f"launches thomas {show(loop['thomas'])} ms, babe {show(loop['babe'])} "
              f"ms ({smi})", flush=True)


def gmres_none_case(smi, n: int = 64, its: int = 60) -> None:
    """Path (g), -pc_type none: GMRES(30) at 64^3 f64 for a fixed 60
    iterations (rtol 1e-14 is out of reach). The kernel operator hands
    <V_j, A V_j> from K2 to the Gram-Schmidt step (use_fused); the plain
    path's roll operator takes it from the basis product. Histories to
    1e-10 relative."""
    extra = ["-ksp_type", "gmres", "-pc_type", "none", "-ksp_max_it", str(its)]
    solver = PoissonSolver((n,) * 3, options=Options(extra + ["-ksp_rtol", "1e-14"]),
                           dtype=torch.float64, device=DEVICE)
    if solver.A.apply_dot is None or solver._solver.M is not None:
        raise AssertionError("gmres -pc_type none: K2 not bound on the operator")
    b = rhs(solver, n, torch.float64)
    res = solver.solve(b)
    plain = plain_solver(n, torch.float64, 1e-14, extra)
    ref = plain(b)
    h, hp = res.history.double(), ref.history.double()
    worst = float(((h - hp).abs() / hp.abs()).max())
    if int(res.iterations) != its or int(ref.iterations) != its or not worst <= 1e-10:
        raise AssertionError(f"gmres none: {int(res.iterations)}/{int(ref.iterations)} "
                             f"iterations, history relative diff {worst:.3e}")
    med = warm_ms({"kernels": lambda: solver.solve(b), "plain": lambda: plain(b)})
    print(f"  gmres -pc_type none {n}^3 f64, {its} iterations both: monitored "
          f"{float(res.residual_norm):.3e} (x{float(res.residual_norm / h[0]):.3e}), "
          f"history max relative diff {worst:.3e}; warm "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items()) + f" ({smi})",
          flush=True)


def gmres_bf16_case(smi, n: int = 512) -> None:
    """Why GMRES keeps a float32 pre-smooth at 512^3 f32 (solvers/ksp.py):
    the same solve with the JAX package's bf16 pre-smooth asked for. GMRES
    stops on its estimate of ||M r||, which a nonlinear M breaks; printed,
    not checked."""
    argv = ["-ksp_type", "gmres", "-pc_type", "mg", "-ksp_rtol", "1e-6",
            "-ksp_max_it", "50", "-mg_pre_dtype", "bfloat16"]
    s = PoissonSolver((n,) * 3, options=Options(argv), dtype=torch.float32,
                      device=DEVICE)
    b = rhs(s, n, torch.float32)
    res = s.solve(b)
    print(f"  gmres + MG with a bf16 pre-smooth, {n}^3 f32 rtol 1e-6: "
          f"{int(res.iterations)} iterations, {res.reason_enum().name} by its "
          f"estimate ({float(res.residual_norm / res.history[0]):.3e} of the "
          f"first), true relative residual {s.residual_norm(res.x, b):.3e} ({smi})",
          flush=True)
    del s, b, res
    torch.cuda.empty_cache()


def deferred_solver(n, dtype, rtol, extra):
    """MG-CG with the deferred p-update: the card's operator with K12 bound
    as `pupdate_apply_dot` (the JAX package's tests/test_round3.py
    construction; neither package binds it by default)."""
    argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
            "-ksp_max_it", "50", *extra]
    grid = Grid3D((n,) * 3, device=DEVICE)
    A = make_laplacian_operator(grid)
    d = grid.deltas
    A = dataclasses.replace(A, pupdate_apply_dot=lambda v, p, beta, zs:
                            sc.pupdate_lapl_dot_cuda(v, p, beta, zs, d))
    return ksp.make_solver(A, SolverOptions.from_options(Options(argv)),
                           dtype=dtype, grid=grid)


def deferred_case(n, dtype, rtol, extra, expect_its):
    """Path (i): one deferred solve, checked like solve_case; returns
    (solver, b, iterations, x)."""
    solver = deferred_solver(n, dtype, rtol, extra)
    grid = Grid3D((n,) * 3, device=DEVICE)
    A = make_laplacian_operator(grid)
    u = np.random.default_rng(1).uniform(-1.0, 1.0, (n,) * 3)
    u -= u.mean()
    b = A(torch.as_tensor(u, dtype=dtype, device=DEVICE))
    res = solver(b)
    its = int(res.iterations)
    rel = float(torch.linalg.vector_norm(A(res.x) - b) / torch.linalg.vector_norm(b))
    if its != expect_its or not res.reason_enum() > 0 or not rel <= rtol * 1.01:
        raise AssertionError(f"deferred {n}^3 {extra}: {its} iterations (expected "
                             f"{expect_its}), relative residual {rel:.3e}")
    print(f"  deferred p-update {n}^3 {dtype} {' '.join(extra)}: {its} iterations, "
          f"relative residual {rel:.3e}", flush=True)
    return solver, b, its, res.x


def compare_deferred(runs, cases, smi) -> None:
    """Path (i) against the eager kernel path (PoissonSolver) and the plain
    path on the card: equal iterations; then the deciding measurement,
    warm deferred against eager, five each in turns."""
    for (dsolver, b, its, x), (n, dtype, rtol, extra, _) in zip(runs, cases):
        argv = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
                "-ksp_max_it", "50", *extra]
        eager = PoissonSolver((n,) * 3, options=Options(argv), dtype=dtype, device=DEVICE)
        e = eager.solve(b)
        p_its = int(plain_solver(n, dtype, rtol, extra)(b).iterations)
        if not int(e.iterations) == p_its == its:
            raise AssertionError(f"deferred {n}^3 {extra}: {its} iterations, eager "
                                 f"{int(e.iterations)}, plain {p_its}")
        dx = float((e.x - x).abs().max())
        ts = {"deferred (K12)": [], "eager": []}
        for _ in range(7):      # pairs, in turns
            ts["deferred (K12)"].append(_wall(lambda: dsolver(b)) * 1e3)
            ts["eager"].append(_wall(lambda: eager.solve(b)) * 1e3)
        wins = sum(d < e_ for d, e_ in zip(ts["deferred (K12)"], ts["eager"]))
        print(f"  {n}^3 {dtype} {' '.join(extra)}: {its} iterations deferred, eager and "
              f"plain; max|x_deferred - x_eager| {dx:.3e}; warm (median [min, max] of 7) "
              + ", ".join(f"{k} {statistics.median(v):.2f} [{min(v):.2f}, {max(v):.2f}] ms"
                          for k, v in ts.items())
              + f"; deferred faster in {wins} of 7 pairs ({smi})", flush=True)
        del e, eager
        torch.cuda.empty_cache()


def refine_case(n, smi, against_plain: bool):
    """Path (j): solve_refined to 1e-12 on b = A u in float64 (u from numpy
    seed 1). At 512^3 beside float64 MG-CG to the same rtol (warm walls,
    the MG setup timed apart); with `against_plain` the plain path's
    refinement (roll operator, roll MG) takes the same outer and inner
    counts."""
    f64 = torch.float64
    s = PoissonSolver((n,) * 3, dtype=f64, device=DEVICE)
    b = rhs(s, n, f64)
    bnorm = float(torch.linalg.vector_norm(b))
    res = s.solve_refined(b, rtol=1e-12, max_outer=4)
    rel = s.residual_norm(res.x, b)
    if not (rel <= 1e-12 and float(res.residual_norm) <= 1e-12 * bnorm
            and res.x.dtype == f64 and bool(torch.isfinite(res.x).all())):
        raise AssertionError(f"solve_refined {n}^3: relative residual {rel:.3e}")
    hist = ", ".join(f"{v / bnorm:.3e}" for v in res.history.tolist())
    print(f"  solve_refined {n}^3: {res.outer_iterations} outer passes, "
          f"{res.inner_iterations} inner MG-CG iterations, relative residual "
          f"{rel:.3e} (history {hist})", flush=True)
    if against_plain:
        grid = s.grid
        A = make_laplacian_operator(grid, impl="roll")
        M = mg.make_mg_preconditioner(grid.n, grid.deltas,
                                      mg.MGConfig(impl="roll", transfers="roll"),
                                      dtype=torch.float32, device=DEVICE)
        ref = refine(A, lambda r: cg(A, r, M=M, rtol=1e-6, max_it=50), b,
                     rtol=1e-12, max_outer=4)
        if (ref.outer_iterations, ref.inner_iterations) != (
                res.outer_iterations, res.inner_iterations):
            raise AssertionError(f"solve_refined {n}^3: {res.outer_iterations}/"
                                 f"{res.inner_iterations}, plain path "
                                 f"{ref.outer_iterations}/{ref.inner_iterations}")
        print(f"  plain path {n}^3: {ref.outer_iterations} outer, "
              f"{ref.inner_iterations} inner, relative residual "
              f"{float(ref.residual_norm) / bnorm:.3e}", flush=True)
        return
    setup = statistics.median(
        _wall(lambda: mg.make_mg_preconditioner(s.grid.n, s.grid.deltas, mg.MGConfig(),
                                                dtype=torch.float32, device=DEVICE))
        for _ in range(3))
    s64 = PoissonSolver((n,) * 3, options=Options(
        ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-12", "-ksp_max_it", "100"]),
        dtype=f64, device=DEVICE)
    r64 = s64.solve(b)
    rel64 = s64.residual_norm(r64.x, b)
    if not (r64.reason_enum() > 0 and rel64 <= 1e-12 * 1.01):
        raise AssertionError(f"f64 MG-CG {n}^3: {r64.reason_enum().name}, {rel64:.3e}")
    med = warm_ms({"solve_refined": lambda: s.solve_refined(b, rtol=1e-12, max_outer=4),
                   "f64 MG-CG": lambda: s64.solve(b)})
    print(f"  f64 MG-CG {n}^3 rtol 1e-12: {int(r64.iterations)} iterations, relative "
          f"residual {rel64:.3e}; warm "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
          + f"; MG setup per solve_refined call {setup * 1e3:.2f} ms ({smi})", flush=True)


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class Killed(Exception):
    """Raised by the chunk hook to stand for a preempted run."""


def checkpoint_case(n, smi, every: int = 2) -> None:
    """Path (k): solve_checkpointed at n^3 f32 (rtol 1e-6) in a temporary
    directory. A run killed after chunk 0 and resumed must give the
    uninterrupted run's total iterations and x exactly; a b changed in one
    element by one ulp must start fresh (the exact guard); the plain path
    takes the same total. Prints the wall against the plain solve."""
    f32 = torch.float32
    s = PoissonSolver((n,) * 3, dtype=f32, device=DEVICE)
    b = rhs(s, n, f32)
    M = mg.make_mg_preconditioner(s.grid.n, s.grid.deltas, mg.MGConfig(), dtype=f32,
                                  device=DEVICE)
    kw = dict(rtol=1e-6, max_it=500, every=every)

    def kill(chunk, result):
        if chunk == 0:
            raise Killed

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        full, total = s.solve_checkpointed(b, os.path.join(tmp, "full"), **kw)
        try:
            checkpoint.solve_with_checkpoints(s.A, b, os.path.join(tmp, "killed"), M=M,
                                              on_chunk=kill, **kw)
            raise AssertionError("the chunk hook did not stop the run")
        except Killed:
            pass
        saved = checkpoint.SolveCheckpoint.from_dict(
            checkpoint.load(os.path.join(tmp, "killed"), device=DEVICE))
        resumed, total_r = s.solve_checkpointed(b, os.path.join(tmp, "killed"), **kw)
        diff = float((resumed.x - full.x).abs().max())
        if not (bool(full.converged) and total_r == total and diff == 0.0
                and saved.iterations == every):
            raise AssertionError(f"checkpoint resume: total {total_r} vs {total}, "
                                 f"max|dx| {diff:.3e}, saved {saved.iterations}")
        b2 = b.clone()
        flat = b2.view(-1)
        i = flat.numel() // 3
        flat[i] = torch.nextafter(flat[i], torch.tensor(math.inf, dtype=f32, device=DEVICE))
        foreign, total_f = s.solve_checkpointed(b2, os.path.join(tmp, "killed"), **kw)
        fresh, total_0 = s.solve_checkpointed(b2, os.path.join(tmp, "fresh"), **kw)
        if not (total_f == total_0 and torch.equal(foreign.x, fresh.x)):
            raise AssertionError(f"a b one ulp away resumed: total {total_f}, fresh "
                                 f"{total_0}")
        A = make_laplacian_operator(s.grid, impl="roll")
        Mp = mg.make_mg_preconditioner(s.grid.n, s.grid.deltas,
                                       mg.MGConfig(impl="roll", transfers="roll"),
                                       dtype=f32, device=DEVICE)
        _, total_p = checkpoint.solve_with_checkpoints(A, b, os.path.join(tmp, "plain"),
                                                       M=Mp, **kw)
        if total_p != total:
            raise AssertionError(f"checkpointed plain path: {total_p} iterations, "
                                 f"kernel path {total}")
        size = os.path.getsize(os.path.join(tmp, "full.npz"))
        walls = {"solve_checkpointed": [], "solve": []}
        for i in range(3):
            walls["solve_checkpointed"].append(_wall(lambda: s.solve_checkpointed(
                b, os.path.join(tmp, f"timed{i}"), **kw)))
            walls["solve"].append(_wall(lambda: s.solve(b)))
        med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    print(f"  solve_checkpointed {n}^3 f32 every {every}: {total} iterations in "
          f"{-(-total // every)} chunks, killed after chunk 0 and resumed: same total, "
          f"max|dx| {diff:.1f}; a b one ulp away started fresh ({total_f} iterations); "
          f"plain path {total_p}; npz {size / 1e6:.1f} MB; warm "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items()) + f" ({smi})",
          flush=True)

# ---------------------------------------------------------------------------
# phase 7: distributed MG-CG, one process a rank
# ---------------------------------------------------------------------------

# (label, process grid, cases); a case: the global size, dtype, rtol, extra
# options (after "-ksp_type cg -pc_type mg -ksp_rtol RTOL -ksp_max_it 50",
# so a later -ksp_type wins), the iteration count it must take (None: the
# one-rank count alone), the kernels every rank must launch, and its kind:
# "solve" (PoissonSolver.solve), "refine" (solve_refined to RTOL: outer and
# inner counts), "ckpt" (solve_checkpointed every CKPT_EVERY iterations,
# then killed after chunk 0 and resumed, and over a b one ulp away on rank
# 1) or "logview" (ksp.solve with -log_view). The counts: 7 is the port's
# one-rank count at 512^3 (path (b), and the parent's reference solve
# below); 6 the JAX package's on (3, 1, 1) at 64^3 (tests/test_torch_dist_311.py
# runs it there) and on (2, 2, 2), the same as its one-device count; 7 with
# the Jacobi smoother, the one-rank count (tests/test_torch_dist_311.py holds
# the ranks to it).
DIST_K = ["stencil7.apply", "stencil7.apply_dot", "cgupd", "stencil7.residual"]
K11 = ["stencil7.apply", "stencil7.residual", "rbsor.general"]
K11_BF16 = K11 + ["rbsor.general.bf16"]
PIPECG = ["-ksp_type", "pipecg"]
GMRES = ["-ksp_type", "gmres", "-gmres_restart", "30"]
RICH = ["-ksp_type", "richardson"]
GMRES_NONE = GMRES + ["-pc_type", "none", "-ksp_max_it", "100"]
CKPT_EVERY = 2
DIST_GROUPS = [
    ("(2,2,1) 512^3 f32, the default cycle (bf16 pre-smooth)", (2, 2, 1),
     [(512, "float32", 1e-6, [], 7, DIST_K + ["rbsor.general", "rbsor.general.bf16"], "solve"),
      # GMRES and PIPECG keep their pre-smooth in float32 (a linear M):
      # no bf16 K11
      (512, "float32", 1e-6, PIPECG, None, K11, "solve"),
      (512, "float32", 1e-6, GMRES, None, K11, "solve"),
      (512, "float32", 1e-6, RICH, None, K11_BF16, "solve"),
      # float32 MG-CG corrections of a float64 iterate: K1 on both
      (512, "float64", 1e-12, [], None, DIST_K + ["rbsor.general", "rbsor.general.bf16"],
       "refine"),
      (512, "float32", 1e-6, [], 7, DIST_K + ["rbsor.general", "rbsor.general.bf16"],
       "logview"),
      (256, "float32", 1e-6, [], None, DIST_K + ["rbsor.general"], "ckpt")]),
    ("(3,1,1) 64^3 f64, the reference's split", (3, 1, 1),
     [(64, "float64", 1e-8, [], 6, DIST_K + ["rbsor.general"], "solve"),
      (64, "float64", 1e-8, ["-mg_levels_pc_type", "jacobi"], 7,
       DIST_K + ["stencil7.jacobi"], "solve"),
      (64, "float64", 1e-8, PIPECG, None, K11, "solve"),
      (64, "float64", 1e-8, GMRES, None, K11, "solve"),
      # K2 in the Gram-Schmidt step (use_fused), its partial dot in the
      # step's all-reduce
      (64, "float64", 1e-5, GMRES_NONE, None, ["stencil7.apply", "stencil7.apply_dot"],
       "solve")]),
    ("(2,2,2) 64^3 f64, 8 ranks", (2, 2, 2),
     [(64, "float64", 1e-8, [], 6, DIST_K + ["rbsor.general"], "solve")]),
]
# x against the one-rank x within 100 rtol, the rtol floored by kind:
# solve_refined's two float64 iterates each sit within the refinement's
# own error of the solution, cond(A) * 1e-12 at most, not within 1e-12 of
# each other
X_RTOL_FLOOR = {"refine": 1e-9}
# path (m)'s launches by rank for the kernels line: "label case" -> {kernel: [rank 0, ...]}
DIST_M: dict = {}
# the local blocks of those cases, and the smallest distributed level's,
# for the kernels of the path against their plain versions
DIST_BLOCKS = [((256, 256, 512), 512, torch.float32), ((22, 64, 64), 64, torch.float64),
               ((21, 64, 64), 64, torch.float64), ((32, 32, 32), 64, torch.float64),
               ((4, 4, 8), 16, torch.float32)]
DIST_MODES = ("stencil7.apply", "stencil7.apply_dot", "cgupd", "stencil7.residual",
              "stencil7.jacobi", "rbsor.general")
DIST_TIMEOUT = 240.0   # s: a rank's collectives, and the wait for a group
# the census of one MG-CG iteration, each path (m) case's: windows around
# solves of CENSUS_ITS[0] and CENSUS_ITS[1] iterations, the difference held
# to scaling.mgcg_iteration_model on every rank. A case that is not MG-CG
# is held by the MG-CG solve of its grid, dtype (a refinement's float32
# inner one) and MG options, run once a group.
CENSUS_ITS = (1, 2)
SMALL_MESSAGE = 64 * 1024   # bytes: "small" in the census by level
# the weak-scaling rung of the JAX package's model (512^3 a card,
# tests/test_scaling_model.py:90-101): four cards over NCCL only, no
# one-rank reference (the whole field would sit on one card). The box is
# (2, 2, 1) long, so each card holds the one-card 512^3 problem's block at
# its cell size (a unit box would make the cells 2:1 anisotropic)
WEAK_PGRID = (2, 2, 1)
WEAK_SHAPE = (1024, 1024, 512)
WEAK_LENGTH = (2.0, 2.0, 1.0)
WEAK_ARGV = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-6", "-ksp_max_it", "50"]
WEAK_SEED = 1000

# path (n), order 6 and the FFT across ranks: cases run inside phase 7's
# groups (the world of a group may take another process grid of its size:
# (2,1,2) in the four-rank group), by backend. Each: label, process grid,
# grid, dtype, order, options, rtol, and the iterations it must take (None:
# the one-rank count alone). 4 is the one-rank order-6 count at 256^3 f32
# (path (d)); the (3,1,1) 64^3 case takes the gather route (92 on one rank).
# Order 6 in f32 certifies no residual below the operator's own rounding:
# rtol 1e-3 at 256^3, 5e-3 at 512^3 (there a solve to 1e-3 left a true
# residual of 1.807e-3 on an H100, PERF.md).
FFT = ["-ksp_type", "fft"]
MGCG = ["-ksp_type", "cg", "-pc_type", "mg"]
FCG_FFT = ["-ksp_type", "fcg", "-pc_type", "fft"]
CPLX = [("(2,1,2) (16,16,18) f64 order 2 -ksp_type fft, the complex route", (2, 1, 2),
         (16, 16, 18), "float64", 2, FFT, 1e-8, 1),
        ("(2,1,2) (16,16,18) f64 order 6 -ksp_type fft, the complex route", (2, 1, 2),
         (16, 16, 18), "float64", 6, FFT, 1e-8, 1)]
GATHER6 = [("(3,1,1) 64^3 f64 order 6 CG + GMG, the gather route", (3, 1, 1),
            (64, 64, 64), "float64", 6, MGCG, 1e-8, None)]
PENCIL_CASES = {
    ((2, 2, 1), "gloo"): [
        ("(2,2,1) 256^3 f32 order 6 CG + GMG", (2, 2, 1), (256,) * 3, "float32", 6, MGCG,
         1e-3, 4),
        ("(2,2,1) 256^3 f32 order 6 -ksp_type fft, the packed route", (2, 2, 1),
         (256,) * 3, "float32", 6, FFT, 1e-3, 1),
        ("(2,2,1) 256^3 f32 order 6 FCG + -pc_type fft", (2, 2, 1), (256,) * 3, "float32",
         6, FCG_FFT, 1e-3, None),
        ("(2,2,1) 256^3 f32 order 2 -ksp_type fft", (2, 2, 1), (256,) * 3, "float32", 2,
         FFT, 1e-6, 1)] + CPLX,
    ((2, 2, 1), "nccl"): [
        ("(2,2,1) 512^3 f32 order 6 CG + GMG", (2, 2, 1), (512,) * 3, "float32", 6, MGCG,
         5e-3, None),
        ("(2,2,1) 512^3 f32 order 6 -ksp_type fft", (2, 2, 1), (512,) * 3, "float32", 6,
         FFT, 1e-3, 1),
        ("(2,2,1) 512^3 f32 order 2 -ksp_type fft", (2, 2, 1), (512,) * 3, "float32", 2,
         FFT, 1e-6, 1)] + CPLX,
    ((3, 1, 1), "gloo"): GATHER6,
    ((3, 1, 1), "nccl"): GATHER6,
}
# K15 launches by rank in path (n): case label -> [rank 0, rank 1, ...]
DIST_K15: dict = {}


def check_dist_blocks(stats: dict) -> None:
    """K1, K2, K8, K9, K10 and K11 at the local block shapes of the
    distributed phase against their plain versions (K11 bit for bit; its
    bf16 form and its times: check_colour_update)."""
    for shape, n, dtype in DIST_BLOCKS:
        d = (1.0 / n,) * 3
        f = fields(shape, dtype, seed=sum(shape) + 3)
        for name, ins, ops, kern, plain in mode_calls(d, False):
            key = name.split("/")[0]
            if key in DIST_MODES:
                err = compare(f"{name} block {shape} {dtype}", kern(f), plain(f))
                if key.startswith(BIT_EQUAL) and err != 0.0:
                    raise AssertionError(f"{name} block {shape} {dtype}: field max|diff| "
                                         f"{err:.3e}, not bit-equal")
                stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
        del f
        print(f"  the distributed path's kernels agree on the block {shape} {dtype}",
              flush=True)
    torch.cuda.empty_cache()


# K11's shapes: the distributed blocks (DIST_BLOCKS, down to the coarse
# (4, 4, 8)), odd and ragged tiles, odd x and z extents, 256^3 and 512^3;
# each in f32, f64 (below 256^3) and bf16, both colours, cubic cells and not
K11_KEYS = ("rbsor.general", "rbsor.general.bf16")
K11_SHAPES = [shape for shape, _, _ in DIST_BLOCKS] + [
    (6, 5, 7), (9, 6, 5), (40, 36, 52), (64, 32, 48), (256,) * 3, (512,) * 3]
# (shape, dtype) where K11 is timed: bf16 at the (2, 2, 1) block of 512^3
# (the distributed fine level, the counter's row) and at 512^3; f32 at
# 256^3 (the counter's row) and at the fine block
K11_TIMED = [((256, 256, 512), BF16), ((512,) * 3, BF16), ((256,) * 3, torch.float32),
             ((256, 256, 512), torch.float32)]


def check_colour_update(stats: dict) -> None:
    """K11 against its plain version bit for bit at every shape of
    K11_SHAPES, in f32, f64 and bf16, both colours, with cubic cells and
    with three spacings that differ; then kernel, plain and bound times at
    K11_TIMED, with the share of the bound."""
    for shape in K11_SHAPES:
        big = math.prod(shape) >= 256 ** 3
        for dtype in (torch.float32, torch.float64, BF16):
            if big and dtype == torch.float64:
                continue
            key = "rbsor.general" + (".bf16" if dtype == BF16 else "")
            g = torch.Generator(device=DEVICE).manual_seed(sum(shape) + 29)
            u, b = ((torch.rand(shape, generator=g, device=DEVICE,
                                dtype=torch.float64 if dtype == torch.float64
                                else torch.float32) * 2 - 0.75).to(dtype) for _ in range(2))
            iso = (1.0 / max(shape),) * 3
            for d in (iso, (1.0 / shape[0], 0.75 / shape[1], 1.5 / shape[2])):
                for colour in (0, 1):
                    got = sc.sor_sweep_cuda(u, b, d, W, colour)
                    err = compare(f"K11 {shape} {dtype} deltas {d} colour {colour}",
                                  got, sc.sor_sweep_plain(u, b, d, W, colour))
                    torch.cuda.synchronize()
                    if err != 0.0:
                        raise AssertionError(f"K11 {shape} {dtype} colour {colour}: field "
                                             f"max|diff| {err:.3e}, not bit-equal")
                    stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
                    del got
            if (shape, dtype) in K11_TIMED:
                kern = lambda: sc.sor_sweep_cuda(u, b, iso, W, 0)
                plain = lambda: sc.sor_sweep_plain(u, b, iso, W, 0)
                ms, plain_ms = median_ms(kern), median_ms(plain)
                bd = bound(3 * u.nbytes, 7 * u.numel())
                print(f"  K11 {key} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), {share(bd, ms)}",
                      flush=True)
                if (shape, dtype) in K11_TIMED[:1] + K11_TIMED[2:3]:
                    stats[key].update(ms=ms, plain_ms=plain_ms, **bd)
            del u, b
        torch.cuda.empty_cache()
        print(f"  K11 bit-equal to its plain version at {shape} (f32"
              + (", f64" if not big else "") + ", bf16; both colours; cubic cells "
              "and not)", flush=True)


# path (n)'s pencil route: (grid, process grid, dtype) whose blocks K15
# sweeps (rank 0's; every block of a layout has its shape)
PENCIL_BLOCKS = [((256,) * 3, (2, 2, 1), torch.float32), ((512,) * 3, (2, 2, 1), torch.float32),
                 ((16, 16, 18), (2, 1, 2), torch.float64)]


def check_pencil_blocks(stats: dict) -> None:
    """K15's Laplacian sweeps at the pencil block shapes path (n) gives
    them (each sweep on the pencil of its axis) against their plain
    versions, bit for bit."""
    for n, pgrid, dtype in PENCIL_BLOCKS:
        d = tuple(1.0 / m for m in n)
        g = torch.Generator(device=DEVICE).manual_seed(sum(n) + 11)
        for (program, axis), key in zip(cp.lapl_sweeps(n, d, dtype), LAPL_KEYS):
            shape = block_of(n, pgrid, pencil_spec(pgrid, axis), 0)[1]
            nin = 1 + max(idx for out in program for idx, _ in out)
            ins = [torch.rand(shape, generator=g, dtype=dtype, device=DEVICE) * 2 - 1
                   for _ in range(nin)]
            err = compare(f"{key} pencil block {shape} of {n} on {pgrid}",
                          tuple(cp.sweep(program, ins, axis, key=key)),
                          tuple(cp.sweep_plain(program, ins, axis)))
            if err != 0.0:
                raise AssertionError(f"{key} pencil block {shape}: max|diff| {err:.3e}, "
                                     "not bit-equal")
            stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
            print(f"  {key} on the pencil block {shape} ({cp.route(shape[axis])} kernel) of "
                  f"{n} on {pgrid} {dtype}: bit-equal to the plain sweep", flush=True)
            del ins
    torch.cuda.empty_cache()


def dist_argv(case) -> list:
    n, dtype_name, rtol, extra, _, _, _ = case
    return ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol), "-ksp_max_it", "50",
            *extra]


def dist_kind_run(kind, solver, b, rtol, path=None):
    """One run of a path (m) case: (result, iterations) where the
    iterations are the solve's count, [outer, inner] of solve_refined, or
    the total of solve_checkpointed (checkpoints under `path`)."""
    if kind == "refine":
        res = solver.solve_refined(b, rtol=rtol)
        return res, [res.outer_iterations, res.inner_iterations]
    if kind == "ckpt":
        res, total = solver.solve_checkpointed(b, path, rtol=rtol, every=CKPT_EVERY)
        return res, total
    res = solver.solve(b)
    return res, int(res.iterations)


def log_view_table(A, b, argv, grid) -> tuple[list, object]:
    """ksp.solve with -log_view: the table's lines this process printed
    (every other line of the solve's output dropped) and the result."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = ksp.solve(A, b, Options(list(argv) + ["-log_view"]), grid=grid)
    return [ln for ln in buf.getvalue().splitlines() if ln.startswith("log_view:")], res


def log_view_events(lines) -> list:
    """(event, count) of each row of a -log_view table ("other" has no
    count)."""
    return [(ln[12:22].strip(), ln[23:28].strip()) for ln in lines
            if ln.startswith("log_view:   ")]


def _dist_reference(case, tmp: str, idx: int, shared: dict) -> dict:
    """The one-rank run of `case` on the card (the parent's): u, b = A u
    (K1) and x saved for the ranks (u and b once a size and dtype), its
    iterations and warm wall; for "logview" the one-rank table's events."""
    n, dtype_name, rtol, extra, _, _, kind = case
    dtype = getattr(torch, dtype_name)
    solver = PoissonSolver((n,) * 3, options=Options(dist_argv(case)), dtype=dtype,
                           device=DEVICE)
    key = (n, dtype_name)
    if key not in shared:
        u = np.random.default_rng(1).uniform(-1.0, 1.0, (n,) * 3)
        u -= u.mean()
        ut = torch.as_tensor(u, dtype=dtype, device=DEVICE)
        files = {k: os.path.join(tmp, f"{k}_{n}_{dtype_name}.npy") for k in ("u", "b")}
        np.save(files["u"], ut.cpu().numpy())
        np.save(files["b"], solver.rhs_for(ut).cpu().numpy())
        shared[key] = files
        del ut
    files = dict(shared[key], x=os.path.join(tmp, f"x{idx}.npy"))
    b = torch.as_tensor(np.load(files["b"]), device=DEVICE)
    with tempfile.TemporaryDirectory(dir=tmp) as ck:
        res, its = dist_kind_run(kind, solver, b, rtol, os.path.join(ck, "one"))
        np.save(files["x"], res.x.cpu().numpy())
        out = {"its": its, "files": files, "rel": solver.residual_norm(res.x, b)}
        fresh = itertools.count()
        out["wall_ms"] = warm_ms({"one rank": lambda: dist_kind_run(
            kind, solver, b, rtol, os.path.join(ck, f"warm{next(fresh)}"))})["one rank"]
    if kind == "logview":
        lines, _ = log_view_table(solver.A, b, dist_argv(case), solver.grid)
        out["events"] = log_view_events(lines)
        out["lines"] = lines
    del solver, b, res
    torch.cuda.empty_cache()
    return out


def dist_worker(spec_path: str, rank: int) -> int:
    """One rank of a distributed group (run by the parent as
    `chip_smoke.py --dist-worker SPEC RANK`): the group's cases through
    PoissonSolver(shard=pgrid), the counters reset before and read after
    rhs_for, the case's run (dist_kind_run; ksp.solve with -log_view) and
    residual_norm; rank 0 writes the results."""
    import torch.distributed as dist
    from poissbox_tpu_torch import mesh
    from poissbox_tpu_torch.parallel import halo
    spec = json.loads(open(spec_path).read())
    world, pgrid = spec["world"], tuple(spec["pgrid"])
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    mesh.init_process_group(f"tcp://127.0.0.1:{spec['port']}", world, rank,
                            backend=spec["backend"], device=DEVICE,
                            timeout=DIST_TIMEOUT)
    results, censused = [], {}
    for idx, (case, ref) in enumerate(zip(spec["cases"], spec["refs"])):
        n, dtype_name, rtol, extra, _, _, kind = case
        dtype = getattr(torch, dtype_name)
        argv = dist_argv(case)
        solver = PoissonSolver((n,) * 3, options=Options(argv), dtype=dtype,
                               device=DEVICE, shard=pgrid)
        g, A = solver.grid, solver.A
        u = g.shard(np.load(ref["files"]["u"], mmap_mode="r"))
        b1 = g.shard(np.load(ref["files"]["b"], mmap_mode="r"))
        x1 = g.shard(np.load(ref["files"]["x"], mmap_mode="r"))
        ck = os.path.join(spec["tmp"], f"ckpt{idx}_{spec['backend']}")
        dist.barrier()
        sc.reset_launches()
        halo.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = solver.rhs_for(u)
        lines = []
        if kind == "logview":
            lines, res = log_view_table(A, b, argv, g)
            its = int(res.iterations)
        else:
            res, its = dist_kind_run(kind, solver, b, rtol, os.path.join(ck, "full"))
        rel = solver.residual_norm(res.x, b)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(sc.LAUNCHES)
        hcounts = dict(halo.COUNTS)
        by_rank = [None] * g.mesh.size
        dist.all_gather_object(by_rank, {k: v for k, v in counts.items() if v})
        keys = sorted(k for k in counts)
        vec = torch.tensor([counts[k] for k in keys], dtype=torch.float64,
                           device=g.device)
        csum = halo.allreduce_sum(vec, g.mesh)
        cmin = -halo.allreduce_max(-vec, g.mesh)
        hvec = torch.tensor([hcounts[k] for k in sorted(hcounts)], dtype=torch.float64,
                            device=g.device)
        hsum = halo.allreduce_sum(hvec, g.mesh)
        # the K1 matvec against the one-rank K1, and x against the one-rank x
        mv = halo.allreduce_max(((b - b1).abs().max() / b1.abs().max()).double()
                                .reshape(1), g.mesh)
        dx = res.x.double() - x1.double()
        ex = res.x.double() - u.double()
        sq = A.allreduce(torch.stack([torch.sum(dx * dx), torch.sum(x1.double() ** 2),
                                      torch.sum(ex * ex), torch.sum(u.double() ** 2)]))
        printed = [None] * g.mesh.size
        dist.all_gather_object(printed, len(lines))
        extra_out = checkpoint_checks(solver, b, ck, res, its, halo) if kind == "ckpt" else {}
        # the bytes of one matvec (K2) and of one V-cycle, alone
        halo.reset_counts()
        A.apply_dot(b)
        mv_bytes = halo.COUNTS["bytes"]
        halo.reset_counts()
        if solver._solver.M is not None and kind == "solve":
            solver._solver.M(b)
        v_bytes = halo.COUNTS["bytes"]
        walls = []
        # three warm runs over NCCL; one where the ranks share a card
        for rep in range(3 if halo.transport(b) == "nccl" else 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist_kind_run("solve" if kind == "logview" else kind, solver, b, rtol,
                          os.path.join(ck, f"warm{rep}"))
            torch.cuda.synchronize()
            walls.append(halo.allreduce_max(torch.tensor(
                [(time.perf_counter() - t0) * 1e3], dtype=torch.float64,
                device=g.device), g.mesh))
        results.append({
            # solve_refined has no reason: its residual check stands for it
            "its": its, "rel": rel, "reason": 1 if kind == "refine" else int(res.reason),
            "shape": list(res.x.shape), "finite": bool(torch.isfinite(res.x).all()),
            "dofs": g.dof_counts(), "local_shape": list(g.local_shape),
            "backend": dist.get_backend(), "route": halo.transport(b),
            "matvec_rel": float(mv),
            "x_rel_diff": float(sq[0].sqrt() / sq[1].sqrt()),
            "x_err_exact": float(sq[2].sqrt() / sq[3].sqrt()),
            "launches_rank0": {k: v for k, v in counts.items() if v},
            "launches_sum": {k: int(v) for k, v in zip(keys, csum.tolist()) if v},
            "launches_min": {k: int(v) for k, v in zip(keys, cmin.tolist())},
            "launches_by_rank": by_rank,
            "halo_rank0": hcounts,
            "halo_sum": {k: int(v) for k, v in zip(sorted(hcounts), hsum.tolist())},
            "mv_bytes": mv_bytes, "v_bytes": v_bytes,
            "lines": lines, "printed_by_rank": printed,
            "first_ms": first_ms,
            "warm_ms": statistics.median(float(w) for w in walls),
            "warm_reps": len(walls), **extra_out})
        del solver, u, b1, x1, res
        torch.cuda.empty_cache()
        key = census_key(case)
        if key in censused:
            results[-1]["census_of"] = censused[key]
        else:
            # the case's MG-CG solve (the case's own method where it is CG)
            censused[key] = idx
            _, dtype_c, mg_opts = key
            argv_c = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", str(rtol),
                      *mg_opts]
            results[-1]["census"] = census_iteration((n,) * 3, getattr(torch, dtype_c),
                                                     argv_c, b, g, dist)
            results[-1]["census_of"] = idx
        del b
        torch.cuda.empty_cache()
    results_n = [pencil_worker_case(case, halo, dist) for case in spec["cases_n"]]
    weak = weak_case(pgrid, halo, dist) if spec.get("weak") else None
    if rank == 0:
        with open(spec["out"], "w") as fh:
            json.dump({"m": results, "n": results_n, "weak": weak}, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def census_key(case) -> tuple:
    """The MG-CG solve that holds `case`'s census: grid, dtype (float32
    for solve_refined's inner solves) and the MG options."""
    n, dtype_name, rtol, extra, _, _, kind = case
    mg_opts = tuple(t for k, v in zip(extra[::2], extra[1::2]) if k.startswith("-mg_")
                    for t in (k, v))
    return (n, "float32" if kind == "refine" else dtype_name, mg_opts)


def census_iteration(shape, dtype, argv, b, g, dist, length=(1.0, 1.0, 1.0)) -> dict:
    """One MG-CG iteration's census on this rank against the model:
    windows around solves of CENSUS_ITS iterations of `argv` (an MG-CG
    solver built for each) on `b`, their difference against
    scaling.mgcg_iteration_model(rank=r) record for record; the largest
    gather of the longer window against the field where the replicated
    tail starts; rank 0's census by level. Every rank's verdict is
    gathered."""
    pgrid, rank = g.pgrid, g.mesh.rank
    windows, cfg = [], None
    for its in CENSUS_ITS:
        s = PoissonSolver(shape, length, options=Options(list(argv) + ["-ksp_max_it", str(its)]),
                          dtype=dtype, device=DEVICE, shard=pgrid)
        bb = b.to(dtype)
        dist.barrier()
        with census.recording() as rec:
            res = s.solve(bb)
        if int(res.iterations) != its:
            raise AssertionError(f"census window: {int(res.iterations)} iterations, "
                                 f"asked for {its}")
        windows.append(rec)
        cfg = s._solver.M.config
        del s, bb, res
    one = census.subtract(windows[1], windows[0])
    esize = torch.tensor([], dtype=dtype).element_size()
    model = scaling.mgcg_iteration_model(shape, pgrid, cfg, itemsize=esize, rank=rank)
    got, want = collections.Counter(one), collections.Counter(model.records)
    diff = ([str(c) for c in (got - want).elements()][:6],
            [str(c) for c in (want - got).elements()][:6])
    if any(nd % p for nd, p in zip(shape, pgrid)):
        bound = esize * math.prod(pgrid) * math.prod(-(-nd // p) for nd, p in zip(shape, pgrid))
    else:
        field = next((sh for sh, d in model.levels if not d), model.levels[-1][0])
        bound = esize * math.prod(field)
    msgs = collections.Counter(census.exchange_messages(windows[1]))
    msgs.subtract(census.exchange_messages(windows[0]))
    verdict = {"equal": got == want, "diff": diff,
               "max_gather": census.max_gather_bytes(windows[1]), "gather_bound": bound}
    by_rank = [None] * g.mesh.size
    dist.all_gather_object(by_rank, verdict)
    return {"by_rank": by_rank, "config": dataclasses.asdict(cfg),
            "by_shape": [[list(sh), v.get("exchange", {}).get("count", 0),
                          v.get("face", {}).get("count", 0), v.get("face", {}).get("bytes", 0)]
                         for sh, v in census.census_by_shape(one).items()],
            "messages": [[list(sh), m, big, k] for (sh, m, big), k in msgs.items() if k],
            "model": {"permute_count": model.permute_count,
                      "permute_bytes": model.permute_bytes,
                      "exchange_count": model.exchange_count,
                      "allreduce_count": model.allreduce_count,
                      "gather_bytes": model.gather_bytes}}


def weak_case(pgrid, halo, dist) -> dict:
    """The weak-scaling rung: WEAK_SHAPE f32 on `pgrid` (a 512^3 block a
    rank, the box WEAK_LENGTH), MG-CG to rtol 1e-6 with the default cycle, b = A u for u
    uniform (-1, 1) drawn on each rank's card (seed WEAK_SEED + rank): the
    first solve's iterations and true residual, three warm solves (the
    slowest rank's median), and one iteration's census."""
    dtype = torch.float32
    solver = PoissonSolver(WEAK_SHAPE, WEAK_LENGTH, options=Options(WEAK_ARGV), dtype=dtype,
                           device=DEVICE, shard=pgrid)
    g = solver.grid
    gen = torch.Generator(device=g.device)
    gen.manual_seed(WEAK_SEED + g.mesh.rank)
    u = torch.rand(g.local_shape, generator=gen, device=g.device, dtype=dtype) * 2.0 - 1.0
    b = solver.rhs_for(u)
    del u
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    its, reason = int(res.iterations), int(res.reason)
    rel = solver.residual_norm(res.x, b)
    finite = bool(torch.isfinite(res.x).all())
    del res
    walls = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        walls.append(float(halo.allreduce_max(torch.tensor(
            [(time.perf_counter() - t0) * 1e3], dtype=torch.float64, device=g.device),
            g.mesh)))
    cen = census_iteration(WEAK_SHAPE, dtype, WEAK_ARGV, b, g, dist, WEAK_LENGTH)
    del solver, b
    torch.cuda.empty_cache()
    return {"its": its, "reason": reason, "rel": rel, "finite": finite,
            "first_ms": first_ms, "walls": walls, "warm_ms": statistics.median(walls),
            "local_shape": list(g.local_shape), "census": cen}


def checkpoint_checks(solver, b, ck, full, total, halo) -> dict:
    """After the counted solve_checkpointed of a "ckpt" case: a run killed
    after chunk 0 and resumed (the saved count on every rank, the resumed
    total and x against the uninterrupted run's, bit for bit), then the
    killed checkpoint over a b one ulp away on rank 1 alone (every rank
    must start fresh: its first monitored norm is ||b||)."""
    g, A = solver.grid, solver.A
    M = mg.make_mg_preconditioner(g.n, g.deltas, mg.MGConfig(), dtype=b.dtype,
                                  device=g.device, grid=g)
    kw = dict(M=M, rtol=1e-6, max_it=500, every=CKPT_EVERY, grid=g)
    killed = os.path.join(ck, "killed")

    def kill(chunk, result):
        raise Killed

    try:
        checkpoint.solve_with_checkpoints(A, b, killed, on_chunk=kill, **kw)
        raise AssertionError("the chunk hook did not stop the run")
    except Killed:
        pass
    saved = checkpoint.load(checkpoint.checkpoint_path(killed, g), device="cpu")
    saved_its = halo.allreduce_max(torch.tensor(
        [int(saved["iterations"]), -int(saved["iterations"])], dtype=torch.float64,
        device=g.device), g.mesh).tolist()
    resumed, total_r = solver.solve_checkpointed(b, killed, rtol=1e-6, every=CKPT_EVERY)
    diff = float(halo.allreduce_max((resumed.x - full.x).abs().max().double().reshape(1),
                                    g.mesh))
    norm = lambda v: math.sqrt(float(A.allreduce(torch.sum(v.double() ** 2).reshape(1))))
    first = []
    on = lambda c, r: first.append(float(r.history[0])) if c == 0 else None
    b2 = b.clone()
    if g.mesh.rank == 1:
        flat = b2.view(-1)
        flat[0] = torch.nextafter(flat[0], torch.tensor(math.inf, dtype=b.dtype,
                                                        device=b.device))
    _, total_f = checkpoint.solve_with_checkpoints(A, b2, killed, on_chunk=on, **kw)
    _, total_0 = checkpoint.solve_with_checkpoints(A, b2, os.path.join(ck, "fresh"), **kw)
    return {"saved_its": [saved_its[0], -saved_its[1]], "resumed_total": total_r,
            "resumed_diff": diff, "foreign_r0": first[0] / norm(b2),
            "foreign_total": total_f, "fresh_total": total_0}


def pencil_u(case, grid, solver):
    """The case's u: the smooth field of the JAX package's compact Krylov
    test for order 6, a seeded uniform one for order 2 (the same on any
    process grid)."""
    _, _, n, dtype_name, order, _, _, _ = case
    if order == 6:
        return smooth_u(Grid3D(tuple(n), device=DEVICE), getattr(torch, dtype_name))
    return solver.random_solution(4)


def pencil_solver(case, shard=False):
    _, pgrid, n, dtype_name, order, argv, rtol, _ = case
    opts = Options(list(argv) + ["-ksp_rtol", str(rtol), "-ksp_max_it", "300"])
    return PoissonSolver(tuple(n), options=opts, dtype=getattr(torch, dtype_name),
                         device=DEVICE, order=order, shard=pgrid if shard else False)


def _pencil_reference(case) -> dict:
    """The one-rank solve of a path (n) case on the card: iterations,
    relative residual and warm wall."""
    solver = pencil_solver(case)
    u = pencil_u(case, solver.grid, solver)
    b = solver.rhs_for(u)
    res = solver.solve(b)
    out = {"its": int(res.iterations), "rel": solver.residual_norm(res.x, b),
           "wall_ms": warm_ms({"one rank": lambda: solver.solve(b)})["one rank"],
           **warm_ms({"lapl_ms": lambda: solver.A(u),
                      "fft_ms": lambda: solver.A.direct_solve(u)}, reps=5)}
    del solver, u, b, res
    torch.cuda.empty_cache()
    return out


def pencil_worker_case(case, halo, dist) -> dict:
    """One path (n) case on this rank: the distributed compact Laplacian
    gathered against the one-rank K15 Laplacian of the same u (order 6),
    the pencil counters of one operator application and one direct solve
    alone, then the counted run (counters set to 0 before rhs_for + solve
    + residual_norm, read after) and the warm walls."""
    label, pgrid, n, dtype_name, order, argv, rtol, _ = case
    solver = pencil_solver(case, shard=True)
    g, A = solver.grid, solver.A
    full = pencil_u(case, g, solver)
    u = g.shard(full) if order == 6 else full
    out = {}
    if order == 6:
        one = cp.lapl(full, g.deltas)
        d = g.unshard(A(u)).double() - one.double()
        out["lapl_max_diff"] = float(d.abs().max())
        out["lapl_rel_rms"] = float(d.norm() / one.double().norm())
        del one, d
    del full
    counted = lambda: [halo.COUNTS[k] for k in ("alltoalls", "alltoall_bytes", "gathers")]
    halo.reset_counts()
    A(u)
    out["lapl_counts"] = counted()
    halo.reset_counts()
    A.direct_solve(u)
    out["fft_counts"] = counted()
    out["route"] = fft.fft_route(g.n, g.pgrid)
    reps = 5 if halo.transport(u) == "nccl" else 1
    out["lapl_ms"] = slowest_ms(lambda: A(u), g, halo, dist, reps)
    out["fft_ms"] = slowest_ms(lambda: A.direct_solve(u), g, halo, dist, reps)
    out["pencil_ok"] = pencil_ok(g.n, g.pgrid)
    dist.barrier()
    sc.reset_launches()
    halo.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = solver.rhs_for(u)
    res = solver.solve(b)
    rel = solver.residual_norm(res.x, b)
    torch.cuda.synchronize()
    out["first_ms"] = (time.perf_counter() - t0) * 1e3
    mine = {k: v for k, v in sc.LAUNCHES.items() if v}
    every = [None] * g.mesh.size
    dist.all_gather_object(every, mine)
    out["launches_by_rank"] = every
    out["halo_rank0"] = dict(halo.COUNTS)
    walls = []
    for _ in range(3 if halo.transport(b) == "nccl" else 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        walls.append(halo.allreduce_max(torch.tensor(
            [(time.perf_counter() - t0) * 1e3], dtype=torch.float64,
            device=g.device), g.mesh))
    out.update({
        "its": int(res.iterations), "rel": rel, "reason": int(res.reason),
        "shape": list(res.x.shape), "local_shape": list(g.local_shape),
        "finite": bool(torch.isfinite(res.x).all()), "transport": halo.transport(b),
        "warm_ms": statistics.median(float(w) for w in walls), "warm_reps": len(walls)})
    del solver, u, b, res
    torch.cuda.empty_cache()
    return out


def slowest_ms(fn, g, halo, dist, reps: int) -> float:
    """The slowest rank's median wall (ms) of `fn` over `reps` warm calls,
    each started together (a barrier) and ended by a synchronise."""
    walls = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(halo.allreduce_max(torch.tensor([statistics.median(walls)],
                                                 dtype=torch.float64, device=g.device), g.mesh))


def pencil_window(case, its: int, esize: int) -> tuple[int, int]:
    """Rank 0's all-to-alls and bytes over rhs_for + solve + residual_norm:
    every compact Laplacian (rhs_for, residual_norm, one a Krylov
    iteration; -ksp_type fft's residual) and every FFT solve (-ksp_type
    fft's one; -pc_type fft's one at the start and one an iteration)."""
    label, pgrid, n, dtype_name, order, argv, rtol, _ = case
    route = fft.fft_route(tuple(n), pgrid)
    lapl = (pencil_bytes_model(n, pgrid, esize, "lapl" if pencil_ok(tuple(n), pgrid)
                               else "gather") if order == 6 else (0, 0))
    solve = pencil_bytes_model(n, pgrid, esize, route)
    if "fft" in argv and argv[argv.index("-ksp_type") + 1] == "fft":
        nl, nf = 3, 1
    else:
        nl, nf = its + 2, (its + 1 if "-pc_type" in argv and
                           argv[argv.index("-pc_type") + 1] == "fft" else 0)
    return (nl * lapl[0] + nf * solve[0], nl * lapl[1] + nf * solve[1])


def _check_pencil_case(case, ref, r, backend, smi, totals) -> None:
    label, pgrid, n, dtype_name, order, argv, rtol, expect = case
    esize = 4 if dtype_name == "float32" else 8
    eps = float(torch.finfo(getattr(torch, dtype_name)).eps)
    route = r["route"]
    lapl_model = (pencil_bytes_model(n, pgrid, esize, "lapl" if r["pencil_ok"] else "gather")
                  if order == 6 else (0, 0))
    fft_model = pencil_bytes_model(n, pgrid, esize, route)
    window = pencil_window(case, r["its"], esize)
    fft_only = "fft" in argv and argv[argv.index("-ksp_type") + 1] == "fft"
    problems = []
    if order == 6 and not r["lapl_rel_rms"] <= 50 * eps:
        problems.append(f"the distributed Laplacian is {r['lapl_rel_rms']:.3e} (relative "
                        f"RMS) from one rank's K15 Laplacian, over 50 eps")
    if r["its"] != ref["its"] or (expect is not None and r["its"] != expect):
        problems.append(f"{r['its']} iterations, one rank {ref['its']}, expected {expect}")
    if fft_only:
        if not r["rel"] <= 2.0 * ref["rel"]:
            problems.append(f"relative residual {r['rel']:.3e} over twice one rank's "
                            f"{ref['rel']:.3e}")
    elif not r["rel"] <= 1.01 * rtol or r["reason"] <= 0:
        problems.append(f"relative residual {r['rel']:.3e}, reason {r['reason']}")
    if r["shape"] != r["local_shape"] or not r["finite"]:
        problems.append(f"bad solution block {r['shape']} (finite {r['finite']})")
    if order == 6 and tuple(r["lapl_counts"][:2]) != lapl_model:
        problems.append(f"Laplacian all-to-alls {r['lapl_counts'][:2]}, model {lapl_model}")
    if tuple(r["fft_counts"][:2]) != fft_model:
        problems.append(f"FFT solve all-to-alls {r['fft_counts'][:2]}, model {fft_model}")
    got_w = (r["halo_rank0"]["alltoalls"], r["halo_rank0"]["alltoall_bytes"])
    if got_w != window:
        problems.append(f"window all-to-alls {got_w}, model {window}")
    if order == 6:
        idle = [(rank, k) for rank, lc in enumerate(r["launches_by_rank"])
                for k in LAPL_KEYS if not lc.get(k)]
        if idle:
            problems.append(f"K15 not launched: {idle}")
    if problems:
        raise AssertionError(f"path (n) {label} over {backend}: " + "; ".join(problems))
    k15 = {k: [lc.get(k, 0) for lc in r["launches_by_rank"]] for k in LAPL_KEYS}
    print(f"  {label} over {backend} ({r['transport']}), FFT route {route}: "
          f"{r['its']} iterations (one rank {ref['its']}), relative residual "
          f"{r['rel']:.3e} (one rank {ref['rel']:.3e})", flush=True)
    if order == 6:
        print(f"  the distributed compact Laplacian against one rank's K15 Laplacian: "
              f"max|diff| {r['lapl_max_diff']:.3e}, relative RMS {r['lapl_rel_rms']:.3e} "
              f"(gate 50 eps = {50 * eps:.3e}); all-to-alls, bytes, gathers of one: "
              f"{r['lapl_counts']} (model {lapl_model})", flush=True)
    print(f"  one FFT solve: all-to-alls, bytes, gathers {r['fft_counts']} (model "
          f"{fft_model}); rhs_for + solve + residual_norm: {got_w} (model {window}); "
          f"rank 0 counters {r['halo_rank0']}", flush=True)
    print(f"  K15 launches by rank: {k15}", flush=True)
    print(f"  warm, the slowest rank (median of {5 if r['transport'] == 'nccl' else 1}): "
          + (f"a Laplacian {r['lapl_ms']:.2f} ms (one rank {ref['lapl_ms']:.2f}), "
             if order == 6 else "")
          + f"a direct solve {r['fft_ms']:.2f} ms (one rank {ref['fft_ms']:.2f}; median of "
          "5 on one rank, host clock around a synchronise)", flush=True)
    print(f"  walls: rhs_for + first solve + residual_norm {r['first_ms']:.1f} ms, warm "
          f"solve {r['warm_ms']:.2f} ms (the slowest rank, median of {r['warm_reps']}); "
          f"one-rank warm solve {ref['wall_ms']:.2f} ms ({smi})"
          + ("; ranks share one card, staged through the host: no speed figure"
             if r["transport"] == "gloo-staged" else ""), flush=True)
    if order == 6:
        DIST_K15[f"{label} over {backend}"] = k15
    for lc in r["launches_by_rank"]:
        for k, v in lc.items():
            totals[k] = totals.get(k, 0) + v


def dist_launches(key: str) -> dict:
    """The launches of kernel `key` by rank in each case of paths (m) and
    (n) that launched it: case -> [rank 0, rank 1, ...]."""
    return {label: by[key] for label, by in {**DIST_M, **DIST_K15}.items()
            if any(by.get(key, []))}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_group(label, pgrid, cases, refs, cases_n, backend, tmp, weak=False) -> dict:
    """Run one group of ranks to its end (each with a time limit); any rank
    that fails or hangs fails the phase, and every rank is stopped. Returns
    rank 0's results: path (m)'s cases under "m", path (n)'s under "n"."""
    world = int(np.prod(pgrid))
    spec = os.path.join(tmp, f"spec_{world}_{backend}.json")
    out = os.path.join(tmp, f"out_{world}_{backend}.json")
    with open(spec, "w") as fh:
        json.dump({"world": world, "pgrid": list(pgrid), "port": _free_port(),
                   "backend": backend, "cases": cases, "refs": refs,
                   "cases_n": cases_n, "weak": weak, "out": out, "tmp": tmp}, fh)
    here = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(tmp, f"rank{r}_{world}_{backend}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dist-worker", spec, str(r)], cwd=here,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.perf_counter() + DIST_TIMEOUT + 120.0
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad[:2]:
            logs[r].seek(0)
            print(f"  rank {r} of {label}:\n" + logs[r].read()[-4000:], flush=True)
        raise AssertionError(f"distributed {label} over {backend}: ranks {bad} failed")
    with open(out) as fh:
        return json.load(fh)


def dist_phase(smi: str, totals: dict, backends) -> None:
    """Phase 7: each group of DIST_GROUPS over each backend of `backends`
    (gloo: every rank on card 0, faces and transposes staged through
    pinned host buffers; nccl: one rank a card, groups of more ranks than
    cards skipped): path (m)'s cases, each against the one-rank solve of
    the parent, then in the same group path (n)'s (PENCIL_CASES)."""
    if "nccl" not in backends or torch.cuda.device_count() < math.prod(WEAK_PGRID):
        print(f"-- path (n) over nccl (the 512^3 cases), and the strong- and weak-scaling "
              f"predictions against measurement (four cards over NCCL): skipped, "
              f"{torch.cuda.device_count()} card(s)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for label, pgrid, cases in DIST_GROUPS:
            world = int(np.prod(pgrid))
            refs = None
            for backend in backends:
                if backend == "nccl" and world > torch.cuda.device_count():
                    print(f"-- paths (m) and (n) {label} over nccl: skipped, {world} "
                          f"ranks and {torch.cuda.device_count()} cards", flush=True)
                    continue
                if refs is None:
                    shared = {}
                    refs = [_dist_reference(c, tmp, i, shared) for i, c in enumerate(cases)]
                cases_n = PENCIL_CASES.get((pgrid, backend), [])
                refs_n = [_pencil_reference(c) for c in cases_n]
                print(f"-- path (m) distributed Krylov solves {label}, {world} ranks over "
                      f"{backend}" + (f"; then path (n), {len(cases_n)} cases of order 6 "
                                      "and the FFT" if cases_n else ""), flush=True)
                t0 = time.perf_counter()
                # the weak-scaling rung rides the (2,2,1) group over NCCL
                weak = backend == "nccl" and pgrid == WEAK_PGRID
                results = _spawn_group(label, pgrid, cases, refs, cases_n, backend, tmp,
                                       weak)
                print(f"  group wall {time.perf_counter() - t0:.1f} s (spawn, imports "
                      "and all cases)", flush=True)
                cards = smi.replace("\n", "; ")     # one line a card
                for idx, (case, ref, r) in enumerate(zip(cases, refs, results["m"])):
                    _check_dist_case(label, pgrid, case, ref, r, backend, cards, totals)
                    check_census(label, pgrid, case, r, cases[r["census_of"]], cards)
                if weak:
                    scaling_report(pgrid, cases, refs, results, cards)
                if cases_n:
                    print(f"-- path (n) order 6 and the FFT across ranks over {backend}",
                          flush=True)
                for case, ref, r in zip(cases_n, refs_n, results["n"]):
                    _check_pencil_case(case, ref, r, backend, cards, totals)


def _check_dist_case(label, pgrid, case, ref, r, backend, smi, totals) -> None:
    n, dtype_name, rtol, extra, expect_its, required, kind = case
    argv = dist_argv(case)
    method = SolverOptions.from_options(Options(argv)).ksp_type if kind == "solve" else kind
    idle = [k for k in required if r["launches_min"].get(k, 0) == 0]
    problems = []
    if idle:
        problems.append(f"kernels not launched on every rank: {idle}")
    if r["its"] != ref["its"] or (expect_its is not None and r["its"] != expect_its):
        problems.append(f"{r['its']} iterations, expected {expect_its} "
                        f"(one rank: {ref['its']})")
    # the true residual's limit (PERF.md section 2): GMRES monitors ||M r||
    limit = {"gmres": 10 * rtol, "refine": rtol}.get(method, 1.01 * rtol)
    if not r["rel"] <= limit or r["reason"] <= 0:
        problems.append(f"relative residual {r['rel']:.3e} (limit {limit:.3e}), "
                        f"reason {r['reason']}")
    if r["shape"] != r["local_shape"] or not r["finite"]:
        problems.append(f"bad solution block {r['shape']} (finite {r['finite']})")
    if not r["x_rel_diff"] <= 100 * max(rtol, X_RTOL_FLOOR.get(kind, 0.0)):
        problems.append(f"x differs from the one-rank x by {r['x_rel_diff']:.3e}")
    if dtype_name == "float64" and not r["matvec_rel"] <= 1e-13:
        problems.append(f"matvec {r['matvec_rel']:.3e} from the one-rank K1")
    if r["dofs"] != dof_distribution((n,) * 3, pgrid):
        problems.append(f"dof counts {r['dofs']}")
    model = None
    if kind == "solve":
        # the face bytes the shapes give (V(1,1) at 512^3 with its bf16
        # pre-smooth, float32 under GMRES and PIPECG; V(3,3) at 64^3),
        # against the counters
        sweeps = 1 if n >= 512 else (2 if n >= 256 else 3)
        esize = 4 if dtype_name == "float32" else 8
        pre = (2 if n >= 512 and esize == 4 and method not in ("gmres", "pipecg")
               else esize)
        mv, v = exchange_bytes_model(n, pgrid, esize, pre, sweeps, sweeps,
                                     "jacobi" if "jacobi" in extra else "sor")
        nmv, nv = krylov_work(argv, r["its"])
        model = (mv, v if nv else 0, nmv * mv + nv * v)
        if (r["mv_bytes"], r["v_bytes"], r["halo_rank0"]["bytes"]) != model:
            problems.append(f"face bytes: matvec {r['mv_bytes']}, V-cycle {r['v_bytes']}, "
                            f"window {r['halo_rank0']['bytes']}; the shapes give {model}")
    if kind == "logview":
        events = log_view_events(r["lines"])
        if events != [tuple(e) for e in ref["events"]]:
            problems.append(f"-log_view events {events}, one rank's {ref['events']}")
        if r["printed_by_rank"] != [len(r["lines"])] + [0] * (len(r["printed_by_rank"]) - 1):
            problems.append(f"-log_view lines printed by rank: {r['printed_by_rank']}")
        gdofs = gdofs_check(r["lines"], n)
        if gdofs is not None:
            problems.append(gdofs)
    if kind == "ckpt":
        if not (r["saved_its"] == [CKPT_EVERY, CKPT_EVERY] and r["resumed_diff"] == 0.0
                and r["resumed_total"] == r["its"]):
            problems.append(f"killed and resumed: saved {r['saved_its']} (max, min over "
                            f"ranks), total {r['resumed_total']} against {r['its']}, "
                            f"max|dx| {r['resumed_diff']:.3e}")
        if not (abs(r["foreign_r0"] - 1.0) <= 1e-5
                and r["foreign_total"] == r["fresh_total"]):
            problems.append(f"a b one ulp away on rank 1 resumed: first norm "
                            f"{r['foreign_r0']:.6e} of ||b||, total {r['foreign_total']} "
                            f"(fresh {r['fresh_total']})")
    if problems:
        raise AssertionError(f"distributed {label} {kind} {' '.join(extra)} over {backend}: "
                             + "; ".join(problems))
    what = {"solve": f"{method} {' '.join(extra)}", "refine": "solve_refined",
            "ckpt": f"solve_checkpointed every {CKPT_EVERY}",
            "logview": "CG + MG with -log_view"}[kind]
    print(f"  {n}^3 {dtype_name} {what} over {r['backend']} ({r['route']}): "
          f"{r['its']} iterations (one rank {ref['its']}), relative residual "
          f"{r['rel']:.3e} (one rank {ref['rel']:.3e}); DoF {r['dofs']}; matvec vs one-rank "
          f"K1 {r['matvec_rel']:.3e}; x vs one-rank x {r['x_rel_diff']:.3e} (errors vs u: "
          f"{r['x_err_exact']:.3e})", flush=True)
    print(f"  launches, rank 0: {r['launches_rank0']}", flush=True)
    print(f"  launches, sum over ranks: {r['launches_sum']}", flush=True)
    print(f"  exchanges and all-reduces, rank 0: {r['halo_rank0']}; sum over ranks: "
          f"{r['halo_sum']}", flush=True)
    if model is not None:
        nmv, nv = krylov_work(argv, r["its"])
        print(f"  face bytes, rank 0: a matvec {model[0]}, a V-cycle {model[1]} (as the "
              f"shapes give them); rhs_for + solve + residual_norm {model[2]} = {nmv} "
              f"matvecs + {nv} V-cycles", flush=True)
    if kind == "logview":
        for ln in r["lines"]:
            print(f"  rank 0 | {ln}", flush=True)
        print(f"  -log_view lines printed by rank: {r['printed_by_rank']}; the one-rank "
              f"table's events {ref['events']}", flush=True)
        for ln in ref["lines"]:
            print(f"  one rank | {ln}", flush=True)
    if kind == "ckpt":
        print(f"  killed after chunk 0 (saved {r['saved_its'][0]} iterations on every rank) "
              f"and resumed: total {r['resumed_total']}, max|dx| {r['resumed_diff']:.1f} "
              f"against the uninterrupted run; a b one ulp away on rank 1: every rank "
              f"fresh (first norm {r['foreign_r0']:.9f} of ||b||, {r['foreign_total']} "
              f"iterations, a fresh run {r['fresh_total']})", flush=True)
    run = {"solve": "solve", "refine": "solve_refined", "ckpt": "solve_checkpointed",
           "logview": "solve"}[kind]
    print(f"  walls: rhs_for + first {run} + residual_norm {r['first_ms']:.1f} ms, warm "
          f"{run} {r['warm_ms']:.2f} ms (the slowest rank, median of {r['warm_reps']}); "
          f"one-rank warm {run} {ref['wall_ms']:.2f} ms ({smi})"
          + ("; ranks share one card and stage every face through the host: no "
             "speed figure" if r["route"] == "gloo-staged" else ""), flush=True)
    DIST_M[f"{pgrid} {n}^3 {dtype_name} {what} over {backend}"] = {
        k: [lc.get(k, 0) for lc in r["launches_by_rank"]] for k in r["launches_sum"]}
    for k, v in r["launches_sum"].items():
        totals[k] = totals.get(k, 0) + v


def check_census(label, pgrid, case, r, held_by, smi) -> None:
    """One MG-CG iteration's census against scaling.mgcg_iteration_model
    on every rank (the case's own, or the MG-CG solve that holds it), the
    largest gather against the replicated tail's field; for the 512^3
    (2,2,1) CG case the census by level."""
    n, dtype_name, rtol, extra, _, _, kind = case
    if "census" not in r:
        print(f"  census: held by the MG-CG census of case {r['census_of']} (the same "
              f"grid, {census_key(held_by)}: size, dtype, MG options)", flush=True)
        return
    c = r["census"]
    bad = [rk for rk, v in enumerate(c["by_rank"]) if not v["equal"]]
    over = [rk for rk, v in enumerate(c["by_rank"]) if v["max_gather"] > v["gather_bound"]]
    if bad or over:
        raise AssertionError(
            f"distributed {label} {kind} {' '.join(extra)}: one iteration's census differs "
            f"from the model on ranks {bad} (rank {bad[0] if bad else '-'}: census has "
            f"{c['by_rank'][bad[0]]['diff'][0] if bad else []}, the model "
            f"{c['by_rank'][bad[0]]['diff'][1] if bad else []}); gathers over the "
            f"replicated field on ranks {over}")
    m = c["model"]
    print(f"  census of one MG-CG iteration ({CENSUS_ITS[1]} iterations less "
          f"{CENSUS_ITS[0]}) equals mgcg_iteration_model on all {len(c['by_rank'])} ranks: "
          f"rank 0 {m['exchange_count']} exchanges, {m['permute_count']} face messages, "
          f"{m['permute_bytes']} B, {m['allreduce_count']} all-reduces, gathers "
          f"{m['gather_bytes']} B; largest gather of the solve {c['by_rank'][0]['max_gather']}"
          f" B (the replicated field: {c['by_rank'][0]['gather_bound']} B)", flush=True)
    if not (n == 512 and tuple(pgrid) == (2, 2, 1) and kind == "solve" and not extra):
        return
    print(f"  census by level, rank 0, one iteration of {n}^3 {dtype_name} MG-CG on "
          f"{tuple(pgrid)} ({smi}):", flush=True)
    print("    block shape      exchanges  face messages       bytes  mean B a message",
          flush=True)
    for sh, ex, faces, nbytes in c["by_shape"]:
        print(f"    {str(tuple(sh)):16s} {ex:9d} {faces:14d} {nbytes:11d} "
              f"{nbytes / max(faces, 1):17.1f}", flush=True)
    total = sum(k for *_, k in c["messages"])
    small = sum(k for _, _, big, k in c["messages"] if big < SMALL_MESSAGE)
    print(f"    {total} exchanges an iteration (1 the matvec's), {small} of them with every "
          f"message under {SMALL_MESSAGE // 1024} KiB", flush=True)


def scaling_report(pgrid, cases, refs, results, smi) -> None:
    """The strong- and weak-scaling predictions (scaling.predict_efficiency
    on this card's LINK_BW, fed the census-checked model) beside the
    measured efficiencies over NCCL: strong on the 512^3 f32 MG-CG case
    (compute an iteration: one card's warm wall / iterations / ranks;
    measured: one card's wall / (ranks x the slowest rank's wall)); weak on
    WEAK_SHAPE (compute: one card's 512^3 wall / its iterations;
    measured: one card's 512^3 wall / the four-card wall). Checks the weak
    solve: finite, converged, true residual <= 1.01 rtol."""
    card = torch.cuda.get_device_name(0)
    world = math.prod(pgrid)
    idx = next(i for i, c in enumerate(cases)
               if c[0] == 512 and c[1] == "float32" and c[6] == "solve" and not c[3])
    case, ref, r = cases[idx], refs[idx], results["m"][idx]
    cfg = mg.MGConfig(**r["census"]["config"])
    n3 = (512,) * 3
    t_it = ref["wall_ms"] / 1e3 / ref["its"]
    strong = scaling.predict_efficiency(n3, pgrid, t_it / world, card, cfg=cfg, itemsize=4)
    measured = ref["wall_ms"] / (world * r["warm_ms"])
    print(f"-- strong scaling, 512^3 f32 MG-CG on {tuple(pgrid)} over NCCL ({smi}): "
          f"predicted {strong.efficiency_overlapped!r} overlapped, "
          f"{strong.efficiency_serial!r} serial (compute {strong.compute_s * 1e3:.4f} ms "
          f"an iteration = one card's {ref['wall_ms']:.2f} ms / {ref['its']} its / {world}, "
          f"wire {strong.comm_s * 1e3:.5f} ms, gather {strong.gather_s * 1e3:.7f} ms at "
          f"{scaling.link_bandwidth(card):.3g} B/s); measured {measured!r} = "
          f"{ref['wall_ms']:.2f} / ({world} x {r['warm_ms']:.2f} ms, the slowest rank's "
          f"warm solve)", flush=True)
    w = results["weak"]
    limit = 1.01 * 1e-6
    if not (w["finite"] and w["reason"] > 0 and w["rel"] <= limit):
        raise AssertionError(f"weak-scaling solve {WEAK_SHAPE}: {w['its']} iterations, "
                             f"reason {w['reason']}, true residual {w['rel']:.3e} "
                             f"(limit {limit:.3e}), finite {w['finite']}")
    wc = w["census"]
    bad = [rk for rk, v in enumerate(wc["by_rank"]) if not v["equal"]]
    if bad:
        raise AssertionError(f"weak-scaling solve: one iteration's census differs from the "
                             f"model on ranks {bad}: {wc['by_rank'][bad[0]]['diff']}")
    wcfg = mg.MGConfig(**wc["config"])
    weak = scaling.predict_efficiency(WEAK_SHAPE, pgrid, t_it, card, cfg=wcfg, itemsize=4)
    measured_w = ref["wall_ms"] / w["warm_ms"]
    per_it = (ref["wall_ms"] / ref["its"]) / (w["warm_ms"] / w["its"])
    print(f"-- weak scaling, {WEAK_SHAPE} f32 MG-CG on {tuple(pgrid)} over NCCL (box "
          f"{WEAK_LENGTH}, a "
          f"{tuple(w['local_shape'])} block a card; {smi}): {w['its']} iterations, true "
          f"relative residual {w['rel']:.3e}, first solve {w['first_ms']:.1f} ms, warm "
          f"{w['warm_ms']:.2f} ms (the slowest rank, median of {len(w['walls'])}: "
          f"{[round(x, 2) for x in w['walls']]}); census equals the model on every rank "
          f"({wc['model']['exchange_count']} exchanges, {wc['model']['permute_bytes']} B an "
          f"iteration on rank 0)", flush=True)
    print(f"   predicted {weak.efficiency_overlapped!r} overlapped, "
          f"{weak.efficiency_serial!r} serial (compute {weak.compute_s * 1e3:.4f} ms an "
          f"iteration = one card's 512^3 {ref['wall_ms']:.2f} ms / {ref['its']} its, wire "
          f"{weak.comm_s * 1e3:.5f} ms, gather {weak.gather_s * 1e3:.7f} ms); measured "
          f"{measured_w!r} = {ref['wall_ms']:.2f} / {w['warm_ms']:.2f} ms "
          f"({per_it!r} an iteration)", flush=True)


def gdofs_check(lines, n: int):
    """None when the table's GDoF/s is the global DoF count's (n^3 times
    the iterations over the solve's seconds, to the printed digits), else
    what is wrong."""
    row = next((ln for ln in lines if ln.startswith("log_view:   solve")), None)
    if row is None:
        return "no solve row in the -log_view table"
    secs = float(row.split()[3])
    its = int(row.split("(")[1].split()[0])
    got = float(row.split("ms/it, ")[1].split()[0])
    ndof = int(row.split(" of ")[1].split()[0])
    want = n ** 3 * max(its, 1) / secs / 1e9
    if ndof != n ** 3 or abs(got - want) > 0.006 + 0.01 * want:
        return (f"-log_view GDoF/s {got} of {ndof} DoF; the global DoF count "
                f"{n ** 3} gives {want:.2f}")
    return None


def python_halo_bytes(shape, pgrid, width: int, itemsize: int) -> list:
    """native.halo_bytes from the Python planner's boxes: both faces of
    the largest owned box along each split axis."""
    big = [max(c[d] for _, c in owned_boxes(shape, pgrid).values()) for d in range(3)]
    return [2 * width * itemsize * math.prod(big[k] for k in range(3) if k != d)
            if pgrid[d] > 1 else 0 for d in range(3)]


def native_planner_phase() -> None:
    """Build the port's native library (decomp.cpp, options.cpp) here and
    hold its planner to the Python one on every decomposition of paths
    (m) and (n) and the weak-scaling case: the process grid decompose_3d
    picks for the rank count, every owned box, the DoF counts and the
    halo bytes (f32 and f64)."""
    t0 = time.perf_counter()
    path = native.build()
    print(f"  {path.name}: built in "
          f"{native.build_seconds if native.build_seconds is not None else 'cached'} s "
          f"({time.perf_counter() - t0:.2f} s with the hash)", flush=True)
    decomps = {(pgrid, (n,) * 3) for _, pgrid, cases in DIST_GROUPS for n, *_ in cases}
    decomps |= {(c[1], tuple(c[2])) for cases in PENCIL_CASES.values() for c in cases}
    decomps.add((WEAK_PGRID, WEAK_SHAPE))
    bad = []
    for pgrid, shape in sorted(decomps):
        world = math.prod(pgrid)
        if native.decompose_3d(world, shape) != python_decompose_3d(world, shape):
            bad.append(f"decompose_3d({world}, {shape})")
        py = owned_boxes(shape, pgrid)
        for coord in itertools.product(*(range(p) for p in pgrid)):
            if native.owned_box(shape, pgrid, coord) != py[coord]:
                bad.append(f"owned_box({shape}, {pgrid}, {coord})")
        if native.dof_distribution(shape, pgrid) != dof_distribution(shape, pgrid):
            bad.append(f"dof_distribution({shape}, {pgrid})")
        for e in (4, 8):
            if native.halo_bytes(shape, pgrid, 1, e) != python_halo_bytes(shape, pgrid, 1, e):
                bad.append(f"halo_bytes({shape}, {pgrid}, 1, {e})")
    if bad:
        raise AssertionError(f"the native planner differs from the Python one: {bad}")
    print(f"  the native planner equals the Python one on {len(decomps)} decompositions "
          f"(decompose_3d, every owned box, DoF counts, halo bytes f32 and f64): "
          f"{sorted(decomps)}", flush=True)


def native_options_phase() -> None:
    """Hold the native options database to config.Options on every argv
    list this process parsed (ARGVS)."""
    seen = {tuple(a) for a in ARGVS}
    bad = [a for a in sorted(seen)
           if native.NativeOptions(list(a)).as_dict() != _Options(list(a)).as_dict()]
    if bad:
        raise AssertionError(f"NativeOptions differs from config.Options on {bad}")
    print(f"  NativeOptions equals config.Options on all {len(seen)} distinct argv lists "
          f"this run parsed ({len(ARGVS)} parses)", flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--dist-worker"]:
        return dist_worker(args[1], int(args[2]))
    dist_only = args == ["--dist-only"]
    if args and not dist_only:
        raise SystemExit(f"chip_smoke: unknown arguments {args} "
                         "(none, or --dist-only)")
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    t_start = time.perf_counter()

    phase("build")
    t0 = time.perf_counter()
    path = _build.load()._name
    print(f"  {path}: load {time.perf_counter() - t0:.1f} s, nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'} s")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    phase("native planner")
    native_planner_phase()

    if dist_only:
        # phase 7 alone: over NCCL, one rank a card, where there are cards
        # for it, against the one-card solve
        phase("distributed MG-CG, order 6 and the FFT (alone)")
        dist_phase(smi, {}, ["nccl"] if torch.cuda.device_count() >= 2 else ["gloo"])
        phase("native options database")
        native_options_phase()
        print(f"  chip_smoke wall {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    phase("kernels against plain versions")
    stats = check_kernels()
    check_dist_blocks(stats)
    check_colour_update(stats)
    check_pencil_blocks(stats)

    phase("the spectral symbol multiply against its plain version")
    check_spectral(stats)

    phase("the one-pass sweep against two K11 launches")
    sweep_pairs(smi)

    phase("banded-matrix transfers against the roll form")
    check_contractions()

    phase("compact and tridiagonal kernels against plain versions")
    check_compact(stats)

    phase("K16's and K17's strip kernels: variants and long lines")
    strip_variants(stats, smi)
    check_long(stats)

    phase("paths")
    totals = {k: 0 for k in sc.LAUNCHES}
    f64, f32 = torch.float64, torch.float32
    cases_a = [(64, f64, 1e-8, [], 6), (256, f32, 1e-6, [], 5)]
    roll = ["-mg_transfers", "roll"]
    cases_ar = [(n, dt, rtol, roll, its) for n, dt, rtol, _, its in cases_a]
    cases_b = [(512, f32, 1e-6, [], 7)]
    cases_br = [(512, f32, 1e-6, roll, 7)]
    cases_c = [(256, f32, 1e-6, ["-mg_levels_pc_type", "jacobi"], None)]
    base = ["stencil7.apply", "stencil7.apply_dot", "rbsor.sweep"]
    runs_a = run_path("(a) fused legs, 64^3 f64 + 256^3 f32 + demo", cases_a,
                      base + ["rbsor.zero", "rbsor.zero_update", "rbsor.dots",
                              "xfer.restrict", "xfer.prolong_add"],
                      totals, demo=True)
    runs_ar = run_path("(a/r) roll transfers through the kernels", cases_ar,
                       base + ["stencil7.residual", "rbsor.zero_update"], totals)
    compare_paths(runs_a, cases_a, smi, runs_ar)
    profile_solve("(a) 256^3 f32", *runs_a[1][:2], smi)
    utils_on_card(runs_a[0], smi)
    del runs_a, runs_ar
    log_view_demo(smi)
    torch.cuda.empty_cache()
    runs_b = run_path("(b) 512^3 f32, bf16 pre-smooth", cases_b,
                      base + ["rbsor.zero_update.narrow", "rbsor.zero.bf16",
                              "rbsor.dots", "xfer.restrict.bf16u",
                              "xfer.prolong_add.bf16u"], totals)
    runs_br = run_path("(b/r) 512^3 f32, roll transfers", cases_br,
                       base + ["cgupd", "stencil7.residual",
                               "rbsor.zero.bf16"], totals)
    compare_paths(runs_b, cases_b, smi, runs_br)
    profile_solve("(b) 512^3 f32", *runs_b[0][:2], smi)
    del runs_b, runs_br
    torch.cuda.empty_cache()
    runs_c = run_path("(c) 256^3 f32, Jacobi smoother", cases_c,
                      ["stencil7.apply", "stencil7.apply_dot", "stencil7.jacobi",
                       "cgupd", "xfer.restrict", "xfer.prolong_add"], totals)
    compare_paths(runs_c, cases_c, smi)
    del runs_c
    run_path("(b/s) 512^3 f32, bf16 pre-smooths of Chebyshev, two-sweep "
             "Jacobi and two-sweep SOR",
             [(512, f32, 1e-6, ["-mg_levels_ksp_type", "chebyshev"], None),
              (512, f32, 1e-6, ["-mg_levels_pc_type", "jacobi",
                                "-mg_levels_ksp_max_it", "2"], None),
              (512, f32, 1e-6, ["-mg_levels_ksp_max_it", "2"], None)],
             ["stencil7.residual.bf16", "stencil7.jacobi.bf16", "rbsor.zero.bf16",
              "rbsor.sweep.bf16"], totals)
    torch.cuda.empty_cache()

    err32 = f32_operator_error(256)
    print(f"  compact Laplacian at 256^3, smooth u: f32 evaluation error "
          f"{err32:.3e} of ||A u|| (the floor of any f32 residual there)", flush=True)
    mgcg = ["-ksp_type", "cg", "-pc_type", "mg"]
    cases_d = [(64, f64, 1e-8, mgcg), (256, f32, 1e-3, mgcg), (48, f64, 1e-8, mgcg)]
    lapl_keys = list(LAPL_KEYS)
    runs_d = run_path("(d) order 6, CG + GMG", cases_d,
                      lapl_keys + ["rbsor.sweep", "xfer.restrict", "xfer.prolong_add"],
                      totals, runner=solve6_case, routes=("registers", "tile"))
    compare6(runs_d, cases_d, smi)
    profile_solve("(d) order 6 256^3 f32", *runs_d[1][:2], smi)
    del runs_d
    torch.cuda.empty_cache()
    fcg = ["-ksp_type", "fcg", "-pc_type", "fft"]
    cases_e = [(256, f32, 1e-3, fcg), (256, f64, 1e-8, fcg)]
    run_path("(e) -ksp_type fft at 512^3 f32, order 2 and 6",
             [(2, 512, f32, smi), (6, 512, f32, smi)],
             ["stencil7.apply", "spectral.sum", "spectral.compact"] + lapl_keys, totals,
             runner=fft_case)
    torch.cuda.empty_cache()
    runs_e = run_path("(e) order 6, FCG + -pc_type fft", cases_e,
                      lapl_keys + ["spectral.sum"], totals, runner=solve6_case)
    compare6(runs_e, cases_e, smi)
    del runs_e
    torch.cuda.empty_cache()
    runs_f = run_path("(f) the bench's periodic tridiagonal solve, 512^3 f32 and "
                      "64^3 f64", [(smi,), (smi, 64, f64)],
                      ["tridiag.pcr", "tridiag.thomas", "tridiag.babe"], totals,
                      runner=tridiag_path)
    tridiag_pairs(runs_f, smi)
    del runs_f
    torch.cuda.empty_cache()

    gm = ["-ksp_type", "gmres", "-gmres_restart", "30"]
    cases_g = [(64, f64, 1e-8, gm, 6), (512, f32, 1e-6, gm, None)]
    runs_g = run_path("(g) GMRES(30) + MG, 64^3 f64 + 512^3 f32, -pc_type none, "
                      "demo", cases_g,
                      ["stencil7.apply", "rbsor.zero", "rbsor.sweep",
                       "xfer.restrict", "xfer.prolong_add"], totals,
                      demo=gm + ["-pc_type", "mg"])
    b512 = runs_g[1][1]
    print(f"  gmres 512^3 f32: restart 30 resolved to {clamp_restart(30, b512)} "
          f"(basis {31 * b512.nbytes / 1e9:.1f} GB, budget half of "
          f"{torch.cuda.mem_get_info(b512.device)[1] / 2**30:.1f} GiB)", flush=True)
    del b512
    compare_paths(runs_g, cases_g, smi)
    del runs_g
    torch.cuda.empty_cache()
    gmres_bf16_case(smi)
    fgm = ["-ksp_type", "fgmres", "-gmres_restart", "30"]
    runs_fg = run_path("(g) FGMRES(30) + MG, 64^3 f64 + 512^3 f32 (bf16 pre-smooth), "
                       "the true residual", [(64, f64, 1e-8, fgm, None),
                                             (512, f32, 1e-6, fgm, None)],
                       ["stencil7.apply", "rbsor.zero.bf16", "rbsor.sweep",
                        "xfer.restrict", "xfer.prolong_add"], totals)
    inner = runs_fg[1][0]._solver
    if inner.M.resolved["pre_dtype"] != "bfloat16":
        raise AssertionError(f"fgmres 512^3 f32: pre-smooth {inner.M.resolved}")
    print("  fgmres 512^3 f32 -ksp_view: "
          + ksp.view(inner.opts, inner.shape, inner.M).replace("\n", "; "), flush=True)
    del runs_fg, inner
    torch.cuda.empty_cache()
    run_path("(g) GMRES(30) -pc_type none, 64^3 f64, 60 iterations (K2 in the "
             "Gram-Schmidt step)", [(smi,)], ["stencil7.apply", "stencil7.apply_dot"],
             totals, runner=gmres_none_case)
    cases_h = [(64, f64, 1e-8, ["-ksp_type", "pipecg"], 6),
               (256, f32, 1e-6, ["-ksp_type", "pipecg"], None),
               (256, f32, 1e-6, ["-ksp_type", "richardson"], None)]
    runs_h = run_path("(h) PIPECG + MG (64^3 f64, 256^3 f32), Richardson + MG "
                      "(256^3 f32)", cases_h,
                      ["stencil7.apply", "rbsor.zero", "rbsor.sweep",
                       "xfer.restrict", "xfer.prolong_add"], totals)
    compare_paths(runs_h, cases_h, smi)
    del runs_h
    torch.cuda.empty_cache()
    cases_i = [(256, f32, 1e-6, [], 5), (512, f32, 1e-6, [], 7),
               (512, f32, 1e-6, roll, 7)]
    runs_i = run_path("(i) deferred p-update (K12): 256^3, 512^3, 512^3 roll "
                      "transfers", cases_i,
                      ["stencil7.pupd_dot", "rbsor.zero_update", "cgupd",
                       "xfer.restrict.bf16u"], totals, runner=deferred_case)
    compare_deferred(runs_i, cases_i, smi)
    del runs_i
    torch.cuda.empty_cache()
    run_path("(j) solve_refined: 512^3 beside f64 MG-CG, 128^3 against the plain "
             "path", [(512, smi, False), (128, smi, True)],
             ["stencil7.apply", "rbsor.zero_update", "rbsor.zero_update.narrow",
              "xfer.restrict"], totals, runner=refine_case)
    torch.cuda.empty_cache()
    run_path("(k) solve_checkpointed, 256^3 f32, every 2", [(256, smi)],
             ["stencil7.apply", "rbsor.zero_update", "xfer.restrict"], totals,
             runner=checkpoint_case)
    cases_l = [(64, f64, 1e-8, mgcg), (256, f32, 1e-3, mgcg), (96, f32, 1e-3, mgcg)]
    runs_l = run_path("(l) order 6 through K17 (method=pallas), CG + GMG", cases_l,
                      ["tridiag.compact", "tridiag.dual", "tridiag.chain", "tridiag.sum",
                       "rbsor.sweep", "xfer.restrict"], totals, runner=solve6_thomas_case)
    compare6_thomas(runs_l, cases_l, smi)
    del runs_l
    torch.cuda.empty_cache()
    lapl_pairs(smi)

    phase("distributed MG-CG; order 6 and the FFT across ranks")
    dist_phase(smi, totals, ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else []))
    idle = [k for k in KERNELS if totals[k] == 0 and k not in OFF_PATH]
    if idle:
        raise AssertionError(f"kernels no path launched: {idle}")
    phase("native options database")
    native_options_phase()
    print(f"  chip_smoke wall so far {time.perf_counter() - t_start:.1f} s")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    unmeasured = [k for k in KERNELS if any(f not in stats[k] for f in keys)]
    if unmeasured:
        raise AssertionError(f"kernels without a time or a bound: {unmeasured}")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda",
         "source": f"poissbox_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": totals[key], **{k: stats[key][k] for k in keys},
         **({"dist_launches": dist_launches(key)} if dist_launches(key) else {})}
        for key, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
