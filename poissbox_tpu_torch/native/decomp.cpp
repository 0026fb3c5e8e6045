// Native grid-decomposition planner of the PyTorch port: the DMDA C-layer
// counterpart, a copy of the JAX package's planner with the same semantics.
//
// The reference delegates process-grid choice and owned-box queries to
// PETSc's native DMDA (reference src/poissbox.f90:191-200, DMDAGetCorners
// at :107). Given a rank count and a global grid this picks the
// communication-minimizing process grid, computes every rank's owned box,
// and sizes the halo-exchange messages. Exposed through a plain C ABI for
// ctypes (poissbox_tpu_torch/native/__init__.py); semantics are pinned by
// the pure-Python planner in poissbox_tpu_torch/parallel/decomp.py and
// tests/test_torch_native.py.
//
// Built at first use by poissbox_tpu_torch/native/__init__.py (g++, or
// $CXX) into poissbox_tpu_torch/_build/.

#include <cstdint>
#include <limits>

extern "C" {

// Choose (px, py, pz) for ndev ranks over grid (nx, ny, nz).
// Objective (mirrors DMDA's heuristic):
//   1. prefer decompositions dividing the grid exactly (every owned box
//      then has one shape),
//   2. minimize halo surface 2*(sx*sy*[pz>1] + sy*sz*[px>1] + sz*sx*[py>1]),
//   3. tie-break: smallest pz (keep the contiguous z axis whole), then py.
// Returns 0 on success, -1 if no valid decomposition exists.
int pb_decompose_3d(int64_t ndev, int64_t nx, int64_t ny, int64_t nz,
                    int64_t* px_out, int64_t* py_out, int64_t* pz_out) {
  if (ndev <= 0 || nx <= 0 || ny <= 0 || nz <= 0) return -1;
  bool found = false;
  bool best_exact = false;
  double best_surface = std::numeric_limits<double>::infinity();
  int64_t best_px = 0, best_py = 0, best_pz = 0;

  for (int64_t px = 1; px <= ndev; ++px) {
    if (ndev % px) continue;
    int64_t rest = ndev / px;
    for (int64_t py = 1; py <= rest; ++py) {
      if (rest % py) continue;
      int64_t pz = rest / py;
      if (px > nx || py > ny || pz > nz) continue;
      bool exact = (nx % px == 0) && (ny % py == 0) && (nz % pz == 0);
      int64_t sx = (nx + px - 1) / px;
      int64_t sy = (ny + py - 1) / py;
      int64_t sz = (nz + pz - 1) / pz;
      double surface = 2.0 * (double(sx) * double(sy) * (pz > 1) +
                              double(sy) * double(sz) * (px > 1) +
                              double(sz) * double(sx) * (py > 1));
      bool better;
      if (!found) {
        better = true;
      } else if (exact != best_exact) {
        better = exact;
      } else if (surface != best_surface) {
        better = surface < best_surface;
      } else if (pz != best_pz) {
        better = pz < best_pz;
      } else if (py != best_py) {
        better = py < best_py;
      } else {
        better = px < best_px;
      }
      if (better) {
        found = true;
        best_exact = exact;
        best_surface = surface;
        best_px = px;
        best_py = py;
        best_pz = pz;
      }
    }
  }
  if (!found) return -1;
  *px_out = best_px;
  *py_out = best_py;
  *pz_out = best_pz;
  return 0;
}

// Owned box of process coordinate (ix, iy, iz) in pgrid (px, py, pz) over
// grid (nx, ny, nz) — DMDAGetCorners semantics. Remainder cells go to the
// leading processes on each axis (parallel/decomp.py's axis_boxes).
// Writes (xs, ys, zs, xn, yn, zn).
int pb_owned_box(int64_t nx, int64_t ny, int64_t nz,
                 int64_t px, int64_t py, int64_t pz,
                 int64_t ix, int64_t iy, int64_t iz,
                 int64_t* out /* [6] */) {
  if (px <= 0 || py <= 0 || pz <= 0) return -1;
  if (ix < 0 || ix >= px || iy < 0 || iy >= py || iz < 0 || iz >= pz) return -1;
  const int64_t n[3] = {nx, ny, nz};
  const int64_t p[3] = {px, py, pz};
  const int64_t c[3] = {ix, iy, iz};
  for (int d = 0; d < 3; ++d) {
    int64_t base = n[d] / p[d];
    int64_t rem = n[d] % p[d];
    int64_t count = base + (c[d] < rem ? 1 : 0);
    int64_t start = c[d] * base + (c[d] < rem ? c[d] : rem);
    out[d] = start;
    out[3 + d] = count;
  }
  return 0;
}

// Per-rank DoF counts in lexicographic (ix, iy, iz) order. `counts` must
// hold px*py*pz entries. (The reference README reports this distribution:
// 90112/86016/86016 for 64^3 on 3 ranks, reference README.md:25-33.)
int pb_dof_distribution(int64_t nx, int64_t ny, int64_t nz,
                        int64_t px, int64_t py, int64_t pz,
                        int64_t* counts) {
  int64_t box[6];
  int64_t idx = 0;
  for (int64_t ix = 0; ix < px; ++ix)
    for (int64_t iy = 0; iy < py; ++iy)
      for (int64_t iz = 0; iz < pz; ++iz) {
        if (pb_owned_box(nx, ny, nz, px, py, pz, ix, iy, iz, box)) return -1;
        counts[idx++] = box[3] * box[4] * box[5];
      }
  return 0;
}

// Halo-exchange message bytes per sharded axis for one stencil application:
// width * plane_area * itemsize * 2 directions. Writes 3 entries (0 for
// unsharded axes). The communication census of reference SURVEY §5.8.
int pb_halo_bytes(int64_t nx, int64_t ny, int64_t nz,
                  int64_t px, int64_t py, int64_t pz,
                  int64_t width, int64_t itemsize, int64_t* bytes /* [3] */) {
  if (px <= 0 || py <= 0 || pz <= 0 || width < 0 || itemsize <= 0) return -1;
  int64_t sx = (nx + px - 1) / px;
  int64_t sy = (ny + py - 1) / py;
  int64_t sz = (nz + pz - 1) / pz;
  bytes[0] = (px > 1) ? 2 * width * sy * sz * itemsize : 0;
  bytes[1] = (py > 1) ? 2 * width * sx * sz * itemsize : 0;
  bytes[2] = (pz > 1) ? 2 * width * sx * sy * itemsize : 0;
  return 0;
}

}  // extern "C"
