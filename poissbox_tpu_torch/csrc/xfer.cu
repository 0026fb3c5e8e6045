// `xfer`: the multigrid transfer legs fused along x, two modes.
//
// Replaces these TPU kernels of poissbox_tpu/ops/stencil_pallas.py:
//   K6  _resid_xrestrict (_resid_xrestrict_kernel)   mode restrict:
//       rc = R_x(b - A u), the fine residual restricted along x to
//       (nx/2, ny, nz): rc[I] = (3 (r[2I] + r[2I+1]) + r[2I+2] + r[2I-1]) / 8
//   K7  _xprolong_add (_xprolong_add_kernel)        mode prolong_add:
//       out = u + P_x(e), e at (nx/2, ny, nz): the fine cell 2I takes
//       0.75 e[I] + 0.25 e[I-1], the fine cell 2I+1 0.75 e[I] + 0.25 e[I+1]
// The y/z transfers run on the half-size field as banded contractions
// (solvers/mg.py restrict_mm / prolong_mm, axes (1, 2)), so neither the
// full-size residual nor the full-size prolonged correction is stored.
//
// Types: u may be narrower than b and e (the bf16 pre-smooth iterate of
// the 512^3-class cycle): it is upcast to b's (e's) type before any
// arithmetic, and the output is in b's (e's) type. Pairs (u, b/e):
// f32/f32, f64/f64, bf16/f32, bf16/f64.
//
// The residual keeps _star_ext's grouping: for cubic cells
// s = ((u[x-1] + u[x+1]) + (u[y-1] + u[y+1])) + (u[z-1] + u[z+1]) and
// star = s*ivx - (6*ivx)*u, otherwise the per-axis form of stencil7.cu.
// Built with --fmad=false, so the kernel rounds as the plain versions in
// ops/transfer_cuda.py do.
//
// Bound on an H100 SXM (3.35 TB/s): restrict reads u and b and writes
// half a field, 2.5 field passes (0.050 ms at 256^3 f32, 0.401 ms at 512^3;
// with a bf16 u at 512^3, 2.0 passes = 0.321 ms); prolong_add reads u and
// half a field and writes a field, also 2.5 passes.
//
// Design of restrict (restrict_kernel): each fine residual b - A u is
// computed once. A block of 256 threads owns a 32 x 16 (y, z) tile, z
// fastest, two rows a thread, and walks a chunk of coarse planes I
// (tile_chunk: 16 at 512^3, 8 at 256^3). A ring of four u planes, each the
// tile with a 1-cell periodic (y, z) halo, sits in shared memory (u upcast
// as it is staged); one barrier a fine plane suffices, since the plane
// staged next never overwrites one still read, and the next plane's loads
// are issued into registers right after it. Each coarse plane takes two new
// fine residuals, 2I+1 and 2I+2; 2I-1 and 2I stay in registers from the
// plane before. b is read once, by the thread that owns the point; the u
// halo cells of neighbouring tiles come from L2. On an NVIDIA H100 80GB HBM3
// at 700.00 W (PERF.md section 6): 0.088 ms at 256^3 f32 (57 % of the
// bound), 0.600 at 512^3 (67 %), 0.536 with a bf16 u (60 %). prolong_add
// keeps one thread per fine point, the launch geometry of common.cuh.
#include "common.cuh"

namespace poissbox {

enum XferMode { kRestrict = 0, kProlongAdd = 1 };

// The coarse planes a restriction block walks.
inline int restrict_chunk(int nx, int ny, int nz) { return tile_chunk(nx / 2, ny, nz, 16); }

// rc = R_x(b - A u) over the (nx/2, ny, nz) output (see the header).
template <typename TU, typename T, bool ISO>
__global__ void __launch_bounds__(kTileThreads, 4)
restrict_kernel(const TU* __restrict__ u, const T* __restrict__ b, T* __restrict__ out, int nx,
                int ny, int nz, int chunk, T ivx, T ivy, T ivz, T center, T six_iv) {
  using UW = TileWindow<1>;
  __shared__ T us[4][UW::kN];
  const int tid = threadIdx.x + kTZ * threadIdx.y;
  const int j0 = blockIdx.y * kTY, k0 = blockIdx.x * kTZ;
  const int I0 = blockIdx.z * chunk;
  const int m = min(chunk, nx / 2 - I0);
  const size_t plane = (size_t)ny * nz;
  const UW uw(j0, k0, ny, nz, tid);
  const int kk = k0 + threadIdx.x;
  bool own[kRowsPerThread];
  size_t ooff[kRowsPerThread];
#pragma unroll
  for (int h = 0; h < kRowsPerThread; ++h) {
    const int j = j0 + threadIdx.y + h * kTileRows;
    own[h] = j < ny && kk < nz;
    ooff[h] = (size_t)j * nz + kk;
  }
  const int f0 = 2 * I0 - 1;  // the first fine plane whose residual the block needs
  // ring slot of fine plane q (q >= f0 - 1)
  auto slot = [f0](int q) { return (q - f0 + 1) & 3; };
  // the wrapped index of the plane after wrapped index q: plane indices
  // advance one a step, so `%` is taken only before the loop
  auto next = [nx](int q) { return q + 1 == nx ? 0 : q + 1; };

  // the register stage: u plane i+1 and b at the points owned in plane i
  // of the next step (i = f0 + t); q is the wrapped index of plane i
  TU ur[UW::kR];
  T br[kRowsPerThread];
  auto stage = [&](int q) {
    const TU* src = u + (size_t)next(q) * plane;
#pragma unroll
    for (int rr = 0; rr < UW::kR; ++rr)
      if (UW::has(rr, tid)) ur[rr] = src[uw.off[rr]];
    const T* bsrc = b + (size_t)q * plane;
#pragma unroll
    for (int h = 0; h < kRowsPerThread; ++h)
      if (own[h]) br[h] = bsrc[ooff[h]];
  };
  int sq = pmod(f0, nx);  // the wrapped plane i of the next stage
  // r[2I-1], r[2I], r[2I+1] of each row owned
  T r_dn[kRowsPerThread], r_even[kRowsPerThread], r_odd[kRowsPerThread];
  for (int q = f0 - 1; q <= f0; ++q) {
    const TU* src = u + (size_t)pmod(q, nx) * plane;
#pragma unroll
    for (int rr = 0; rr < UW::kR; ++rr)
      if (UW::has(rr, tid)) us[slot(q)][tid + rr * kTileThreads] = cvt<T>(src[uw.off[rr]]);
  }
  stage(sq);
  sq = next(sq);
  // Step t (fine plane i = f0 + t): store the staged u plane i+1, one
  // barrier, stage the planes of step t + 1, take the residual at plane i.
  // One barrier suffices: a thread still in step t-1 reads u planes
  // i-2..i, none in the slot step t writes.
  for (int t = 0; t <= 2 * m + 1; ++t) {
    const int i = f0 + t;
#pragma unroll
    for (int rr = 0; rr < UW::kR; ++rr)
      if (UW::has(rr, tid)) us[slot(i + 1)][tid + rr * kTileThreads] = cvt<T>(ur[rr]);
    T bv[kRowsPerThread];
#pragma unroll
    for (int h = 0; h < kRowsPerThread; ++h) bv[h] = br[h];
    __syncthreads();
    if (t <= 2 * m) stage(sq);
    sq = next(sq);
    const T* u0 = us[slot(i)];
    const T* um = us[slot(i - 1)];
    const T* up = us[slot(i + 1)];
#pragma unroll
    for (int h = 0; h < kRowsPerThread; ++h) {
      if (!own[h]) continue;
      const int oc = (threadIdx.y + h * kTileRows + 1) * UW::kZ + threadIdx.x + 1;
      const T c = u0[oc];
      const T xm = um[oc], xp = up[oc];
      const T ym = u0[oc - UW::kZ], yp = u0[oc + UW::kZ];
      const T zm = u0[oc - 1], zp = u0[oc + 1];
      T star;
      if (ISO) {
        const T s = ((xm + xp) + (ym + yp)) + (zm + zp);
        star = s * ivx - six_iv * c;
      } else {
        T s = (xm + xp) * ivx;
        s = s + (ym + yp) * ivy;
        s = s + (zm + zp) * ivz;
        star = s - center * c;
      }
      const T res = bv[h] - star;  // the residual at fine plane i
      if (t == 0) {
        r_dn[h] = res;
      } else if (t == 1) {
        r_even[h] = res;
      } else if (t & 1) {  // i = 2I + 2: coarse plane I is complete
        const int I = I0 + (t - 3) / 2;
        out[(size_t)I * plane + ooff[h]] =
            ((T(3) * (r_even[h] + r_odd[h]) + res) + r_dn[h]) * T(0.125);
        r_dn[h] = r_odd[h];
        r_even[h] = res;
      } else {
        r_odd[h] = res;
      }
    }
  }
}

// One thread per fine point (i, j, k) of the (nx, ny, nz) output.
template <typename TU, typename T>
__global__ void __launch_bounds__(kThreads)
prolong_add_kernel(const TU* __restrict__ u, const T* __restrict__ e, T* __restrict__ out,
                   int nx, int ny, int nz) {
  const Point q = locate(nx, ny, nz);
  if (!q.active) return;
  const int nxc = nx / 2;
  const int I = q.i >> 1;
  const int nb = (q.i & 1) ? wrap_p(I, nxc) : wrap_m(I, nxc);
  const size_t plane = (size_t)ny * nz;
  const size_t off = (size_t)q.j * nz + q.k;
  const T corr = T(0.75) * e[(size_t)I * plane + off] + T(0.25) * e[(size_t)nb * plane + off];
  out[q.p] = cvt<T>(u[q.p]) + corr;
}

struct XferCoef {
  double ivx, ivy, ivz, center, six_iv;
};

template <typename TU, typename T>
cudaError_t launch_xfer(int mode, int iso, cudaStream_t s, const void* u, const void* be,
                        void* out, int nx, int ny, int nz, const XferCoef& k) {
  const TU* uu = static_cast<const TU*>(u);
  const T* bb = static_cast<const T*>(be);
  T* oo = static_cast<T*>(out);
  if (mode == kRestrict) {
    const int chunk = restrict_chunk(nx, ny, nz);
    const dim3 grid = tile_grid(nx / 2, ny, nz, chunk);
    if (iso)
      restrict_kernel<TU, T, true><<<grid, tile_block(), 0, s>>>(
          uu, bb, oo, nx, ny, nz, chunk, T(k.ivx), T(k.ivy), T(k.ivz), T(k.center),
          T(k.six_iv));
    else
      restrict_kernel<TU, T, false><<<grid, tile_block(), 0, s>>>(
          uu, bb, oo, nx, ny, nz, chunk, T(k.ivx), T(k.ivy), T(k.ivz), T(k.center),
          T(k.six_iv));
  } else if (mode == kProlongAdd) {
    prolong_add_kernel<TU, T><<<launch_grid(nx, ny, nz), launch_block(), 0, s>>>(uu, bb, oo, nx,
                                                                               ny, nz);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace poissbox

extern "C" {

// mode: 0 restrict (be = b, out at (nx/2, ny, nz)), 1 prolong_add (be = e
// at (nx/2, ny, nz), out at (nx, ny, nz)). (nx, ny, nz) is always the fine
// shape; nx is even. tu/t: dtype codes (0 float32, 1 float64, 2 bfloat16)
// of u and of be/out. iso: 1 when ivx == ivy == ivz (restrict only).
// Returns the cudaError_t of the launch (0 on success).
int poissbox_xfer(int tu, int t, int mode, int iso, int device, void* stream, const void* u,
                  const void* be, void* out, int nx, int ny, int nz, double ivx, double ivy,
                  double ivz, double center, double six_iv) {
  using namespace poissbox;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XferCoef k{ivx, ivy, ivz, center, six_iv};
  if (tu == kF32 && t == kF32)
    err = launch_xfer<float, float>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else if (tu == kF64 && t == kF64)
    err = launch_xfer<double, double>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else if (tu == kBF16 && t == kF32)
    err = launch_xfer<__nv_bfloat16, float>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else if (tu == kBF16 && t == kF64)
    err = launch_xfer<__nv_bfloat16, double>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
