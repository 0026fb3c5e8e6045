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
// half a field, 2.5 field passes (0.050 ms at 256^3 f32; with a bf16 u at
// 512^3, 2.0 passes = 0.321 ms); prolong_add reads u and half a field and
// writes a field, also 2.5 passes. Design: one thread per output point,
// the launch geometry of common.cuh. A restrict thread recomputes the four
// fine residuals it needs, each with its own six neighbours, so the two
// residuals shared with the next coarse plane are computed twice: double
// the flops, not the HBM bytes (the neighbour planes come through L2).
// Streaming planes through shared memory is the later optimisation.
#include "common.cuh"

namespace poissbox {

enum XferMode { kRestrict = 0, kProlongAdd = 1 };

// b - A u at the fine point (i, j, k), u read through its own type.
template <typename TU, typename T, bool ISO>
__device__ __forceinline__ T fine_residual(const TU* __restrict__ u, const T* __restrict__ b,
                                           int i, int j, int k, int nx, int ny, int nz, T ivx,
                                           T ivy, T ivz, T center, T six_iv) {
  const size_t plane = (size_t)ny * nz;
  const size_t base = (size_t)i * plane;
  const size_t row = (size_t)j * nz;
  const size_t p = base + row + k;
  const T c = cvt<T>(u[p]);
  const T xm = cvt<T>(u[(size_t)wrap_m(i, nx) * plane + row + k]);
  const T xp = cvt<T>(u[(size_t)wrap_p(i, nx) * plane + row + k]);
  const T ym = cvt<T>(u[base + (size_t)wrap_m(j, ny) * nz + k]);
  const T yp = cvt<T>(u[base + (size_t)wrap_p(j, ny) * nz + k]);
  const T zm = cvt<T>(u[base + row + wrap_m(k, nz)]);
  const T zp = cvt<T>(u[base + row + wrap_p(k, nz)]);
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
  return b[p] - star;
}

// One thread per coarse point (I, j, k) of the (nx/2, ny, nz) output.
template <typename TU, typename T, bool ISO>
__global__ void __launch_bounds__(kThreads)
restrict_kernel(const TU* __restrict__ u, const T* __restrict__ b, T* __restrict__ out, int nx,
                int ny, int nz, T ivx, T ivy, T ivz, T center, T six_iv) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int I = blockIdx.z;
  if (k >= nz || j >= ny) return;
  const int i0 = 2 * I;
  const T r_even = fine_residual<TU, T, ISO>(u, b, i0, j, k, nx, ny, nz, ivx, ivy, ivz, center,
                                             six_iv);
  const T r_odd = fine_residual<TU, T, ISO>(u, b, i0 + 1, j, k, nx, ny, nz, ivx, ivy, ivz,
                                            center, six_iv);
  const T r_up = fine_residual<TU, T, ISO>(u, b, wrap_p(i0 + 1, nx), j, k, nx, ny, nz, ivx, ivy,
                                           ivz, center, six_iv);
  const T r_dn = fine_residual<TU, T, ISO>(u, b, wrap_m(i0, nx), j, k, nx, ny, nz, ivx, ivy,
                                           ivz, center, six_iv);
  out[(size_t)I * ny * nz + (size_t)j * nz + k] =
      ((T(3) * (r_even + r_odd) + r_up) + r_dn) * T(0.125);
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
    const dim3 grid = launch_grid(nx / 2, ny, nz);
    if (iso)
      restrict_kernel<TU, T, true><<<grid, launch_block(), 0, s>>>(
          uu, bb, oo, nx, ny, nz, T(k.ivx), T(k.ivy), T(k.ivz), T(k.center), T(k.six_iv));
    else
      restrict_kernel<TU, T, false><<<grid, launch_block(), 0, s>>>(
          uu, bb, oo, nx, ny, nz, T(k.ivx), T(k.ivy), T(k.ivz), T(k.center), T(k.six_iv));
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
