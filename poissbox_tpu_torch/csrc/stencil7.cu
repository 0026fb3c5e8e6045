// KA `stencil7`: the periodic 7-point Laplacian star with four epilogues.
//
// Replaces these TPU kernels of poissbox_tpu/ops/stencil_pallas.py:
//   K1  _apply (via _launch / _upd_lapl)          y = A u
//   K2  _apply_dot, _apply_dot_pan                y = A u and per-block
//       (_lapl_dot_kernel_fy/_pan)                partials of <u, A u>
//   K9  _residual (via _launch / _upd_residual)   r = b - A u
//   K10 _jacobi (via _launch / _upd_jacobi)       u + winv * (b - A u), the
//       damped-Jacobi smoother sweep, winv = w / (-2 sum 1/d^2); it also
//       carries stencil_inplace.py's _jacobi_inplace (K10's aliased form)
//       out of place
// Types: float32 and float64 in every epilogue; bfloat16 u and b in the
// residual and Jacobi epilogues (the bf16 pre-smooths of the Chebyshev and
// multi-sweep Jacobi smoothers at 512^3-class sizes). A bf16 value is
// upcast to float32, the star and the epilogue run in float32, and the
// result rounds once (RNE) at the store, as KB's bf16 colour updates do.
// The star keeps _star_into's grouping,
//   ((u[i-1]+u[i+1])*ivx + (u[j-1]+u[j+1])*ivy) + (u[k-1]+u[k+1])*ivz
//   - 2*(ivx+ivy+ivz)*u,
// and the library is built with --fmad=false, so the kernel rounds as the
// plain version in ops/stencil_cuda.py does.
//
// Bound on an H100 SXM (3.35 TB/s): the star reads u and writes y, 2 field
// passes (3 for the residual and the Jacobi sweep, which also read b). At
// 256^3 f32 that is 2 x 67 MB = 0.040 ms for K1/K2 and 0.060 ms for K9 and
// K10; the arithmetic
// (9 flops a point) is far below the compute roof.
//
// Design: one thread per point; z, the contiguous axis, is the fastest
// thread index, so each warp's loads and stores coalesce; periodic
// neighbours come from wrapped indices. The x and y neighbour loads hit
// L2 (and L1) when the neighbouring planes and rows were just read by
// other blocks. What this first design leaves on the table: no shared-
// memory tile and no register blocking along x, so each u value is
// fetched up to 7 times through the caches; no TMA or cp.async pipeline;
// and the 32 x 8 block wastes lanes on the coarse MG levels (nz < 32).
#include "common.cuh"

namespace poissbox {

enum Epilogue { kApply = 0, kApplyDot = 1, kResidual = 2, kJacobi = 3 };

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
stencil7_kernel(const T* __restrict__ u, const T* __restrict__ b, T* __restrict__ y,
                typename Compute<T>::type* __restrict__ part, int nx, int ny, int nz,
                typename Compute<T>::type ivx, typename Compute<T>::type ivy,
                typename Compute<T>::type ivz, typename Compute<T>::type center,
                typename Compute<T>::type winv) {
  using C = typename Compute<T>::type;
  const Point q = locate(nx, ny, nz);
  C dot = C(0);
  if (q.active) {
    const C c = cvt<C>(u[q.p]);
    C acc = (cvt<C>(u[q.xm]) + cvt<C>(u[q.xp])) * ivx;
    acc = acc + (cvt<C>(u[q.ym]) + cvt<C>(u[q.yp])) * ivy;
    acc = acc + (cvt<C>(u[q.zm]) + cvt<C>(u[q.zp])) * ivz;
    C out = acc - center * c;
    if (EPI == kResidual) out = cvt<C>(b[q.p]) - out;
    if (EPI == kJacobi) out = c + winv * (cvt<C>(b[q.p]) - out);
    y[q.p] = cvt<T>(out);
    if (EPI == kApplyDot) dot = c * out;
  }
  if (EPI == kApplyDot) block_partials(dot, C(0), part, (C*)nullptr);
}

template <typename T, int EPI>
cudaError_t launch_epi(cudaStream_t stream, const void* u, const void* b, void* y, void* part,
                       int nx, int ny, int nz, double ivx, double ivy, double ivz,
                       double center, double winv) {
  using C = typename Compute<T>::type;
  stencil7_kernel<T, EPI><<<launch_grid(nx, ny, nz), launch_block(), 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<C*>(part), nx, ny, nz, C(ivx), C(ivy), C(ivz), C(center), C(winv));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stencil7(int epi, cudaStream_t stream, const void* u, const void* b,
                            void* y, void* part, int nx, int ny, int nz, double ivx,
                            double ivy, double ivz, double center, double winv) {
  switch (epi) {
    case kApply:
      return launch_epi<T, kApply>(stream, u, b, y, part, nx, ny, nz, ivx, ivy, ivz, center,
                                   winv);
    case kApplyDot:
      return launch_epi<T, kApplyDot>(stream, u, b, y, part, nx, ny, nz, ivx, ivy, ivz,
                                      center, winv);
    case kResidual:
      return launch_epi<T, kResidual>(stream, u, b, y, part, nx, ny, nz, ivx, ivy, ivz,
                                      center, winv);
    case kJacobi:
      return launch_epi<T, kJacobi>(stream, u, b, y, part, nx, ny, nz, ivx, ivy, ivz, center,
                                    winv);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 u and b: the residual and Jacobi epilogues only.
cudaError_t launch_stencil7_bf16(int epi, cudaStream_t stream, const void* u, const void* b,
                                 void* y, int nx, int ny, int nz, double ivx, double ivy,
                                 double ivz, double center, double winv) {
  using B = __nv_bfloat16;
  if (epi == kResidual)
    return launch_epi<B, kResidual>(stream, u, b, y, nullptr, nx, ny, nz, ivx, ivy, ivz,
                                    center, winv);
  if (epi == kJacobi)
    return launch_epi<B, kJacobi>(stream, u, b, y, nullptr, nx, ny, nz, ivx, ivy, ivz, center,
                                  winv);
  return cudaErrorInvalidValue;
}

}  // namespace poissbox

extern "C" {

// Number of blocks (and of reduction partials) a launch over the grid uses.
int poissbox_num_blocks(int nx, int ny, int nz) {
  const dim3 g = poissbox::launch_grid(nx, ny, nz);
  return (int)(g.x * g.y * g.z);
}

const char* poissbox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (epi 2 and 3 only). epi:
// 0 apply, 1 apply + dot partials, 2 residual, 3 Jacobi sweep (winv is
// read by it only). Returns the
// cudaError_t of the launch (0 on success).
int poissbox_stencil7(int dtype, int epi, int device, void* stream, const void* u,
                      const void* b, void* y, void* part, int nx, int ny, int nz,
                      double ivx, double ivy, double ivz, double center, double winv) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == poissbox::kF32)
    err = poissbox::launch_stencil7<float>(epi, s, u, b, y, part, nx, ny, nz, ivx, ivy, ivz,
                                           center, winv);
  else if (dtype == poissbox::kF64)
    err = poissbox::launch_stencil7<double>(epi, s, u, b, y, part, nx, ny, nz, ivx, ivy,
                                            ivz, center, winv);
  else if (dtype == poissbox::kBF16)
    err = poissbox::launch_stencil7_bf16(epi, s, u, b, y, nx, ny, nz, ivx, ivy, ivz, center,
                                         winv);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
