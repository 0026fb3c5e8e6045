// KA `stencil7`: the periodic 7-point Laplacian star with three epilogues.
//
// Replaces these TPU kernels of poissbox_tpu/ops/stencil_pallas.py:
//   K1  _apply (via _launch / _upd_lapl)          y = A u
//   K2  _apply_dot, _apply_dot_pan                y = A u and per-block
//       (_lapl_dot_kernel_fy/_pan)                partials of <u, A u>
//   K9  _residual (via _launch / _upd_residual)   r = b - A u
// The star keeps _star_into's grouping,
//   ((u[i-1]+u[i+1])*ivx + (u[j-1]+u[j+1])*ivy) + (u[k-1]+u[k+1])*ivz
//   - 2*(ivx+ivy+ivz)*u,
// and the library is built with --fmad=false, so the kernel rounds as the
// plain version in ops/stencil_cuda.py does.
//
// Bound on an H100 SXM (3.35 TB/s): the star reads u and writes y, 2 field
// passes (3 for the residual, which also reads b). At 256^3 f32 that is
// 2 x 67 MB = 0.040 ms for K1/K2 and 0.060 ms for K9; the arithmetic
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

enum Epilogue { kApply = 0, kApplyDot = 1, kResidual = 2 };

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
stencil7_kernel(const T* __restrict__ u, const T* __restrict__ b, T* __restrict__ y,
                T* __restrict__ part, int nx, int ny, int nz, T ivx, T ivy, T ivz,
                T center) {
  const Point q = locate(nx, ny, nz);
  T dot = T(0);
  if (q.active) {
    const T c = u[q.p];
    T acc = (u[q.xm] + u[q.xp]) * ivx;
    acc = acc + (u[q.ym] + u[q.yp]) * ivy;
    acc = acc + (u[q.zm] + u[q.zp]) * ivz;
    T out = acc - center * c;
    if (EPI == kResidual) out = b[q.p] - out;
    y[q.p] = out;
    if (EPI == kApplyDot) dot = c * out;
  }
  if (EPI == kApplyDot) block_partials(dot, T(0), part, (T*)nullptr);
}

template <typename T>
cudaError_t launch_stencil7(int epi, cudaStream_t stream, const void* u, const void* b,
                            void* y, void* part, int nx, int ny, int nz, double ivx,
                            double ivy, double ivz, double center) {
  const dim3 grid = launch_grid(nx, ny, nz);
  const dim3 block = launch_block();
  const T* uu = static_cast<const T*>(u);
  const T* bb = static_cast<const T*>(b);
  T* yy = static_cast<T*>(y);
  T* pp = static_cast<T*>(part);
  switch (epi) {
    case kApply:
      stencil7_kernel<T, kApply><<<grid, block, 0, stream>>>(
          uu, bb, yy, pp, nx, ny, nz, T(ivx), T(ivy), T(ivz), T(center));
      break;
    case kApplyDot:
      stencil7_kernel<T, kApplyDot><<<grid, block, 0, stream>>>(
          uu, bb, yy, pp, nx, ny, nz, T(ivx), T(ivy), T(ivz), T(center));
      break;
    case kResidual:
      stencil7_kernel<T, kResidual><<<grid, block, 0, stream>>>(
          uu, bb, yy, pp, nx, ny, nz, T(ivx), T(ivy), T(ivz), T(center));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

// dtype: 0 = float32, 1 = float64. epi: 0 apply, 1 apply + dot partials,
// 2 residual. Returns the cudaError_t of the launch (0 on success).
int poissbox_stencil7(int dtype, int epi, int device, void* stream, const void* u,
                      const void* b, void* y, void* part, int nx, int ny, int nz,
                      double ivx, double ivy, double ivz, double center) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = poissbox::launch_stencil7<float>(epi, s, u, b, y, part, nx, ny, nz, ivx, ivy, ivz,
                                           center);
  else if (dtype == 1)
    err = poissbox::launch_stencil7<double>(epi, s, u, b, y, part, nx, ny, nz, ivx, ivy,
                                            ivz, center);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
