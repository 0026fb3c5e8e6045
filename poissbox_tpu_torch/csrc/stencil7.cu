// KA `stencil7`: the periodic 7-point Laplacian star with five epilogues.
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
//   K12 _pupd_dot, _pupd_dot_pan                  CG's deferred search
//       (_pupd_lapl_dot_kernel_fy/_pan) and       direction p' = (v - zs) +
//       stencil_inplace.py's _pupd_matvec_stream  beta * p_old, written with
//                                                 y = A p' and the partials of
//                                                 <p', A p'>
// and carries stencil_inplace.py's K1'/K2' (_lapl_stream: the TPU's
// streamed K1 and K2 for large fields) as K1 and K2 out of place.
//
// K12 is the star with an input prologue: the kernel is templated on a
// loader, and K12's loader forms p' = (v - zs) + beta * p_old at each of the
// seven loads (two loads and the affine form each) in
// _pupd_lapl_dot_kernel_fy's grouping. beta and zs are read on the device
// from a 2-element tensor, as K8 reads alpha, so the host never waits for
// them.
//
// Types: float32 and float64 in every epilogue (K12 included); bfloat16 u
// and b in the residual and Jacobi epilogues (the bf16 pre-smooths of the
// Chebyshev and multi-sweep Jacobi smoothers at 512^3-class sizes). A bf16 value is
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
// K10; the arithmetic (9 flops a point) is far below the compute roof. K12
// reads v and p_old and writes p' and A p', 4 passes: 0.080 ms at 256^3
// f32, 0.641 ms at 512^3.
//
// Design: one thread per point; z, the contiguous axis, is the fastest
// thread index, so each warp's loads and stores coalesce; periodic
// neighbours come from wrapped indices. The x and y neighbour loads hit
// L2 (and L1) when the neighbouring planes and rows were just read by
// other blocks. What this first design leaves on the table: no shared-
// memory tile and no register blocking along x, so each u value is
// fetched up to 7 times through the caches; no TMA or cp.async pipeline;
// and the 32 x 8 block wastes lanes on the coarse MG levels (nz < 32).
// K12 forms p' again at each of the up to 7 loads of a point (14 cached
// loads where one of each field would do).
#include "common.cuh"

namespace poissbox {

enum Epilogue { kApply = 0, kApplyDot = 1, kResidual = 2, kJacobi = 3, kPUpdDot = 4 };

// The field the star reads: u itself (K1, K2, K9, K10).
template <typename T>
struct LoadField {
  using C = typename Compute<T>::type;
  const T* u;
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ C operator()(size_t i) const { return cvt<C>(u[i]); }
};

// K12's prologue: p' = (v - zs) + beta * p_old, with (beta, zs) = sc[0..1]
// read on the device.
template <typename T>
struct LoadPUpdate {
  const T* v;
  const T* p;
  const T* sc;
  T beta, zs;
  __device__ __forceinline__ void prepare() {
    beta = sc[0];
    zs = sc[1];
  }
  __device__ __forceinline__ T operator()(size_t i) const { return (v[i] - zs) + beta * p[i]; }
};

// y = star(load); `pout` (K12) receives the loaded centre value p'.
template <typename T, int EPI, typename Load>
__global__ void __launch_bounds__(kThreads)
stencil7_kernel(Load load, const T* __restrict__ b, T* __restrict__ y, T* __restrict__ pout,
                typename Compute<T>::type* __restrict__ part, int nx, int ny, int nz,
                typename Compute<T>::type ivx, typename Compute<T>::type ivy,
                typename Compute<T>::type ivz, typename Compute<T>::type center,
                typename Compute<T>::type winv) {
  using C = typename Compute<T>::type;
  constexpr bool kDot = EPI == kApplyDot || EPI == kPUpdDot;
  load.prepare();
  const Point q = locate(nx, ny, nz);
  C dot = C(0);
  if (q.active) {
    const C c = load(q.p);
    C acc = (load(q.xm) + load(q.xp)) * ivx;
    acc = acc + (load(q.ym) + load(q.yp)) * ivy;
    acc = acc + (load(q.zm) + load(q.zp)) * ivz;
    C out = acc - center * c;
    if (EPI == kResidual) out = cvt<C>(b[q.p]) - out;
    if (EPI == kJacobi) out = c + winv * (cvt<C>(b[q.p]) - out);
    y[q.p] = cvt<T>(out);
    if constexpr (EPI == kPUpdDot) pout[q.p] = cvt<T>(c);
    if (kDot) dot = c * out;
  }
  if (kDot) block_partials(dot, C(0), part, (C*)nullptr);
}

template <typename T, int EPI>
cudaError_t launch_epi(cudaStream_t stream, const void* u, const void* b, void* y, void* part,
                       int nx, int ny, int nz, double ivx, double ivy, double ivz,
                       double center, double winv) {
  using C = typename Compute<T>::type;
  stencil7_kernel<T, EPI, LoadField<T>><<<launch_grid(nx, ny, nz), launch_block(), 0, stream>>>(
      LoadField<T>{static_cast<const T*>(u)}, static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<T*>(nullptr), static_cast<C*>(part), nx, ny, nz, C(ivx), C(ivy), C(ivz),
      C(center), C(winv));
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

template <typename T>
cudaError_t launch_pupd_dot(cudaStream_t stream, const void* v, const void* p, const void* sc,
                            void* pout, void* y, void* part, int nx, int ny, int nz,
                            double ivx, double ivy, double ivz, double center) {
  const LoadPUpdate<T> load{static_cast<const T*>(v), static_cast<const T*>(p),
                            static_cast<const T*>(sc), T(0), T(0)};
  stencil7_kernel<T, kPUpdDot, LoadPUpdate<T>><<<launch_grid(nx, ny, nz), launch_block(), 0, stream>>>(
      load, static_cast<const T*>(nullptr), static_cast<T*>(y), static_cast<T*>(pout),
      static_cast<T*>(part), nx, ny, nz, T(ivx), T(ivy), T(ivz), T(center), T(0));
  return cudaGetLastError();
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

// K12: (p', A p', partials of <p', A p'>) for p' = (v - sc[1]) + sc[0] * p,
// dtype 0 = float32, 1 = float64; sc holds (beta, zshift) on the device.
// Returns the cudaError_t of the launch (0 on success).
int poissbox_pupd_dot(int dtype, int device, void* stream, const void* v, const void* p,
                      const void* sc, void* pout, void* y, void* part, int nx, int ny, int nz,
                      double ivx, double ivy, double ivz, double center) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == poissbox::kF32)
    err = poissbox::launch_pupd_dot<float>(s, v, p, sc, pout, y, part, nx, ny, nz, ivx, ivy,
                                           ivz, center);
  else if (dtype == poissbox::kF64)
    err = poissbox::launch_pupd_dot<double>(s, v, p, sc, pout, y, part, nx, ny, nz, ivx, ivy,
                                            ivz, center);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
