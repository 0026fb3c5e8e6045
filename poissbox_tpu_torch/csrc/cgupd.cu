// `cgupd`: CG's fused iterate update,
//   x' = x + alpha p,  r' = r - alpha Ap,  and partials of ||r'||^2, sum(r').
//
// Replaces poissbox_tpu/ops/stencil_pallas.py's K8 cg_fused_update
// (_cg_update_kernel): the CG iteration whenever the preconditioner binds
// no fused entry of its own (a Jacobi- or Chebyshev-smoothed cycle, roll
// transfers at the 512^3-class bf16 pre-smooth, no preconditioner).
// alpha is a 0-d device tensor read by pointer, so the host never waits
// for it. The field type is f32 or f64 (the four fields share it).
//
// Bound on an H100 SXM (3.35 TB/s): reads x, p, r, Ap and writes x', r',
// 6 field passes: 0.120 ms at 256^3 f32, 0.962 ms at 512^3. Design: one
// grid-stride elementwise pass over the flat fields, as many blocks as
// keep every SM full (kBlocksPerSm per SM, capped by the field size); each
// thread accumulates its sums in registers and each block writes one
// partial per sum, which the wrapper adds with torch.sum.
#include "common.cuh"

namespace poissbox {

constexpr int kBlocksPerSm = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cgupd_kernel(const T* __restrict__ alpha, const T* __restrict__ x, const T* __restrict__ p,
             const T* __restrict__ r, const T* __restrict__ ap, T* __restrict__ xo,
             T* __restrict__ ro, T* __restrict__ prr, T* __restrict__ psr, size_t n) {
  const T a = alpha[0];
  T s0 = T(0), s1 = T(0);
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    xo[i] = x[i] + a * p[i];
    const T rn = r[i] - a * ap[i];
    ro[i] = rn;
    s0 = s0 + rn * rn;
    s1 = s1 + rn;
  }
  block_partials(s0, s1, prr, psr);
}

inline int cgupd_blocks(size_t n, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms <= 0)
    sms = 132;
  const size_t need = (n + kThreads - 1) / kThreads;
  const size_t cap = (size_t)sms * kBlocksPerSm;
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

}  // namespace poissbox

extern "C" {

// Number of blocks (and of partials per sum) of a launch over n points.
int poissbox_cgupd_blocks(long long n, int device) {
  return poissbox::cgupd_blocks((size_t)n, device);
}

// dtype: 0 = float32, 1 = float64. The launch block is 1-D (kThreads
// threads), so common.cuh's block_partials sees threadIdx.y == 0. Returns
// the cudaError_t of the launch (0 on success).
int poissbox_cgupd(int dtype, int device, void* stream, const void* alpha, const void* x,
                   const void* p, const void* r, const void* ap, void* xo, void* ro, void* prr,
                   void* psr, long long n) {
  using namespace poissbox;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = cgupd_blocks((size_t)n, device);
  if (dtype == kF32)
    cgupd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(alpha), static_cast<const float*>(x),
        static_cast<const float*>(p), static_cast<const float*>(r),
        static_cast<const float*>(ap), static_cast<float*>(xo), static_cast<float*>(ro),
        static_cast<float*>(prr), static_cast<float*>(psr), (size_t)n);
  else if (dtype == kF64)
    cgupd_kernel<double><<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(alpha), static_cast<const double*>(x),
        static_cast<const double*>(p), static_cast<const double*>(r),
        static_cast<const double*>(ap), static_cast<double*>(xo), static_cast<double*>(ro),
        static_cast<double*>(prr), static_cast<double*>(psr), (size_t)n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
