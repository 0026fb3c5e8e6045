// K13 `tridiag`: batched Thomas solve along axis 0 with the periodic
// (Sherman-Morrison) correction fused in.
//
// Replaces poissbox_tpu/ops/tridiag_pallas.py's _solve_blocks (:293;
// _thomas_kernel :69 with _bwd_and_corr :38, launched by _launch_tridiag
// :270). The circulant PCR solve (K14, _solve_pcr_blocks :303) runs on
// K15's line kernel in csrc/compact.cu, with the RHS taps replaced by a
// scale.
//
// The RHS is (n, Q): n rows, Q independent lines (the batch). One thread
// owns one line; consecutive threads own consecutive columns, so every
// row access of a warp is one coalesced load or store. The thread runs
// the forward sweep dmod_i = d_i - w_i*dmod_{i-1}, the back substitution
// x_i = dmod_i*binv_i - cb_i*x_{i+1} and, when corr[1] != 0, the rank-1
// correction x_i -= usol_i*((x_0 + ar*x_{n-1})*(1/denom)), all in one
// launch, in the Pallas kernel's order of operations (built with
// --fmad=false, as the plain version rounds). The factor vectors w, binv,
// cb and corr = (ar, 1/denom, usol...) are precomputed once per
// coefficient set and read as device arrays: every thread of a warp reads
// the same row's value, a broadcast from L1.
//
// Bound on an H100 SXM (3.35 TB/s): the floor is one read of d and one
// write of x, 2 field passes (0.32 ms at 512^3 f32). This design writes
// the forward sweep's dmod to the output and reads it back in the back
// substitution, and reads and writes it once more in the correction: 3
// reads and 3 writes, at 512^3 beyond what the L2 holds. Each thread's
// rows depend on each other (a first-order recurrence), so the loads of d
// are independent of the chain and may run ahead, but the sweeps are n
// dependent steps: at small batch (Q below a few thousand lines per SM)
// the latency of those steps, not HBM, sets the time. Keeping a stretch
// of each line in registers or shared memory would cut the passes to 2.
#include "common.cuh"

namespace poissbox {

constexpr int kThomasThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThomasThreads)
thomas_kernel(const T* __restrict__ d, T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ binv, const T* __restrict__ cb,
              const T* __restrict__ corr, int n, long long Q) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  // forward sweep
  T prev = d[q];
  x[q] = prev;
#pragma unroll 4
  for (int i = 1; i < n; ++i) {
    const T v = d[i * Q + q] - w[i] * prev;
    x[i * Q + q] = v;
    prev = v;
  }
  // back substitution
  const T last = prev * binv[n - 1];
  x[(n - 1) * Q + q] = last;
  prev = last;
#pragma unroll 4
  for (int i = n - 2; i >= 0; --i) {
    const T v = x[i * Q + q] * binv[i] - cb[i] * prev;
    x[i * Q + q] = v;
    prev = v;
  }
  // periodic rank-1 correction (prev is x_0)
  if (corr[1] != T(0)) {
    const T factor = (prev + corr[0] * last) * corr[1];
    for (int i = 0; i < n; ++i) x[i * Q + q] = x[i * Q + q] - corr[2 + i] * factor;
  }
}

template <typename T>
cudaError_t launch_thomas(cudaStream_t stream, const void* d, void* x, const void* w,
                          const void* binv, const void* cb, const void* corr, int n,
                          long long Q) {
  const long long blocks = (Q + kThomasThreads - 1) / kThomasThreads;
  thomas_kernel<T><<<(unsigned)blocks, kThomasThreads, 0, stream>>>(
      static_cast<const T*>(d), static_cast<T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(binv), static_cast<const T*>(cb), static_cast<const T*>(corr), n,
      Q);
  return cudaGetLastError();
}

}  // namespace poissbox

extern "C" {

// dtype: 0 = float32, 1 = float64. d and x are (n, Q) contiguous; w, binv
// and cb hold n values, corr n + 2 (corr[1] = 0: no periodic
// correction). Returns the cudaError_t of the launch (0 on success).
int poissbox_thomas(int dtype, int device, void* stream, const void* d, void* x, const void* w,
                    const void* binv, const void* cb, const void* corr, int n, long long Q) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == poissbox::kF32)
    err = poissbox::launch_thomas<float>(s, d, x, w, binv, cb, corr, n, Q);
  else if (dtype == poissbox::kF64)
    err = poissbox::launch_thomas<double>(s, d, x, w, binv, cb, corr, n, Q);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
