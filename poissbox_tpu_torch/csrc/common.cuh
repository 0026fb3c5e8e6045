// Shared launch geometry and block reductions for the Hopper stencil kernels.
//
// Every kernel runs one thread per grid point on a 3-D launch grid:
// blockIdx.z is the x plane, a block of kBX x kBY threads covers a
// (y, z) tile, and z (the contiguous axis of the C-order field) is the
// fastest thread index, so a warp reads 32 consecutive z values.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace poissbox {

constexpr int kBX = 32;  // threads along z, one warp
constexpr int kBY = 8;   // threads along y
constexpr int kThreads = kBX * kBY;
constexpr int kWarps = kThreads / 32;

inline dim3 launch_grid(int nx, int ny, int nz) {
  return dim3((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
}

inline dim3 launch_block() { return dim3(kBX, kBY, 1); }

// Periodic neighbours of index i on an axis of extent n.
__device__ __forceinline__ int wrap_m(int i, int n) { return i == 0 ? n - 1 : i - 1; }
__device__ __forceinline__ int wrap_p(int i, int n) { return i == n - 1 ? 0 : i + 1; }

// The point this thread owns, with the offsets of its six periodic
// neighbours. `active` is false for threads past the ragged (y, z) edge.
struct Point {
  int i, j, k;
  bool active;
  size_t p, xm, xp, ym, yp, zm, zp;
};

__device__ __forceinline__ Point locate(int nx, int ny, int nz) {
  Point q;
  q.k = blockIdx.x * kBX + threadIdx.x;
  q.j = blockIdx.y * kBY + threadIdx.y;
  q.i = blockIdx.z;
  q.active = q.k < nz && q.j < ny;
  if (!q.active) return q;
  const size_t plane = (size_t)ny * nz;
  const size_t row = (size_t)q.j * nz;
  const size_t base = (size_t)q.i * plane;
  q.p = base + row + q.k;
  q.xm = (size_t)wrap_m(q.i, nx) * plane + row + q.k;
  q.xp = (size_t)wrap_p(q.i, nx) * plane + row + q.k;
  q.ym = base + (size_t)wrap_m(q.j, ny) * nz + q.k;
  q.yp = base + (size_t)wrap_p(q.j, ny) * nz + q.k;
  q.zm = base + row + wrap_m(q.k, nz);
  q.zp = base + row + wrap_p(q.k, nz);
  return q;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block sums of a and b, written by one thread to slot `block` of pa and
// pb (pb may be null). Accumulation is in the working dtype T, as the
// JAX kernels' per-block jnp.sum is; the caller sums the partials with
// torch.sum, so no atomics and the result is the same from run to run.
// Every thread of the block must call this.
template <typename T>
__device__ __forceinline__ void block_partials(T a, T b, T* pa, T* pb) {
  __shared__ T sa[kWarps];
  __shared__ T sb[kWarps];
  const int tid = threadIdx.x + kBX * threadIdx.y;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : T(0);
    b = lane < kWarps ? sb[lane] : T(0);
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      const size_t block = blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
      pa[block] = a;
      if (pb != nullptr) pb[block] = b;
    }
  }
}

}  // namespace poissbox
