// Shared launch geometry and block reductions for the Hopper stencil kernels.
//
// The point kernels run one thread per grid point on a 3-D launch grid:
// blockIdx.z is the x plane, a block of kBX x kBY threads covers a
// (y, z) tile, and z (the contiguous axis of the C-order field) is the
// fastest thread index, so a warp reads 32 consecutive z values. The
// streaming kernels (below kTZ) walk a chunk of x planes per block.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace poissbox {

// dtype codes of the C interface, shared with ops/stencil_cuda.py
enum DType { kF32 = 0, kF64 = 1, kBF16 = 2 };

// The arithmetic type of a stored type: bf16 fields are upcast to float,
// computed in float and rounded once at the store.
template <typename T>
struct Compute {
  using type = T;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};

// Conversions between stored and arithmetic types; bf16 rounds to
// nearest even, as torch's .to(torch.bfloat16) does.
template <typename To, typename From>
__device__ __forceinline__ To cvt(From v) {
  return static_cast<To>(v);
}
template <>
__device__ __forceinline__ float cvt<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ double cvt<double, __nv_bfloat16>(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

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

// i mod n in [0, n) for any i, so that a halo wider than the extent (a
// 2-cell halo on a 2-, 3- or 4-cell axis) wraps as often as it must.
__device__ __forceinline__ int pmod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The streaming kernels (rbsor.cu's sweep, stencil7.cu's KA): a block of
// kTZ x kTileRows threads owns a kTZ x kTY (y, z) tile, z fastest (in KA a
// warp is one row of 32 z values and a thread owns rows ty and
// ty + kTileRows; in the sweep a thread owns a z-adjacent pair), and walks
// a chunk of x planes, staging each plane's tile with a periodic halo in
// shared memory (xfer.cu's transfer legs walk coarse planes with the same
// block over a coarse kTileRows x kTZ tile). A thread issues the loads of
// the next plane into registers right after the step's barrier, so they
// are in flight while it computes.
constexpr int kTZ = 32;
constexpr int kTY = 16;
constexpr int kTileRows = 8;
constexpr int kRowsPerThread = kTY / kTileRows;
constexpr int kTileThreads = kTZ * kTileRows;
constexpr int kTileWarps = kTileThreads / 32;
// the fewest blocks a streaming launch aims for (about 15 per SM on 132
// SMs): the chunk of x planes a block walks shrinks, down to 4, until the
// grid has this many
constexpr long kMinBlocks = 2048;

inline dim3 tile_block() { return dim3(kTZ, kTileRows, 1); }

inline int tiles(int ny, int nz) { return ((nz + kTZ - 1) / kTZ) * ((ny + kTY - 1) / kTY); }

// x planes a block walks: `start` halved while the grid would have fewer
// than `min_blocks` blocks, but not below 4.
inline int tile_chunk(int nx, int ny, int nz, int start, long min_blocks = kMinBlocks) {
  int c = start;
  while (c > 4 && (long)tiles(ny, nz) * ((nx + c - 1) / c) < min_blocks) c /= 2;
  return c;
}

inline dim3 tile_grid(int nx, int ny, int nz, int chunk) {
  return dim3((nz + kTZ - 1) / kTZ, (ny + kTY - 1) / kTY, (nx + chunk - 1) / chunk);
}

// the x planes a block of KA (stencil7.cu) or of K11's colour update
// (rbsor.cu) walks: the chunk halves from 128 until the grid holds
// kKaMinBlocks blocks (or the chunk is 4); blocks an SM holds. Chosen for
// KA on an NVIDIA H100 80GB HBM3 at 700 W among 1024 to 8192 blocks, with
// and without the register cap: 4096 with six blocks an SM was the fastest
// or within noise of it for every epilogue at 256^3 and 512^3.
constexpr long kKaMinBlocks = 4096;
constexpr int kKaResident = 6;

inline int ka_chunk(int nx, int ny, int nz) { return tile_chunk(nx, ny, nz, 128, kKaMinBlocks); }

// The (y, z) window of the tile at (j0, k0) with an H-cell periodic halo:
// (kTY + 2H) x (kTZ + 2H) cells, row-major, z fastest. Thread `tid` stages
// cells tid + r * kTileThreads (r < kR, those below kN): `off` holds their
// offsets in a plane, from wrapped global indices.
template <int H>
struct TileWindow {
  static constexpr int kZ = kTZ + 2 * H;
  static constexpr int kY = kTY + 2 * H;
  static constexpr int kN = kZ * kY;
  static constexpr int kR = (kN + kTileThreads - 1) / kTileThreads;
  int off[kR];
  __device__ __forceinline__ TileWindow(int j0, int k0, int ny, int nz, int tid) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int e = tid + r * kTileThreads;
      const int j = pmod(j0 - H + e / kZ, ny), k = pmod(k0 - H + e % kZ, nz);
      off[r] = j * nz + k;
    }
  }
  __device__ __forceinline__ static bool has(int r, int tid) {
    return tid + r * kTileThreads < kN;
  }
};

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
// Every thread of the block (NWARPS warps, 32 threads a row) must call this.
template <typename T, int NWARPS = kWarps>
__device__ __forceinline__ void block_partials(T a, T b, T* pa, T* pb) {
  __shared__ T sa[NWARPS];
  __shared__ T sb[NWARPS];
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
    a = lane < NWARPS ? sa[lane] : T(0);
    b = lane < NWARPS ? sb[lane] : T(0);
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
