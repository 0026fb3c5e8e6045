// `gmres`: the classical Gram-Schmidt step of GMRES(m) and FGMRES(m)
// (solvers/gmres.py), over the basis rows built so far:
//   gs_dots:   h_i = <V_i, w> for i < rows, as one partial a block and row;
//   gs_update: out = w - sum_{i<rows} h_i V_i (in order of i), and one
//              partial of ||out||^2 a block.
// The same update forms a cycle's solution, x + Z y = x - sum (-y_i) Z_i.
//
// Replaces no TPU kernel: the JAX package's GMRES
// (poissbox_tpu/solvers/gmres.py:145, :150) orthogonalises with two
// jnp.tensordot products over the whole zero-padded (m+1)-row basis, and
// the port's first version took them to cuBLAS (dot and gemv kernels),
// reading every unbuilt row as zeros. Here step j reads rows 0..j only.
//
// Bound by bytes on an H100 SXM (3.35 TB/s): gs_dots reads each row once
// and w once for every R rows, rows + ceil(rows / R) field passes;
// gs_update reads each row and w and writes out, rows + 2. Design: a
// grid-stride pass over the flat fields in 16-byte packs (4 floats or 2
// doubles; single values where the field's size is not a multiple of the
// pack), with as many blocks as the SMs hold at once. R is the least of 1,
// 2, 4 and 8 that covers the rows (8 beyond): a thread starts the loads of
// its R rows before it uses them and keeps R accumulators in registers, so
// small row counts keep few registers and many threads in flight. Every
// product accumulates by fma in the field's type (f32 or f64). h is read
// from device memory, so the host never waits; the wrapper sums the
// partials with torch.sum, so no atomics and the same result every run.
#include "common.cuh"

namespace poissbox {

enum GsKind { kGsDots = 0, kGsUpdate = 1 };

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load_pack(const T* p, size_t i) {
  return reinterpret_cast<const Pack<T, W>*>(p)[i];
}

// fused multiply-adds, rounded once: --fmad=false leaves these alone
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// part[block * rows + i] = this block's share of <V_i, w>. n counts packs
// of W values; row i of V starts i * n packs from V.
template <typename T, int W, int R>
__global__ void __launch_bounds__(kThreads)
gs_dots_kernel(const T* __restrict__ V, const T* __restrict__ w, T* __restrict__ part,
               int rows, size_t n) {
  __shared__ T red[R][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int nr = min(R, rows - r0);
    const T* v0 = V + (size_t)r0 * n * W;
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = T(0);
    for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
      const Pack<T, W> x = load_pack<T, W>(w, i);
      Pack<T, W> v[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) v[r] = load_pack<T, W>(v0 + (size_t)r * n * W, i);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) {
#pragma unroll
          for (int k = 0; k < W; ++k) acc[r] = fma_rn(v[r].v[k], x.v[k], acc[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T s = warp_sum(acc[r]);
      if (lane == 0) red[r][warp] = s;
    }
    __syncthreads();
    if ((int)threadIdx.x < nr) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += red[threadIdx.x][k];
      part[(size_t)blockIdx.x * rows + r0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// out = w - sum_{i<rows} h_i V_i, row by row in order, and this block's
// partial of ||out||^2 in part[block]. out may be a row of V past the
// rows read.
template <typename T, int W, int R>
__global__ void __launch_bounds__(kThreads)
gs_update_kernel(const T* __restrict__ V, const T* __restrict__ h, const T* w, T* out,
                 T* __restrict__ part, int rows, size_t n) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  T ss = T(0);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    Pack<T, W> a = load_pack<T, W>(w, i);
    for (int r0 = 0; r0 < rows; r0 += R) {
      const int nr = min(R, rows - r0);
      const T* v0 = V + (size_t)r0 * n * W;
      Pack<T, W> v[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) v[r] = load_pack<T, W>(v0 + (size_t)r * n * W, i);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) {
          const T c = -__ldg(h + r0 + r);
#pragma unroll
          for (int k = 0; k < W; ++k) a.v[k] = fma_rn(c, v[r].v[k], a.v[k]);
        }
    }
    reinterpret_cast<Pack<T, W>*>(out)[i] = a;
#pragma unroll
    for (int k = 0; k < W; ++k) ss = fma_rn(a.v[k], a.v[k], ss);
  }
  block_partials<T>(ss, ss, part, nullptr);
}

struct GsArgs {
  int kind, rows, device, blocks;
  size_t n;  // values a row
  cudaStream_t stream;
  const void *V, *h, *w;
  void *out, *part;
};

// rows a pass: the least of 1, 2, 4, 8 that covers `rows`, 8 beyond
inline int pass_rows(int rows) { return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8; }

template <typename K>
int resident_blocks(K kernel, size_t packs, int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms <= 0)
    sms = 132;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
          cudaSuccess ||
      per_sm <= 0)
    per_sm = 1;
  const size_t need = (packs + kThreads - 1) / kThreads;
  const size_t cap = (size_t)sms * per_sm;
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

// blocks > 0: launch on that many blocks; blocks == 0: return how many
// blocks a launch takes (as a non-negative count) without launching
template <typename T, int W, int R>
int gs_run(const GsArgs& a) {
  const size_t packs = a.n / W;
  if (a.blocks == 0)
    return a.kind == kGsDots ? resident_blocks(gs_dots_kernel<T, W, R>, packs, a.device)
                             : resident_blocks(gs_update_kernel<T, W, R>, packs, a.device);
  if (a.kind == kGsDots)
    gs_dots_kernel<T, W, R><<<a.blocks, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.V), static_cast<const T*>(a.w), static_cast<T*>(a.part),
        a.rows, packs);
  else
    gs_update_kernel<T, W, R><<<a.blocks, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.V), static_cast<const T*>(a.h), static_cast<const T*>(a.w),
        static_cast<T*>(a.out), static_cast<T*>(a.part), a.rows, packs);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int gs_by_rows(const GsArgs& a) {
  switch (pass_rows(a.rows)) {
    case 1: return gs_run<T, W, 1>(a);
    case 2: return gs_run<T, W, 2>(a);
    case 4: return gs_run<T, W, 4>(a);
    default: return gs_run<T, W, 8>(a);
  }
}

template <typename T>
int gs_by_pack(const GsArgs& a, int vec) {
  constexpr int kPack = 16 / sizeof(T);
  if (vec == kPack && a.n % kPack == 0) return gs_by_rows<T, kPack>(a);
  if (vec == 1) return gs_by_rows<T, 1>(a);
  return -(int)cudaErrorInvalidValue;
}

inline int gs_dispatch(int dtype, int vec, const GsArgs& a) {
  if (a.rows < 1 || (a.kind != kGsDots && a.kind != kGsUpdate))
    return -(int)cudaErrorInvalidValue;
  if (dtype == kF32) return gs_by_pack<float>(a, vec);
  if (dtype == kF64) return gs_by_pack<double>(a, vec);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace poissbox

extern "C" {

// Blocks (and partials a row) of a launch of kernel `kind` (0 dots, 1
// update) over rows of n values packed `vec` at a time (16 / itemsize, or
// 1); a negative cudaError_t on arguments no launch takes.
int poissbox_gmres_blocks(int kind, int dtype, int vec, int rows, long long n, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  poissbox::GsArgs a{kind, rows, device, 0, (size_t)n, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr};
  return poissbox::gs_dispatch(dtype, vec, a);
}

// dtype: 0 = float32, 1 = float64. V holds the basis rows back to back
// (row i at V + i * n values), w and part on the same device; part has
// blocks * rows values. Returns the cudaError_t of the launch (0 on
// success).
int poissbox_gmres_dots(int dtype, int vec, int device, void* stream, const void* V,
                        const void* w, void* part, int rows, long long n, int blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  poissbox::GsArgs a{poissbox::kGsDots, rows, device, blocks, (size_t)n,
                     static_cast<cudaStream_t>(stream), V, nullptr, w, nullptr, part};
  const int rc = poissbox::gs_dispatch(dtype, vec, a);
  return rc < 0 ? -rc : rc;
}

// out = w - sum_{i<rows} h_i V_i and one partial of ||out||^2 a block in
// part (blocks values); h holds rows values on the device.
int poissbox_gmres_update(int dtype, int vec, int device, void* stream, const void* V,
                          const void* h, const void* w, void* out, void* part, int rows,
                          long long n, int blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  poissbox::GsArgs a{poissbox::kGsUpdate, rows, device, blocks, (size_t)n,
                     static_cast<cudaStream_t>(stream), V, h, w, out, part};
  const int rc = poissbox::gs_dispatch(dtype, vec, a);
  return rc < 0 ? -rc : rc;
}

}  // extern "C"
