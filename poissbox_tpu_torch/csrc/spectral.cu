// `symbol_scale`: the one-rank spectral solves' multiply by the operator's
// pseudo-inverse symbol, in place on the rfftn half spectrum.
//
// Replaces no TPU kernel: the JAX package builds the symbol with jnp over
// the whole spectrum (poissbox_tpu/solvers/fft.py:34 _inv_eigenvalues,
// :465 compact_inv_eigenvalues) and multiplies by it. The symbol of a
// mode is a few products of per-axis 1-D tables (solvers/fft.py builds
// and caches them), so this kernel evaluates it in registers while the
// half spectrum streams through once. Two forms, a template argument:
//   kCompact (the 6th-order compact Laplacian), rows DG and II:
//     S = (DGx IIy) IIz + (IIx DGy) IIz + (IIx IIy) DGz
//   kSum (the 7-point Laplacian), row L:
//     S = (Lx + Ly) + Lz
// then inv = |S| > tol ? 1/S : 0 with tol = rel * peak (peak a device
// scalar, so the host never waits for it; rel 0 in the 7-point form) and
// both halves of the complex value times inv. The grouping is the plain
// version's (ops/spectral_cuda.py), which --fmad=false keeps bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): each complex value read once and
// written once, 512*512*257 complex64 = 1.078 GB, 0.322 ms. Design: a
// thread takes kUnroll 16-byte vectors (two complex64 or one complex128)
// of the half spectrum in memory order, a warp's loads adjacent, all loads
// issued before any arithmetic. The layout is any permutation of the
// axes (cuFFT's rfftn leaves the half axis outermost: memory order kz,
// kx, ky), so the index is flat and each vector finds its mode by two
// divisions by the inner extents (the second value of a complex64 pair
// steps the innermost axis, wrapping outwards). The tables are a few KB,
// read through the read-only path. An odd count of complex64 values
// leaves one, taken by thread 0.
#include "common.cuh"

#include <cstdint>

namespace poissbox {

enum SymbolForm { kCompact = 0, kSum = 1 };

constexpr int kUnroll = 2;

// 16 bytes of complex values: two complex64 or one complex128
template <typename T>
struct CVec;
template <>
struct CVec<float> {
  using type = float4;
  static constexpr int kN = 2;
};
template <>
struct CVec<double> {
  using type = double2;
  static constexpr int kN = 1;
};

// S at mode (i, j, k); row r of the tables starts at r * (nx + ny + nz),
// each row holding its x, y and z tables back to back
template <typename T, int FORM>
__device__ __forceinline__ T symbol_at(const T* __restrict__ tab, int nx, int ny, int nz,
                                       int i, int j, int k) {
  const T* ax = tab;
  const T* ay = tab + nx;
  const T* az = ay + ny;
  if constexpr (FORM == kSum) {
    return (__ldg(ax + i) + __ldg(ay + j)) + __ldg(az + k);
  } else {
    const int row = nx + ny + nz;
    const T dgx = __ldg(ax + i), dgy = __ldg(ay + j), dgz = __ldg(az + k);
    const T iix = __ldg(ax + row + i), iiy = __ldg(ay + row + j), iiz = __ldg(az + row + k);
    return (dgx * iiy) * iiz + (iix * dgy) * iiz + (iix * iiy) * dgz;
  }
}

template <typename T>
__device__ __forceinline__ T pinv(T s, T tol) {
  const T mag = s < T(0) ? -s : s;
  return mag > tol ? T(1) / s : T(0);
}

// The half spectrum's memory order: extents n0 (outermost) .. n2
// (innermost, stride 1) of the axes a0, a1, a2 (0 = x, 1 = y, 2 = z)
struct Layout {
  int n0, n1, n2;
  int a0, a1, a2;
};

// The mode at flat memory index e, as indices q0, q1, q2 along the memory
// axes, and the step to e + 1
template <typename I>
struct Mode {
  int q0, q1, q2;
  __device__ __forceinline__ Mode(I e, const Layout& L) {
    const I r = e / (I)L.n2;
    q2 = (int)(e - r * (I)L.n2);
    q0 = (int)(r / (I)L.n1);
    q1 = (int)(r - (I)q0 * (I)L.n1);
  }
  __device__ __forceinline__ void step(const Layout& L) {
    if (++q2 == L.n2) {
      q2 = 0;
      if (++q1 == L.n1) {
        q1 = 0;
        ++q0;
      }
    }
  }
  // the index along axis a
  __device__ __forceinline__ int along(int a, const Layout& L) const {
    return a == L.a0 ? q0 : (a == L.a1 ? q1 : q2);
  }
};

template <typename T, int FORM, typename I>
__device__ __forceinline__ T pinv_at(const Mode<I>& m, const Layout& L,
                                     const T* __restrict__ tab, T tol, int nx, int ny,
                                     int nz) {
  return pinv(symbol_at<T, FORM>(tab, nx, ny, nz, m.along(0, L), m.along(1, L),
                                 m.along(2, L)),
              tol);
}

template <typename T, int FORM, typename I>
__device__ __forceinline__ void scale_vec(typename CVec<T>::type& v, I e, const Layout& L,
                                          const T* __restrict__ tab, T tol, int nx, int ny,
                                          int nz) {
  Mode<I> m(e, L);
  const T inv0 = pinv_at<T, FORM, I>(m, L, tab, tol, nx, ny, nz);
  if constexpr (CVec<T>::kN == 2) {
    m.step(L);
    const T inv1 = pinv_at<T, FORM, I>(m, L, tab, tol, nx, ny, nz);
    v.x = v.x * inv0;
    v.y = v.y * inv0;
    v.z = v.z * inv1;
    v.w = v.w * inv1;
  } else {
    v.x = v.x * inv0;
    v.y = v.y * inv0;
  }
}

template <typename T, int FORM, typename I>
__global__ void __launch_bounds__(kThreads)
symbol_scale_kernel(typename CVec<T>::type* __restrict__ xh, const T* __restrict__ tab,
                    const T* __restrict__ peak, T rel, int nx, int ny, int nz, Layout L,
                    I nvec, I ncplx) {
  using V = typename CVec<T>::type;
  constexpr int kN = CVec<T>::kN;
  const T tol = rel * peak[0];
  const I base = (I)blockIdx.x * (I)(kThreads * kUnroll) + (I)threadIdx.x;
  V v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const I q = base + (I)(u * kThreads);
    if (q < nvec) v[u] = xh[q];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const I q = base + (I)(u * kThreads);
    if (q < nvec) {
      scale_vec<T, FORM, I>(v[u], q * (I)kN, L, tab, tol, nx, ny, nz);
      xh[q] = v[u];
    }
  }
  if (kN == 2 && blockIdx.x == 0 && threadIdx.x == 0 && nvec * (I)kN < ncplx) {
    // the last complex64 value of an odd count: (re, im) as a pair of T
    T* last = reinterpret_cast<T*>(xh) + 2 * (ncplx - 1);
    const T inv = pinv_at<T, FORM, I>(Mode<I>(ncplx - 1, L), L, tab, tol, nx, ny, nz);
    last[0] = last[0] * inv;
    last[1] = last[1] * inv;
  }
}

template <typename T, int FORM, typename I>
cudaError_t launch(cudaStream_t s, void* xh, const void* tab, const void* peak, double rel,
                   int nx, int ny, int nz, const Layout& L, long long ncplx) {
  constexpr int kN = CVec<T>::kN;
  const long long nvec = ncplx / kN;
  const long long per_block = (long long)kThreads * kUnroll;
  const long long blocks = nvec > 0 ? (nvec + per_block - 1) / per_block : 1;
  symbol_scale_kernel<T, FORM, I><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<typename CVec<T>::type*>(xh), static_cast<const T*>(tab),
      static_cast<const T*>(peak), static_cast<T>(rel), nx, ny, nz, L, (I)nvec, (I)ncplx);
  return cudaGetLastError();
}

template <typename T, int FORM>
cudaError_t launch_any(cudaStream_t s, void* xh, const void* tab, const void* peak, double rel,
                       int nx, int ny, int nz, const Layout& L, long long ncplx) {
  // 32-bit index arithmetic wherever the flat index, and a last block's
  // reach past it, fit (the divisions are the kernel's only integer work)
  if (ncplx < (1LL << 31))
    return launch<T, FORM, uint32_t>(s, xh, tab, peak, rel, nx, ny, nz, L, ncplx);
  return launch<T, FORM, uint64_t>(s, xh, tab, peak, rel, nx, ny, nz, L, ncplx);
}

}  // namespace poissbox

extern "C" {

// xh: the rfftn half spectrum, (nx, ny, nz/2+1) complex values of the
// dtype (0 = float32: complex64, 1 = float64: complex128), dense and
// 16-byte aligned, its axes in memory the order a0, a1, a2 (outermost
// first; 0 = x, 1 = y, 2 = z), scaled in place. tab: the dtype's tables,
// one row (kSum) or two (kCompact) of nx + ny + nz. peak: a device scalar
// of the dtype. Returns the cudaError_t of the launch (0 on success).
int poissbox_symbol_scale(int dtype, int form, int device, void* stream, void* xh,
                          const void* tab, const void* peak, double rel, int nx, int ny,
                          int nz, int a0, int a1, int a2) {
  using namespace poissbox;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ext[3] = {nx, ny, nz / 2 + 1};
  if (a0 < 0 || a1 < 0 || a2 < 0 || a0 > 2 || a1 > 2 || a2 > 2 || a0 == a1 || a0 == a2 ||
      a1 == a2)
    return (int)cudaErrorInvalidValue;
  const Layout L{ext[a0], ext[a1], ext[a2], a0, a1, a2};
  const long long ncplx = (long long)nx * ny * (nz / 2 + 1);
  if (dtype == kF32 && form == kCompact)
    return (int)launch_any<float, kCompact>(s, xh, tab, peak, rel, nx, ny, nz, L, ncplx);
  if (dtype == kF32 && form == kSum)
    return (int)launch_any<float, kSum>(s, xh, tab, peak, rel, nx, ny, nz, L, ncplx);
  if (dtype == kF64 && form == kCompact)
    return (int)launch_any<double, kCompact>(s, xh, tab, peak, rel, nx, ny, nz, L, ncplx);
  if (dtype == kF64 && form == kSum)
    return (int)launch_any<double, kSum>(s, xh, tab, peak, rel, nx, ny, nz, L, ncplx);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
