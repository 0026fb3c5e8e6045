// KA `stencil7`: the periodic 7-point Laplacian star with eight epilogues.
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
//   K9 + the Chebyshev smoother's step (cheb)     x' = x + d', with
//       (poissbox_tpu/solvers/mg.py:408, the      d' = r / theta (the first
//       recurrence the JAX package writes in      step from a given x),
//       jnp around _residual)                     c1 d + c2 r (a middle or
//                                                 the last step), r = b - A x
//   K12 _pupd_dot, _pupd_dot_pan                  CG's deferred search
//       (_pupd_lapl_dot_kernel_fy/_pan) and       direction p' = (v - zs) +
//       stencil_inplace.py's _pupd_matvec_stream  beta * p_old, written with
//                                                 y = A p' and the partials of
//                                                 <p', A p'>
// and carries stencil_inplace.py's K1'/K2' (_lapl_stream: the TPU's
// streamed K1 and K2 for large fields) as K1 and K2 out of place.
//
// K12 is the star with an input prologue: the kernel is templated on a
// loader, and K12's loader forms p' = (v - zs) + beta * p_old once a cell,
// as the cell is staged in shared memory, in _pupd_lapl_dot_kernel_fy's
// grouping. beta and zs are read on the device from a 2-element tensor, as
// K8 reads alpha, so the host never waits for them.
//
// Types: float32 and float64 in every epilogue (K12 included); bfloat16 u
// and b in the residual, Jacobi and Chebyshev epilogues (the bf16
// pre-smooths of the Chebyshev and multi-sweep Jacobi smoothers at
// 512^3-class sizes). A bf16
// value is upcast to float32, the star and the epilogue run in float32, and
// the result rounds once (RNE) at the store, as KB's bf16 colour updates do.
// The star keeps _star_into's grouping,
//   ((u[i-1]+u[i+1])*ivx + (u[j-1]+u[j+1])*ivy) + (u[k-1]+u[k+1])*ivz
//   - 2*(ivx+ivy+ivz)*u,
// and the library is built with --fmad=false, so the kernel rounds as the
// plain version in ops/stencil_cuda.py does: the fields are bit-equal to it.
// The dot's partials are sums in another order than torch.sum's.
//
// The Chebyshev epilogues (one launch a step, in place of K9 and torch's
// elementwise ops) round where that chain rounds on the card, so the
// smoothed iterate is bit-equal to it: r as K9 stores it (to bf16 in a
// bf16 step); r / theta as torch divides by a host scalar, a multiply by
// its reciprocal taken in double and rounded to C; c1 d and c2 r each
// rounded to the field's type, then
// their sum, then x + d'. The scalars arrive as the compute type C, as
// torch's kernels take a host scalar. Streams: the first step reads x (the
// star) and b and writes x' and d'; a middle step also reads d; the last
// reads x, b and d and writes x' alone. Where d is x (the step after the
// closed-form first step from zero, x = d = b / theta), d is not read
// again: its value is the star's centre.
//
// Bound on an H100 SXM (3.35 TB/s): the star reads u and writes y, 2 field
// passes (3 for the residual and the Jacobi sweep, which also read b). At
// 256^3 f32 that is 2 x 67 MB = 0.040 ms for K1/K2 and 0.060 ms for K9 and
// K10; the arithmetic (9 flops a point) is far below the compute roof. K12
// reads v and p_old and writes p' and A p', 4 passes: 0.080 ms at 256^3
// f32, 0.641 ms at 512^3. A Chebyshev step moves 4 passes (first, last) or
// 5 (middle): at 512^3 f32 0.641 and 0.801 ms, a bf16 last step 0.320 ms
// (0.240 where d is x, 3 passes).
//
// Design: streamed along x, on the geometry of rbsor.cu's sweep
// (common.cuh: tile_block, tile_grid, tile_chunk, TileWindow). A block of
// 256 threads owns a 32 x 16 (y, z) tile, z fastest, two rows a thread,
// and walks a chunk of x planes (ka_chunk:
// about kKaMinBlocks = 4096 blocks, 64 planes at 512^3, 8 at 256^3; at most
// 40 registers a thread, so six blocks share an SM). The plane at
// hand sits in shared memory with a 1-cell periodic (y, z) halo, in a ring
// of three slots, so one barrier a plane suffices (the slot written in a
// step is never the one a thread still in the step before reads). A thread
// keeps its points' u[x-1] in registers from the step before and reads
// u[x+1] at its own cells of the next plane's slot, so the x neighbours
// cost no extra load; each u value is read from HBM about once (the halo
// cells of neighbouring tiles and the plane before a chunk come from L2).
// The next plane's window (and b at the owned points) is loaded into
// registers right after the step's barrier, so it is in flight while the
// step computes. The dot is summed over the chunk in each thread and
// written as one partial per block, at most a few thousand at 512^3, summed
// by the wrapper with torch.sum in the working type (C: float for bf16).
// Planes advance by compare and select; `%` is taken only before the loop.
#include "common.cuh"

namespace poissbox {

enum Epilogue {
  kApply = 0,
  kApplyDot = 1,
  kResidual = 2,
  kJacobi = 3,
  kPUpdDot = 4,
  kChebFirst = 5,
  kChebMiddle = 6,
  kChebLast = 7
};

// The field the star reads: u itself (K1, K2, K9, K10). `fetch` loads
// what a cell needs, `value` forms the cell's value from it, in C.
template <typename T>
struct LoadField {
  using C = typename Compute<T>::type;
  using Raw = T;
  const T* u;
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ Raw fetch(size_t i) const { return u[i]; }
  __device__ __forceinline__ C value(Raw r) const { return cvt<C>(r); }
};

// K12's prologue: p' = (v - zs) + beta * p_old, with (beta, zs) = sc[0..1]
// read on the device. The two loads are staged raw, and p' is formed when
// the cell is stored to shared memory, so the loads stay in flight.
template <typename T>
struct LoadPUpdate {
  struct Raw {
    T v, p;
  };
  const T* v;
  const T* p;
  const T* sc;
  T beta, zs;
  __device__ __forceinline__ void prepare() {
    beta = sc[0];
    zs = sc[1];
  }
  __device__ __forceinline__ Raw fetch(size_t i) const { return Raw{v[i], p[i]}; }
  __device__ __forceinline__ T value(Raw r) const { return (r.v - zs) + beta * r.p; }
};

// y = star(load) over the block's tile and chunk (see the header; the chunk
// is common.cuh's ka_chunk); `y2` receives K12's p' or the Chebyshev
// step's d' at the points owned, `part` one partial of the dot. `dn` is
// the Chebyshev step's d (null: d is x). The epilogue's scalars: wa is
// K10's winv, the Chebyshev step's c2 (the first step's 1 / theta); wb its
// c1.
template <typename T, int EPI, typename Load>
__global__ void __launch_bounds__(kTileThreads, kKaResident)
stencil7_kernel(Load load, const T* __restrict__ b, const T* __restrict__ dn,
                T* __restrict__ y, T* __restrict__ y2,
                typename Compute<T>::type* __restrict__ part, int nx, int ny, int nz, int chunk,
                typename Compute<T>::type ivx, typename Compute<T>::type ivy,
                typename Compute<T>::type ivz, typename Compute<T>::type center,
                typename Compute<T>::type wa, typename Compute<T>::type wb) {
  using C = typename Compute<T>::type;
  using UW = TileWindow<1>;
  using Raw = typename Load::Raw;
  constexpr bool kDot = EPI == kApplyDot || EPI == kPUpdDot;
  constexpr bool kCheb = EPI == kChebFirst || EPI == kChebMiddle || EPI == kChebLast;
  constexpr bool kB = EPI == kResidual || EPI == kJacobi || kCheb;
  constexpr bool kD = EPI == kChebMiddle || EPI == kChebLast;  // reads d
  const bool d_is_x = dn == nullptr;
  __shared__ C us[3][UW::kN];
  const int tid = threadIdx.x + kTZ * threadIdx.y;
  const int j0 = blockIdx.y * kTY, k0 = blockIdx.x * kTZ;
  const int i0 = blockIdx.z * chunk;
  const int n = min(chunk, nx - i0);
  const size_t plane = (size_t)ny * nz;
  const UW uw(j0, k0, ny, nz, tid);
  load.prepare();
  // the points owned: rows threadIdx.y + h * kTileRows of the tile
  const int kk = k0 + threadIdx.x;
  bool own[kRowsPerThread];
  size_t ooff[kRowsPerThread];
  int oc[kRowsPerThread];
#pragma unroll
  for (int h = 0; h < kRowsPerThread; ++h) {
    const int r = threadIdx.y + h * kTileRows;
    own[h] = j0 + r < ny && kk < nz;
    ooff[h] = (size_t)(j0 + r) * nz + kk;
    oc[h] = (r + 1) * UW::kZ + threadIdx.x + 1;
  }
  auto next = [nx](int q) { return q + 1 == nx ? 0 : q + 1; };

  // the register stage: the window of a plane, b (and d) at the points owned
  Raw ur[UW::kR];
  T br[kRowsPerThread];
  T dr[kRowsPerThread];
  auto stage_u = [&](int q) {
    const size_t base = (size_t)q * plane;
#pragma unroll
    for (int rr = 0; rr < UW::kR; ++rr)
      if (UW::has(rr, tid)) ur[rr] = load.fetch(base + uw.off[rr]);
  };
  auto stage_b = [&](int q) {
    if constexpr (kB) {
      const size_t base = (size_t)q * plane;
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h)
        if (own[h]) br[h] = b[base + ooff[h]];
    }
    if constexpr (kD) {
      const size_t base = (size_t)q * plane;
      if (!d_is_x) {
#pragma unroll
        for (int h = 0; h < kRowsPerThread; ++h)
          if (own[h]) dr[h] = dn[base + ooff[h]];
      }
    }
  };
  auto put = [&](C* dst) {
#pragma unroll
    for (int rr = 0; rr < UW::kR; ++rr)
      if (UW::has(rr, tid)) dst[tid + rr * kTileThreads] = load.value(ur[rr]);
  };

  // plane i0 in slot 0; the owned centres of plane i0-1; plane i0+1 and b
  // of plane i0 staged
  int qi = i0;  // the wrapped plane i of the step (i0 < nx)
  stage_u(qi);
  put(us[0]);
  C um[kRowsPerThread];  // u[x-1] at the points owned
  {
    const size_t base = (size_t)pmod(i0 - 1, nx) * plane;
#pragma unroll
    for (int h = 0; h < kRowsPerThread; ++h)
      um[h] = own[h] ? load.value(load.fetch(base + ooff[h])) : C(0);
  }
  stage_u(next(qi));
  stage_b(qi);
  int s0 = 0, s1 = 1;  // the slots of planes i and i+1
  C dot = C(0);
  // Step t (plane i = i0 + t): store the staged plane i+1, one barrier,
  // stage plane i+2 and b of plane i+1, compute plane i.
  for (int t = 0; t < n; ++t) {
    put(us[s1]);
    T bv[kRowsPerThread], dv[kRowsPerThread];
    if constexpr (kB) {
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h) bv[h] = br[h];
    }
    if constexpr (kD) {
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h) dv[h] = dr[h];
    }
    __syncthreads();
    const int q1 = next(qi);
    if (t + 1 < n) {
      stage_u(next(q1));
      stage_b(q1);
    }
    const C* u0 = us[s0];
    const C* up = us[s1];
#pragma unroll
    for (int h = 0; h < kRowsPerThread; ++h) {
      if (!own[h]) continue;
      const int o = oc[h];
      const C c = u0[o];
      C acc = (um[h] + up[o]) * ivx;
      acc = acc + (u0[o - UW::kZ] + u0[o + UW::kZ]) * ivy;
      acc = acc + (u0[o - 1] + u0[o + 1]) * ivz;
      C out = acc - center * c;
      if (EPI == kResidual) out = cvt<C>(bv[h]) - out;
      if (EPI == kJacobi) out = c + wa * (cvt<C>(bv[h]) - out);
      const size_t g = (size_t)qi * plane + ooff[h];
      if constexpr (kCheb) {
        const C r = cvt<C>(cvt<T>(cvt<C>(bv[h]) - out));  // K9's stored r
        T d1;
        if constexpr (EPI == kChebFirst) {
          d1 = cvt<T>(r * wa);
        } else {
          const C d0 = d_is_x ? c : cvt<C>(dv[h]);
          d1 = cvt<T>(cvt<C>(cvt<T>(wb * d0)) + cvt<C>(cvt<T>(wa * r)));
        }
        y[g] = cvt<T>(c + cvt<C>(d1));
        if constexpr (EPI != kChebLast) y2[g] = d1;
      } else {
        y[g] = cvt<T>(out);
      }
      if constexpr (EPI == kPUpdDot) y2[g] = cvt<T>(c);
      if (kDot) dot += c * out;
      um[h] = c;
    }
    const int s2 = 3 - s0 - s1;
    s0 = s1;
    s1 = s2;
    qi = q1;
  }
  if constexpr (kDot) block_partials<C, kTileWarps>(dot, C(0), part, (C*)nullptr);
}

template <typename T, int EPI, typename Load>
cudaError_t launch_ka(cudaStream_t stream, const Load& load, const void* b, const void* dn,
                      void* y, void* y2, void* part, int nx, int ny, int nz, double ivx,
                      double ivy, double ivz, double center, double wa, double wb) {
  using C = typename Compute<T>::type;
  const int chunk = ka_chunk(nx, ny, nz);
  stencil7_kernel<T, EPI, Load><<<tile_grid(nx, ny, nz, chunk), tile_block(), 0, stream>>>(
      load, static_cast<const T*>(b), static_cast<const T*>(dn), static_cast<T*>(y),
      static_cast<T*>(y2), static_cast<C*>(part), nx, ny, nz, chunk, C(ivx), C(ivy), C(ivz),
      C(center), C(wa), C(wb));
  return cudaGetLastError();
}

template <typename T, int EPI>
cudaError_t launch_epi(cudaStream_t stream, const void* u, const void* b, void* y, void* part,
                       int nx, int ny, int nz, double ivx, double ivy, double ivz,
                       double center, double winv) {
  return launch_ka<T, EPI>(stream, LoadField<T>{static_cast<const T*>(u)}, b, nullptr, y,
                           nullptr, part, nx, ny, nz, ivx, ivy, ivz, center, winv, 0.0);
}

// One Chebyshev step (kind 0 first, 1 middle, 2 last; see the header). c2
// is theta for the first step, whose d' = r * C(1 / theta), the reciprocal
// taken in double and rounded to C, as torch takes it for a division by a
// host scalar.
template <typename T>
cudaError_t launch_cheb(int kind, cudaStream_t stream, const void* x, const void* b,
                        const void* d, void* xout, void* dout, int nx, int ny, int nz,
                        double ivx, double ivy, double ivz, double center, double c1,
                        double c2) {
  const LoadField<T> load{static_cast<const T*>(x)};
  switch (kind) {
    case 0:
      return launch_ka<T, kChebFirst>(stream, load, b, nullptr, xout, dout, nullptr, nx, ny, nz,
                                      ivx, ivy, ivz, center, 1.0 / c2, 0.0);
    case 1:
      return launch_ka<T, kChebMiddle>(stream, load, b, d, xout, dout, nullptr, nx, ny, nz, ivx,
                                       ivy, ivz, center, c2, c1);
    case 2:
      return launch_ka<T, kChebLast>(stream, load, b, d, xout, nullptr, nullptr, nx, ny, nz, ivx,
                                     ivy, ivz, center, c2, c1);
    default:
      return cudaErrorInvalidValue;
  }
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
  return launch_ka<T, kPUpdDot>(stream, load, nullptr, nullptr, y, pout, part, nx, ny, nz, ivx,
                                ivy, ivz, center, 0.0, 0.0);
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

// Number of blocks (and of reduction partials) of a KA launch over the
// grid (ops/stencil_cuda.ka_blocks computes the same).
int poissbox_num_blocks(int nx, int ny, int nz) {
  const dim3 g = poissbox::tile_grid(nx, ny, nz, poissbox::ka_chunk(nx, ny, nz));
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

// One Chebyshev step on r = b - A x: x' = x + d' into xout and d' into
// dout (not the last step), d' = r / c2 (kind 0, the first step from x; c2
// is theta), c1 * d + c2 * r (kind 1, a middle step; kind 2, the last). d
// null in kinds 1 and 2: d is x. dtype 0 = float32, 1 = float64,
// 2 = bfloat16. Returns the cudaError_t of the launch (0 on success).
int poissbox_cheb(int dtype, int kind, int device, void* stream, const void* x, const void* b,
                  const void* d, void* xout, void* dout, int nx, int ny, int nz, double ivx,
                  double ivy, double ivz, double center, double c1, double c2) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == poissbox::kF32)
    err = poissbox::launch_cheb<float>(kind, s, x, b, d, xout, dout, nx, ny, nz, ivx, ivy, ivz,
                                       center, c1, c2);
  else if (dtype == poissbox::kF64)
    err = poissbox::launch_cheb<double>(kind, s, x, b, d, xout, dout, nx, ny, nz, ivx, ivy,
                                        ivz, center, c1, c2);
  else if (dtype == poissbox::kBF16)
    err = poissbox::launch_cheb<__nv_bfloat16>(kind, s, x, b, d, xout, dout, nx, ny, nz, ivx,
                                               ivy, ivz, center, c1, c2);
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
