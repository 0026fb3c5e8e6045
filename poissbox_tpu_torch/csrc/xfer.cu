// `xfer`: the multigrid transfer legs of a kernel level, each whole in one
// launch, two modes.
//
// Replaces these TPU kernels of poissbox_tpu/ops/stencil_pallas.py, and the
// banded y/z contractions that followed and preceded them there
// (poissbox_tpu/solvers/mg.py restrict_mm / prolong_mm, axes (1, 2)):
//   K6  _resid_xrestrict (_resid_xrestrict_kernel)   mode restrict:
//       rc = R_z R_y R_x (b - A u) at (nx/2, ny/2, nz/2). Along each axis,
//       in the order x, y, z: c_I = (3 (f_2I + f_2I+1) + f_2I+2 + f_2I-1) / 8
//   K7  _xprolong_add (_xprolong_add_kernel)        mode prolong_add:
//       out = u + P_x P_z P_y e, e at (nx/2, ny/2, nz/2). Along each axis,
//       in the order y, z, x: the fine cell 2I takes 0.75 c_I + 0.25 c_I-1,
//       the fine cell 2I+1 0.75 c_I + 0.25 c_I+1
// Neither the full-size residual, nor the prolonged correction, nor any
// half-size intermediate is stored.
//
// Types: u may be narrower than b and e (the bf16 pre-smooth iterate of
// the 512^3-class cycle): it is upcast to b's (e's) type before any
// arithmetic, and the output is in b's (e's) type. Pairs (u, b/e):
// f32/f32, f64/f64, bf16/f32, bf16/f64.
//
// The residual keeps _star_ext's grouping: for cubic cells
// s = ((u[x-1] + u[x+1]) + (u[y-1] + u[y+1])) + (u[z-1] + u[z+1]) and
// star = s*ivx - (6*ivx)*u, otherwise the per-axis form of stencil7.cu.
// Every sum is rounded as the roll form of ops/transfer_cuda.py rounds it
// (residual_restrict_plain, prolong_add_plain), built with --fmad=false.
//
// Bound on an H100 SXM (3.35 TB/s), a fine level of 512^3 f32 with a bf16
// u: restrict reads u (268 MB) and b (537 MB) and writes the coarse
// residual (67 MB), 872 MB or 0.260 ms; prolong_add reads e (67 MB) and u
// (268 MB) and writes the f32 field (537 MB), also 0.260 ms. With an f32 u
// both are 1141 MB, 0.341 ms. Before this design each leg was a
// half-size field pass more, plus two cuBLAS contractions.
//
// Both kernels: a block of kTZ x kTileRows = 256 threads owns a coarse
// (y, z) tile of kCY x kCZ = 8 x 32 cells, one a thread, and walks a chunk
// of coarse x planes (xfer_chunk: 32 at 512^3, halved until the grid holds
// kMinBlocks blocks, down to 1). Every index wraps (pmod), so ragged
// tiles and levels down to 2 cells an axis need no special case.
//
// Design of restrict (restrict_kernel): a ring of four u planes in shared
// memory, each the fine tile (16 x 64) with a 2-cell periodic (y, z) halo,
// 20 x 68, u upcast as it is staged; one barrier a fine plane suffices,
// since the plane staged next never overwrites one still read, and the
// next plane's loads are issued into registers right after it. Each fine
// residual plane is computed over the tile and a 1-cell halo (18 x 66,
// 16 % more residuals than the tile, arithmetic and not device-memory
// bytes: b's halo cells come from L2), each point by one thread, which
// carries R_x in registers: r[2I-1], r[2I] and r[2I+1] from the planes
// before. When plane 2I+2 completes coarse plane I, R_x of the region goes
// to shared memory, one more barrier, and each thread forms its coarse
// cell from a 4 x 4 patch (y, then z) and writes it, a warp 32 coarse z
// values. b is read once per point and block.
//
// Design of prolong_add (prolong_add_kernel): the block stages each coarse
// plane's tile with a 1-cell halo (10 x 34) in a two-slot ring in shared
// memory, one barrier a coarse plane. Each thread owns four fine points of
// the 16 x 64 fine tile (rows ty and ty + 8, columns tx and tx + 32, so a
// warp reads u and writes out as 32 consecutive z values), forms P_z P_y e
// there from four coarse cells, and keeps it for three coarse planes in
// registers: with planes I-1, I and I+1 it writes fine planes 2I and 2I+1,
// u's values loaded one step ahead.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (utils.profiling.kernel_time,
// PERF.md section 6): at 512^3 with a bf16 u restrict 0.465-0.469 ms (56 %
// of its bound) and prolong_add 0.334-0.337 ms (77-78 %); with an f32 u
// 0.501-0.508 ms (67-68 %) and 0.391-0.397 ms (86-87 %). Each leg replaces about 1.6 ms of
// the former x-only kernel and two contractions. The restriction is held
// back by its instructions a point, not by shared-memory bandwidth:
// carrying u's centre in registers (5 shared loads a residual instead of
// 7) left it as fast with a bf16 u and slower with an f32 u (spills).
#include "common.cuh"

namespace poissbox {

enum XferMode { kRestrict = 0, kProlongAdd = 1 };

// a block's coarse (y, z) tile: one cell a thread
constexpr int kCZ = kTZ;
constexpr int kCY = kTileRows;
// restriction: the residual region (the fine tile with a 1-cell halo),
// points p = tid + h * kTileThreads, h < kRP, row-major
constexpr int kRZ = 2 * kCZ + 2;
constexpr int kRY = 2 * kCY + 2;
constexpr int kRN = kRZ * kRY;
constexpr int kRP = (kRN + kTileThreads - 1) / kTileThreads;
// restriction: the u window (the fine tile with a 2-cell halo), cells
// tid + r * kTileThreads, r < kUR
constexpr int kUZ = 2 * kCZ + 4;
constexpr int kUY = 2 * kCY + 4;
constexpr int kUN = kUZ * kUY;
constexpr int kUR = (kUN + kTileThreads - 1) / kTileThreads;
// prolongation: the coarse window (the coarse tile with a 1-cell halo)
constexpr int kEZ = kCZ + 2;
constexpr int kEY = kCY + 2;
constexpr int kEN = kEZ * kEY;
constexpr int kER = (kEN + kTileThreads - 1) / kTileThreads;

// the slots r < R of thread `tid` that hold a cell of an N-cell window
template <int N>
__device__ __forceinline__ bool in_window(int r, int tid) {
  return (r + 1) * kTileThreads <= N || tid + r * kTileThreads < N;
}

inline int coarse_tiles(int nyc, int nzc) {
  return ((nzc + kCZ - 1) / kCZ) * ((nyc + kCY - 1) / kCY);
}

// the coarse x planes a block of either leg walks: 32, halved while the
// grid would hold fewer than kMinBlocks blocks, down to one plane (the
// small levels: latency, not the halo planes' re-reads from L2, sets
// their time)
inline int xfer_chunk(int nxc, int nyc, int nzc) {
  int c = 32;
  while (c > 1 && (long)coarse_tiles(nyc, nzc) * ((nxc + c - 1) / c) < kMinBlocks) c /= 2;
  return c;
}

inline dim3 xfer_grid(int nxc, int nyc, int nzc, int chunk) {
  return dim3((nzc + kCZ - 1) / kCZ, (nyc + kCY - 1) / kCY, (nxc + chunk - 1) / chunk);
}

template <typename T>
constexpr size_t restrict_smem() {
  return (4 * kUN + kRN) * sizeof(T);
}

// rc = R_z R_y R_x (b - A u) over the (nx/2, ny/2, nz/2) output (see the
// header).
template <typename TU, typename T, bool ISO>
__global__ void __launch_bounds__(kTileThreads, sizeof(T) == 8 ? 2 : 3)
restrict_kernel(const TU* __restrict__ u, const T* __restrict__ b, T* __restrict__ out, int nx,
                int ny, int nz, int chunk, T ivx, T ivy, T ivz, T center, T six_iv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T(*us)[kUN] = reinterpret_cast<T(*)[kUN]>(smem);  // the ring of u planes
  T* rho = reinterpret_cast<T*>(smem) + 4 * kUN;     // R_x over the region
  const int tid = threadIdx.x + kTZ * threadIdx.y;
  const int nyc = ny / 2, nzc = nz / 2;
  const int J0 = blockIdx.y * kCY, K0 = blockIdx.x * kCZ;
  const int I0 = blockIdx.z * chunk;
  const int m = min(chunk, nx / 2 - I0);
  const size_t plane = (size_t)ny * nz;
  // offsets in a plane of the u window's cells this thread stages (fine
  // rows from 2 J0 - 2, columns from 2 K0 - 2) and of the residual points
  // it owns (from 2 J0 - 1, 2 K0 - 1)
  int uoff[kUR], boff[kRP];
#pragma unroll
  for (int r = 0; r < kUR; ++r) {
    const int w = tid + r * kTileThreads;
    if (in_window<kUN>(r, tid))
      uoff[r] = pmod(2 * J0 - 2 + w / kUZ, ny) * nz + pmod(2 * K0 - 2 + w % kUZ, nz);
  }
#pragma unroll
  for (int h = 0; h < kRP; ++h) {
    const int p = tid + h * kTileThreads;
    if (in_window<kRN>(h, tid))
      boff[h] = pmod(2 * J0 - 1 + p / kRZ, ny) * nz + pmod(2 * K0 - 1 + p % kRZ, nz);
  }
  const int f0 = 2 * I0 - 1;  // the first fine plane whose residual the block needs
  // ring slot of fine plane q (q >= f0 - 1)
  auto slot = [f0](int q) { return (q - f0 + 1) & 3; };
  // the wrapped index of the plane after wrapped index q: plane indices
  // advance one a step, so `%` is taken only before the loop
  auto next = [nx](int q) { return q + 1 == nx ? 0 : q + 1; };

  // the register stage: u plane i+1 and b at the points owned in plane i
  // of the next step (i = f0 + t); q is the wrapped index of plane i
  TU ur[kUR];
  T br[kRP];
  auto stage = [&](int q) {
    const TU* src = u + (size_t)next(q) * plane;
#pragma unroll
    for (int r = 0; r < kUR; ++r)
      if (in_window<kUN>(r, tid)) ur[r] = src[uoff[r]];
    const T* bsrc = b + (size_t)q * plane;
#pragma unroll
    for (int h = 0; h < kRP; ++h)
      if (in_window<kRN>(h, tid)) br[h] = bsrc[boff[h]];
  };
  int sq = pmod(f0, nx);  // the wrapped plane i of the next stage
  // r[2I-1], r[2I], r[2I+1] of each point owned
  T r_dn[kRP], r_even[kRP], r_odd[kRP];
  for (int q = f0 - 1; q <= f0; ++q) {
    const TU* src = u + (size_t)pmod(q, nx) * plane;
#pragma unroll
    for (int r = 0; r < kUR; ++r)
      if (in_window<kUN>(r, tid)) us[slot(q)][tid + r * kTileThreads] = cvt<T>(src[uoff[r]]);
  }
  stage(sq);
  sq = next(sq);
  // Step t (fine plane i = f0 + t): store the staged u plane i+1, one
  // barrier, stage the planes of step t + 1, take the residual at plane i.
  // One barrier suffices: a thread still in step t-1 reads u planes
  // i-2..i, none in the slot step t writes. Where plane i completes a
  // coarse plane, R_x goes to rho, a second barrier, and the coarse tile
  // is written; rho is written next two steps later, past a barrier that
  // every reader of it has reached.
  for (int t = 0; t <= 2 * m + 1; ++t) {
    const int i = f0 + t;
#pragma unroll
    for (int r = 0; r < kUR; ++r)
      if (in_window<kUN>(r, tid)) us[slot(i + 1)][tid + r * kTileThreads] = cvt<T>(ur[r]);
    T bv[kRP];
#pragma unroll
    for (int h = 0; h < kRP; ++h) bv[h] = br[h];
    __syncthreads();
    if (t <= 2 * m) stage(sq);
    sq = next(sq);
    const T* u0 = us[slot(i)];
    const T* um = us[slot(i - 1)];
    const T* up = us[slot(i + 1)];
#pragma unroll
    for (int h = 0; h < kRP; ++h) {
      if (!in_window<kRN>(h, tid)) continue;
      const int p = tid + h * kTileThreads;
      const int oc = (p / kRZ + 1) * kUZ + p % kRZ + 1;
      const T c = u0[oc];
      const T xm = um[oc], xp = up[oc];
      const T ym = u0[oc - kUZ], yp = u0[oc + kUZ];
      const T zm = u0[oc - 1], zp = u0[oc + 1];
      T star;
      if (ISO) {
        const T s = ((xm + xp) + (ym + yp)) + (zm + zp);
        star = s * ivx - six_iv * c;
      } else {
        T s = (xm + xp) * ivx;
        s = s + (ym + yp) * ivy;
        s = s + (zm + zp) * ivz;
        star = s - center * c;
      }
      const T res = bv[h] - star;  // the residual at fine plane i
      if (t == 0) {
        r_dn[h] = res;
      } else if (t == 1) {
        r_even[h] = res;
      } else if (t & 1) {  // i = 2I + 2: R_x of coarse plane I is complete
        rho[p] = ((T(3) * (r_even[h] + r_odd[h]) + res) + r_dn[h]) * T(0.125);
        r_dn[h] = r_odd[h];
        r_even[h] = res;
      } else {
        r_odd[h] = res;
      }
    }
    if (t >= 3 && (t & 1)) {
      __syncthreads();
      const int J = J0 + threadIdx.y, K = K0 + threadIdx.x;
      if (J < nyc && K < nzc) {
        // the 4 x 4 patch: fine rows 2J-1 .. 2J+2, columns 2K-1 .. 2K+2
        const T* q = rho + 2 * threadIdx.y * kRZ + 2 * threadIdx.x;
        T ry[4];  // R_y at the patch's four columns
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ry[c] = ((T(3) * (q[kRZ + c] + q[2 * kRZ + c]) + q[3 * kRZ + c]) + q[c]) * T(0.125);
        const int I = I0 + (t - 3) / 2;
        out[((size_t)I * nyc + J) * nzc + K] =
            ((T(3) * (ry[1] + ry[2]) + ry[3]) + ry[0]) * T(0.125);
      }
    }
  }
}

// out = u + P_x P_z P_y e over the (nx, ny, nz) output (see the header).
template <typename TU, typename T>
__global__ void __launch_bounds__(kTileThreads)
prolong_add_kernel(const TU* __restrict__ u, const T* __restrict__ e, T* __restrict__ out,
                   int nx, int ny, int nz, int chunk) {
  __shared__ T es[2][kEN];
  const int tid = threadIdx.x + kTZ * threadIdx.y;
  const int nxc = nx / 2, nyc = ny / 2, nzc = nz / 2;
  const int J0 = blockIdx.y * kCY, K0 = blockIdx.x * kCZ;
  const int I0 = blockIdx.z * chunk;
  const int m = min(chunk, nxc - I0);
  const size_t plane = (size_t)ny * nz;
  const size_t cplane = (size_t)nyc * nzc;
  // offsets in a coarse plane of the window's cells this thread stages
  // (rows from J0 - 1, columns from K0 - 1)
  int eoff[kER];
#pragma unroll
  for (int r = 0; r < kER; ++r) {
    const int w = tid + r * kTileThreads;
    if (in_window<kEN>(r, tid))
      eoff[r] = pmod(J0 - 1 + w / kEZ, nyc) * nzc + pmod(K0 - 1 + w % kEZ, nzc);
  }
  // the fine points owned: tile rows ty + kCY a, columns tx + kCZ c
  // (a, c in {0, 1}); point a c lies in coarse window cell w0 + a (kCY/2)
  // kEZ + c kCZ/2, its y neighbour dy and its z neighbour dz away
  const int fy = threadIdx.y, fz = threadIdx.x;
  const int w0 = (fy / 2 + 1) * kEZ + fz / 2 + 1;
  const int dy = (fy & 1) ? kEZ : -kEZ;
  const int dz = (fz & 1) ? 1 : -1;
  int foff[4];
  bool own[4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 2 * J0 + fy + kCY * a, k = 2 * K0 + fz + kCZ * c;
      own[2 * a + c] = j < ny && k < nz;
      foff[2 * a + c] = j * nz + k;
    }

  T er[kER];  // the register stage of the next coarse plane
  auto stage = [&](int q) {
    const T* src = e + (size_t)q * cplane;
#pragma unroll
    for (int r = 0; r < kER; ++r)
      if (in_window<kEN>(r, tid)) er[r] = src[eoff[r]];
  };
  TU un[2][4];  // u at fine planes 2I and 2I+1 of the next step's output
  auto stage_u = [&](int I) {
    const TU* s0 = u + (size_t)(2 * I) * plane;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (own[p]) {
        un[0][p] = s0[foff[p]];
        un[1][p] = s0[plane + foff[p]];
      }
  };
  // P_z P_y e at the points owned, coarse planes q-2, q-1 and q
  T c_m[4], c_0[4], c_p[4];
  stage(pmod(I0 - 1, nxc));
  // Step s (coarse plane q = I0 - 1 + s): store the staged plane q, one
  // barrier (the slot written was last read two steps before), stage plane
  // q+1 and u of the next step's output, form P_z P_y e of plane q, and
  // from s = 2 on write fine planes 2I and 2I+1 of I = q - 1.
  for (int s = 0; s <= m + 1; ++s) {
    const int q = I0 - 1 + s;
#pragma unroll
    for (int r = 0; r < kER; ++r)
      if (in_window<kEN>(r, tid)) es[s & 1][tid + r * kTileThreads] = er[r];
    __syncthreads();
    if (s <= m) stage(pmod(q + 1, nxc));
    TU uv[2][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uv[0][p] = un[0][p];
      uv[1][p] = un[1][p];
    }
    if (s >= 1 && s <= m) stage_u(q);
    const T* w = es[s & 1];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int o = w0 + (p >> 1) * (kCY / 2) * kEZ + (p & 1) * (kCZ / 2);
      const T ey = T(0.75) * w[o] + T(0.25) * w[o + dy];            // column K
      const T ey_nb = T(0.75) * w[o + dz] + T(0.25) * w[o + dz + dy];  // column K +- 1
      c_m[p] = c_0[p];
      c_0[p] = c_p[p];
      c_p[p] = T(0.75) * ey + T(0.25) * ey_nb;
    }
    if (s >= 2) {
      T* o0 = out + (size_t)(2 * (q - 1)) * plane;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (own[p]) {
          o0[foff[p]] = cvt<T>(uv[0][p]) + (T(0.75) * c_0[p] + T(0.25) * c_m[p]);
          o0[plane + foff[p]] = cvt<T>(uv[1][p]) + (T(0.75) * c_0[p] + T(0.25) * c_p[p]);
        }
    }
  }
}

struct XferCoef {
  double ivx, ivy, ivz, center, six_iv;
};

template <typename TU, typename T, bool ISO>
cudaError_t launch_restrict(cudaStream_t s, const TU* u, const T* b, T* out, int nx, int ny,
                            int nz, int chunk, dim3 grid, const XferCoef& k) {
  constexpr size_t smem = restrict_smem<T>();
  if constexpr (smem > 48 * 1024) {  // above the default limit (f64)
    const cudaError_t err = cudaFuncSetAttribute(
        restrict_kernel<TU, T, ISO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  restrict_kernel<TU, T, ISO><<<grid, tile_block(), smem, s>>>(
      u, b, out, nx, ny, nz, chunk, T(k.ivx), T(k.ivy), T(k.ivz), T(k.center), T(k.six_iv));
  return cudaGetLastError();
}

template <typename TU, typename T>
cudaError_t launch_xfer(int mode, int iso, cudaStream_t s, const void* u, const void* be,
                        void* out, int nx, int ny, int nz, const XferCoef& k) {
  const TU* uu = static_cast<const TU*>(u);
  const T* bb = static_cast<const T*>(be);
  T* oo = static_cast<T*>(out);
  const int chunk = xfer_chunk(nx / 2, ny / 2, nz / 2);
  const dim3 grid = xfer_grid(nx / 2, ny / 2, nz / 2, chunk);
  if (mode == kRestrict) {
    return iso ? launch_restrict<TU, T, true>(s, uu, bb, oo, nx, ny, nz, chunk, grid, k)
               : launch_restrict<TU, T, false>(s, uu, bb, oo, nx, ny, nz, chunk, grid, k);
  }
  if (mode != kProlongAdd) return cudaErrorInvalidValue;
  prolong_add_kernel<TU, T><<<grid, tile_block(), 0, s>>>(uu, bb, oo, nx, ny, nz, chunk);
  return cudaGetLastError();
}

}  // namespace poissbox

extern "C" {

// mode: 0 restrict (be = b at (nx, ny, nz), out at (nx/2, ny/2, nz/2)),
// 1 prolong_add (be = e at (nx/2, ny/2, nz/2), out at (nx, ny, nz)).
// (nx, ny, nz) is always the fine shape, every extent even. tu/t: dtype
// codes (0 float32, 1 float64, 2 bfloat16) of u and of be/out. iso: 1
// when ivx == ivy == ivz (restrict only). Returns the cudaError_t of the
// launch (0 on success).
int poissbox_xfer(int tu, int t, int mode, int iso, int device, void* stream, const void* u,
                  const void* be, void* out, int nx, int ny, int nz, double ivx, double ivy,
                  double ivz, double center, double six_iv) {
  using namespace poissbox;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XferCoef k{ivx, ivy, ivz, center, six_iv};
  if (tu == kF32 && t == kF32)
    err = launch_xfer<float, float>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else if (tu == kF64 && t == kF64)
    err = launch_xfer<double, double>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else if (tu == kBF16 && t == kF32)
    err = launch_xfer<__nv_bfloat16, float>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else if (tu == kBF16 && t == kF64)
    err = launch_xfer<__nv_bfloat16, double>(mode, iso, s, u, be, out, nx, ny, nz, k);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
