// KB `rbsor`: one red-black SOR colour update of the periodic 7-point
// Laplacian. For colour c, every point with (i+j+k) % 2 == c gets
//   x + winv * (b - A x),   winv = w / diag,  diag = -2 * sum(1/d^2) < 0,
// and every point of the other colour is copied. A full sweep is two
// launches, one per colour, in the order (0, 1), or (1, 0) when reversed.
//
// Replaces these TPU kernels of poissbox_tpu/ops/stencil_pallas.py:
//   K3  _sor_rb_zero (_sor_rb_zero_kernel)         sweep from x = 0:
//       mode kZero for the first colour (winv * mask * b; x is never
//       read), then kGeneral for the second
//   K4  _sor_rb (_sor_rb_kernel)                    sweep from x: kGeneral
//       twice; with dots, kDots for the second colour (partials of
//       <x_out, b> and sum(x_out))
//   K5  _sor_rb_zero_upd (_sor_rb_zero_upd_kernel)  CG's update fused in:
//       mode kZeroUpdate forms b = r - alpha * Ap, writes it, takes the
//       ||b||^2 and sum(b) partials and the first colour from zero; then
//       kGeneral for the second colour
// Parity is (i+j+k) % 2 of the global index, as _parity computes it; red
// is even. The update keeps _rb_halfstep's grouping: for cubic cells
// (ivx == ivy == ivz) c + w*((b - ivx*s) + (6*ivx)*c) with s the plain
// six-neighbour sum, otherwise c + w*(b - star(x)) in _star_ext's order;
// with --fmad=false the kernel rounds as the plain version does.
//
// Bound on an H100 SXM (3.35 TB/s): a general colour reads x and b and
// writes x_out, 3 field passes; a sweep of two launches is 6 passes, at
// 256^3 f32 6 x 67 MB = 0.12 ms. The zero sweep is 2 + 3 passes
// (0.10 ms), the fused update 4 + 3 (0.14 ms). The Pallas kernels run
// both colours in one pass with a wide x-halo (3 passes a sweep); that
// fusion, shared-memory tiles, and writing only the updated colour in
// place are what this first design leaves on the table.
#include "common.cuh"

namespace poissbox {

enum Mode { kZero = 0, kGeneral = 1, kZeroUpdate = 2, kDots = 3 };

struct Args {
  const void* x;
  const void* b;
  const void* r;
  const void* ap;
  const void* alpha;
  void* out;
  void* bout;
  void* part0;
  void* part1;
};

template <typename T, int MODE, bool ISO>
__global__ void __launch_bounds__(kThreads)
rbsor_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ r,
             const T* __restrict__ ap, const T* __restrict__ alpha, T* __restrict__ out,
             T* __restrict__ bout, T* __restrict__ part0, T* __restrict__ part1, int nx,
             int ny, int nz, T ivx, T ivy, T ivz, T center, T six_iv, T winv, int color) {
  const Point q = locate(nx, ny, nz);
  T s0 = T(0), s1 = T(0);
  if (q.active) {
    const bool mine = ((q.i + q.j + q.k) & 1) == color;
    const T w = mine ? winv : T(0);
    if (MODE == kZero) {
      out[q.p] = w * b[q.p];
    } else if (MODE == kZeroUpdate) {
      const T bn = r[q.p] - alpha[0] * ap[q.p];
      bout[q.p] = bn;
      out[q.p] = w * bn;
      s0 = bn * bn;
      s1 = bn;
    } else {
      const T c = x[q.p];
      const T bv = b[q.p];
      T v = c;
      if (mine) {
        T res;
        if (ISO) {
          const T s = ((x[q.xm] + x[q.xp]) + (x[q.ym] + x[q.yp])) + (x[q.zm] + x[q.zp]);
          res = (bv - ivx * s) + six_iv * c;
        } else {
          T acc = (x[q.xm] + x[q.xp]) * ivx;
          acc = acc + (x[q.ym] + x[q.yp]) * ivy;
          acc = acc + (x[q.zm] + x[q.zp]) * ivz;
          res = bv - (acc - center * c);
        }
        v = c + w * res;
      }
      out[q.p] = v;
      if (MODE == kDots) {
        s0 = v * bv;
        s1 = v;
      }
    }
  }
  if (MODE == kZeroUpdate || MODE == kDots) block_partials(s0, s1, part0, part1);
}

template <typename T, int MODE, bool ISO>
void launch_mode(cudaStream_t stream, const Args& a, int nx, int ny, int nz, double ivx,
                 double ivy, double ivz, double center, double six_iv, double winv,
                 int color) {
  rbsor_kernel<T, MODE, ISO><<<launch_grid(nx, ny, nz), launch_block(), 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.b), static_cast<const T*>(a.r),
      static_cast<const T*>(a.ap), static_cast<const T*>(a.alpha), static_cast<T*>(a.out),
      static_cast<T*>(a.bout), static_cast<T*>(a.part0), static_cast<T*>(a.part1), nx, ny,
      nz, T(ivx), T(ivy), T(ivz), T(center), T(six_iv), T(winv), color);
}

template <typename T, bool ISO>
cudaError_t launch_rbsor(int mode, cudaStream_t stream, const Args& a, int nx, int ny,
                         int nz, double ivx, double ivy, double ivz, double center,
                         double six_iv, double winv, int color) {
  switch (mode) {
    case kZero:
      launch_mode<T, kZero, ISO>(stream, a, nx, ny, nz, ivx, ivy, ivz, center, six_iv, winv,
                                 color);
      break;
    case kGeneral:
      launch_mode<T, kGeneral, ISO>(stream, a, nx, ny, nz, ivx, ivy, ivz, center, six_iv,
                                    winv, color);
      break;
    case kZeroUpdate:
      launch_mode<T, kZeroUpdate, ISO>(stream, a, nx, ny, nz, ivx, ivy, ivz, center, six_iv,
                                       winv, color);
      break;
    case kDots:
      launch_mode<T, kDots, ISO>(stream, a, nx, ny, nz, ivx, ivy, ivz, center, six_iv, winv,
                                 color);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace poissbox

extern "C" {

// dtype: 0 = float32, 1 = float64. mode: 0 zero, 1 general, 2 zero +
// fused CG update, 3 general + dots. iso: 1 when ivx == ivy == ivz.
// Pointers a mode does not use may be null. Returns the cudaError_t of
// the launch (0 on success).
int poissbox_rbsor(int dtype, int mode, int iso, int device, void* stream, const void* x,
                   const void* b, const void* r, const void* ap, const void* alpha,
                   void* out, void* bout, void* part0, void* part1, int nx, int ny, int nz,
                   double ivx, double ivy, double ivz, double center, double six_iv,
                   double winv, int color) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const poissbox::Args a{x, b, r, ap, alpha, out, bout, part0, part1};
  if (dtype == 0 && iso)
    err = poissbox::launch_rbsor<float, true>(mode, s, a, nx, ny, nz, ivx, ivy, ivz, center,
                                              six_iv, winv, color);
  else if (dtype == 0)
    err = poissbox::launch_rbsor<float, false>(mode, s, a, nx, ny, nz, ivx, ivy, ivz, center,
                                               six_iv, winv, color);
  else if (dtype == 1 && iso)
    err = poissbox::launch_rbsor<double, true>(mode, s, a, nx, ny, nz, ivx, ivy, ivz, center,
                                               six_iv, winv, color);
  else if (dtype == 1)
    err = poissbox::launch_rbsor<double, false>(mode, s, a, nx, ny, nz, ivx, ivy, ivz,
                                                center, six_iv, winv, color);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
