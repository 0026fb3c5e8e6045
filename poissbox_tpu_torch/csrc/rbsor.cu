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
//       kGeneral for the second colour. With a narrow x1 (out_dtype bf16,
//       the 512^3-class bf16 pre-smooth) the second launch reads f32 and
//       stores bf16.
// and carries the work of stencil_inplace.py's K4' (_sor_rb_multi_inplace)
// and K5' (_zero_upd_stream), the TPU's aliased forms of K4 and K5 for
// fields of 256 MB and more, out of place.
//
// Types (input -> output): f32 -> f32 and f64 -> f64 in every mode;
// bf16 -> bf16 in kZero and kGeneral (the bf16 pre-smooth of every
// sub-fine level); f32 -> bf16 in kGeneral (K5's narrow x1). A bf16 value
// is upcast to f32, the update runs in f32, and the result rounds once at
// the store: that is the port's definition of a bf16 colour update (the
// Pallas kernels compute in bf16 throughout).
//
// Parity is (i+j+k) % 2 of the global index, as _parity computes it; red
// is even. The update keeps _rb_halfstep's grouping: for cubic cells
// (ivx == ivy == ivz) c + w*((b - ivx*s) + (6*ivx)*c) with s the plain
// six-neighbour sum, otherwise c + w*(b - star(x)) in _star_ext's order;
// with --fmad=false the kernel rounds as the plain version does.
//
// Bound on an H100 SXM (3.35 TB/s): a general colour reads x and b and
// writes x_out, 3 field passes; a sweep of two launches is 6 passes, at
// 256^3 f32 6 x 67 MB = 0.12 ms. The zero sweep is 2 + 3 passes
// (0.10 ms), the fused update 4 + 3 (0.14 ms). In bf16 a pass costs half.
// The Pallas kernels run both colours in one pass with a wide x-halo (3
// passes a sweep); that fusion, shared-memory tiles, and writing only the
// updated colour in place are what this first design leaves on the table.
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

// TI: the stored type of x, b, r, Ap, alpha and b_out; TO: of out.
// C: the arithmetic type (and that of the reduction partials).
template <typename TI, typename TO, int MODE, bool ISO>
__global__ void __launch_bounds__(kThreads)
rbsor_kernel(const TI* __restrict__ x, const TI* __restrict__ b, const TI* __restrict__ r,
             const TI* __restrict__ ap, const TI* __restrict__ alpha, TO* __restrict__ out,
             TI* __restrict__ bout, typename Compute<TI>::type* __restrict__ part0,
             typename Compute<TI>::type* __restrict__ part1, int nx, int ny, int nz,
             typename Compute<TI>::type ivx, typename Compute<TI>::type ivy,
             typename Compute<TI>::type ivz, typename Compute<TI>::type center,
             typename Compute<TI>::type six_iv, typename Compute<TI>::type winv, int color) {
  using C = typename Compute<TI>::type;
  const Point q = locate(nx, ny, nz);
  C s0 = C(0), s1 = C(0);
  if (q.active) {
    const bool mine = ((q.i + q.j + q.k) & 1) == color;
    const C w = mine ? winv : C(0);
    if (MODE == kZero) {
      out[q.p] = cvt<TO>(w * cvt<C>(b[q.p]));
    } else if (MODE == kZeroUpdate) {
      const C bn = cvt<C>(r[q.p]) - cvt<C>(alpha[0]) * cvt<C>(ap[q.p]);
      bout[q.p] = cvt<TI>(bn);
      out[q.p] = cvt<TO>(w * bn);
      s0 = bn * bn;
      s1 = bn;
    } else {
      const C c = cvt<C>(x[q.p]);
      const C bv = cvt<C>(b[q.p]);
      C v = c;
      if (mine) {
        const C xm = cvt<C>(x[q.xm]), xp = cvt<C>(x[q.xp]);
        const C ym = cvt<C>(x[q.ym]), yp = cvt<C>(x[q.yp]);
        const C zm = cvt<C>(x[q.zm]), zp = cvt<C>(x[q.zp]);
        C res;
        if (ISO) {
          const C s = ((xm + xp) + (ym + yp)) + (zm + zp);
          res = (bv - ivx * s) + six_iv * c;
        } else {
          C acc = (xm + xp) * ivx;
          acc = acc + (ym + yp) * ivy;
          acc = acc + (zm + zp) * ivz;
          res = bv - (acc - center * c);
        }
        v = c + w * res;
      }
      out[q.p] = cvt<TO>(v);
      if (MODE == kDots) {
        s0 = v * bv;
        s1 = v;
      }
    }
  }
  if (MODE == kZeroUpdate || MODE == kDots) block_partials(s0, s1, part0, part1);
}

struct RbsorCoef {
  double ivx, ivy, ivz, center, six_iv, winv;
};

template <typename TI, typename TO, int MODE, bool ISO>
cudaError_t launch_mode(cudaStream_t stream, const Args& a, int nx, int ny, int nz,
                        const RbsorCoef& k, int color) {
  using C = typename Compute<TI>::type;
  rbsor_kernel<TI, TO, MODE, ISO><<<launch_grid(nx, ny, nz), launch_block(), 0, stream>>>(
      static_cast<const TI*>(a.x), static_cast<const TI*>(a.b), static_cast<const TI*>(a.r),
      static_cast<const TI*>(a.ap), static_cast<const TI*>(a.alpha), static_cast<TO*>(a.out),
      static_cast<TI*>(a.bout), static_cast<C*>(a.part0), static_cast<C*>(a.part1), nx, ny,
      nz, C(k.ivx), C(k.ivy), C(k.ivz), C(k.center), C(k.six_iv), C(k.winv), color);
  return cudaGetLastError();
}

// Every mode, for the same-type pairs f32 -> f32 and f64 -> f64.
template <typename T, bool ISO>
cudaError_t launch_wide(int mode, cudaStream_t s, const Args& a, int nx, int ny, int nz,
                        const RbsorCoef& k, int color) {
  switch (mode) {
    case kZero:
      return launch_mode<T, T, kZero, ISO>(s, a, nx, ny, nz, k, color);
    case kGeneral:
      return launch_mode<T, T, kGeneral, ISO>(s, a, nx, ny, nz, k, color);
    case kZeroUpdate:
      return launch_mode<T, T, kZeroUpdate, ISO>(s, a, nx, ny, nz, k, color);
    case kDots:
      return launch_mode<T, T, kDots, ISO>(s, a, nx, ny, nz, k, color);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool ISO>
cudaError_t launch_rbsor(int tin, int tout, int mode, cudaStream_t s, const Args& a, int nx,
                         int ny, int nz, const RbsorCoef& k, int color) {
  if (tin == kF32 && tout == kF32) return launch_wide<float, ISO>(mode, s, a, nx, ny, nz, k, color);
  if (tin == kF64 && tout == kF64)
    return launch_wide<double, ISO>(mode, s, a, nx, ny, nz, k, color);
  if (tin == kBF16 && tout == kBF16 && mode == kZero)
    return launch_mode<__nv_bfloat16, __nv_bfloat16, kZero, ISO>(s, a, nx, ny, nz, k, color);
  if (tin == kBF16 && tout == kBF16 && mode == kGeneral)
    return launch_mode<__nv_bfloat16, __nv_bfloat16, kGeneral, ISO>(s, a, nx, ny, nz, k, color);
  if (tin == kF32 && tout == kBF16 && mode == kGeneral)
    return launch_mode<float, __nv_bfloat16, kGeneral, ISO>(s, a, nx, ny, nz, k, color);
  return cudaErrorInvalidValue;
}

}  // namespace poissbox

extern "C" {

// tin/tout: dtype codes (0 float32, 1 float64, 2 bfloat16) of the inputs
// and of out; mode: 0 zero, 1 general, 2 zero + fused CG update, 3
// general + dots; iso: 1 when ivx == ivy == ivz. Pointers a mode does not
// use may be null. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a type pair the mode does not take).
int poissbox_rbsor(int tin, int tout, int mode, int iso, int device, void* stream,
                   const void* x, const void* b, const void* r, const void* ap,
                   const void* alpha, void* out, void* bout, void* part0, void* part1, int nx,
                   int ny, int nz, double ivx, double ivy, double ivz, double center,
                   double six_iv, double winv, int color) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const poissbox::Args a{x, b, r, ap, alpha, out, bout, part0, part1};
  const poissbox::RbsorCoef k{ivx, ivy, ivz, center, six_iv, winv};
  if (iso)
    err = poissbox::launch_rbsor<true>(tin, tout, mode, s, a, nx, ny, nz, k, color);
  else
    err = poissbox::launch_rbsor<false>(tin, tout, mode, s, a, nx, ny, nz, k, color);
  return (int)err;
}

}  // extern "C"
