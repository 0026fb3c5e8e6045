// KB `rbsor`: red-black SOR on the periodic 7-point Laplacian. A colour
// update gives every point with (i+j+k) % 2 == c
//   x + winv * (b - A x),   winv = w / diag,  diag = -2 * sum(1/d^2) < 0,
// and copies every point of the other colour. A sweep is two colour updates,
// c0 then c1 = 1 - c0 ((0, 1), or (1, 0) when reversed), here in ONE launch.
//
// Replaces these TPU kernels of poissbox_tpu/ops/stencil_pallas.py:
//   K11 _sor (_upd_sor)                   one colour update: colour_kernel
//   K3  _sor_rb_zero (_sor_rb_zero_kernel)          sweep_kernel, kZeroSweep:
//       the first colour from x = 0 is winv * mask * b (x is never read)
//   K4  _sor_rb (_sor_rb_kernel)                    kSweep; with dots,
//       kSweepDots (partials of <x_out, b> and sum(x_out))
//   K5  _sor_rb_zero_upd (_sor_rb_zero_upd_kernel)  kZeroUpdateSweep: CG's
//       update b = r - alpha * Ap formed, written, its ||b||^2 and sum(b)
//       partials taken, then the sweep from zero; with a narrow x1 (out
//       bf16, the 512^3-class bf16 pre-smooth) the second colour reads f32
//       and stores bf16
// and carries the work of stencil_inplace.py's K4' (_sor_rb_multi_inplace)
// and K5' (_zero_upd_stream), the TPU's aliased forms of K4 and K5 for
// fields of 256 MB and more, out of place.
//
// Types (input -> output): f32 -> f32 and f64 -> f64 in every mode; bf16 ->
// bf16 in the colour update, kSweep and kZeroSweep (the bf16 pre-smooth of
// every sub-fine level); f32 -> bf16 in kZeroUpdateSweep (K5's narrow x1).
// A bf16 value is upcast to f32, the update runs in f32, and each colour
// rounds once at its store: that is the port's definition of a bf16 colour
// update (the Pallas kernels compute in bf16 throughout). Parity is
// (i+j+k) % 2 of the wrapped global index, as _parity computes it; red is
// even. The update keeps _rb_halfstep's grouping: for cubic cells
// (ivx == ivy == ivz) c + w*((b - ivx*s) + (6*ivx)*c) with s the plain
// six-neighbour sum, otherwise c + w*(b - star(x)) in _star_ext's order;
// with --fmad=false the kernel rounds as the plain version does.
//
// The sweep's premise: it is out of place, so a first-colour value x' reads
// only the input x (its own old value and its neighbours, which the first
// colour does not update), and a second-colour value reads only x'. A block
// that owns an output tile can therefore recompute x' on the tile and a
// 1-cell halo, from x on the tile and a 2-cell halo, and needs nothing from
// any other block.
//
// Design (sweep_kernel). A block of 256 threads owns a 32 x 16 (y, z) tile,
// z fastest, and walks a chunk of x planes (tile_chunk: 32 planes at 512^3,
// 16 at 256^3, so the grid holds at least 2048 blocks). Shared memory holds
// rings of four planes: x with a 2-cell (y, z) halo, x' and b with a 1-cell
// halo. Step s (plane p) stores the x plane p+1 and b plane p staged in
// registers, passes ONE barrier, issues the loads of the next step's planes,
// computes x' of plane p on the 1-cell halo and the second colour of plane
// p-2 on the tile; the fourth slot of each ring is what lets one barrier a
// step suffice. Cells go in z-adjacent pairs, which on an even extent hold
// one cell of each colour: a lane updates the cell of the colour at hand,
// chosen by its address (a warp does not diverge), and copies the other, so
// each colour does half the stencil work of a point kernel; a thread owns
// one output pair a plane and stores it as one vector. Plane indices
// advance by compare and select: each integer `%` in the loop is a long
// inlined sequence. Each input is read from HBM about once: the halo
// cells of neighbouring tiles and chunk ends come from L2.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py) the kernel
// runs at 51-67 % of its byte bound in f32 (general sweep 0.111 ms at 256^3,
// bound 0.060) and about 35 % in bf16 (0.69 ms at 512^3, bound 0.24): it
// issues the same instructions a point in either type, so halving the bytes
// does not halve the time. What holds it back is instruction issue and the
// latency between barriers, not HBM.
//
// Where it is likely to go wrong, and what the kernel does:
//   - Rounding of the first colour. The two-launch sweep stored x' in the
//     input type between its launches; the kernel rounds x' to the input
//     type before the second colour reads it (bf16 for the bf16 sweeps, f32
//     for the narrow mode, whose second colour reads f32 and stores bf16).
//   - Partials counted once. The dot and update partials sum only the
//     points the block owns (its tile, its chunk), never the halo
//     recomputations; there is one partial per block of the new grid
//     (poissbox_rbsor_sweep_blocks).
//   - Periodic halos on small extents. The V-cycle smooths down to 8^3 and
//     (16, 8, 12), and the wrappers take any shape: on a 2-, 3- or 4-cell
//     axis a 2-cell halo wraps more than once, so every window index is
//     wrapped with a true modulo (common.cuh pmod), x planes too. On an odd
//     z extent the two cells of a pair across the wrap share a colour: the
//     kernel then updates both or neither (a rare, branching path).
//   - Ragged tiles. Window cells past a ragged (y, z) edge wrap like any
//     halo cell, so every staged value is a real one; only the owned cells
//     (j < ny, k < nz) are written.
//
// Bound on an H100 SXM (3.35 TB/s): a general sweep reads x and b and
// writes x_out, 3 field passes (0.060 ms at 256^3 f32, 0.240 ms at 512^3
// bf16); the zero sweep 2 (0.040; bf16 512^3 0.160); the fused update reads
// r and Ap and writes b and x1, 4 passes (0.080; narrow at 512^3 0.561).
// The colour update (K11) is 3 passes: a sweep of two of them is 6.
#include "common.cuh"

namespace poissbox {

enum SweepMode { kSweep = 0, kSweepDots = 1, kZeroSweep = 2, kZeroUpdateSweep = 3 };

template <typename C>
struct Coef {
  C ivx, ivy, ivz, center, six_iv, winv;
};

// c + winv * (b - A x) at one point from its six neighbours, in
// _rb_halfstep's grouping.
template <typename C, bool ISO>
__device__ __forceinline__ C sor_update(C c, C bv, C xm, C xp, C ym, C yp, C zm, C zp,
                                        const Coef<C>& k) {
  C res;
  if (ISO) {
    const C s = ((xm + xp) + (ym + yp)) + (zm + zp);
    res = (bv - k.ivx * s) + k.six_iv * c;
  } else {
    C acc = (xm + xp) * k.ivx;
    acc = acc + (ym + yp) * k.ivy;
    acc = acc + (zm + zp) * k.ivz;
    res = bv - (acc - k.center * c);
  }
  return c + k.winv * res;
}

// K11: one colour update, one thread per point.
template <typename T, bool ISO>
__global__ void __launch_bounds__(kThreads)
colour_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out, int nx,
              int ny, int nz, Coef<typename Compute<T>::type> k, int color) {
  using C = typename Compute<T>::type;
  const Point q = locate(nx, ny, nz);
  if (!q.active) return;
  const C c = cvt<C>(x[q.p]);
  C v = c;
  if (((q.i + q.j + q.k) & 1) == color)
    v = sor_update<C, ISO>(c, cvt<C>(b[q.p]), cvt<C>(x[q.xm]), cvt<C>(x[q.xp]),
                           cvt<C>(x[q.ym]), cvt<C>(x[q.yp]), cvt<C>(x[q.zm]),
                           cvt<C>(x[q.zp]), k);
  out[q.p] = cvt<T>(v);
}

// The two-element vector of a stored type, for a pair store.
template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};
template <>
struct Vec2<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

// dst[0] = a and, with `both`, dst[1] = b: one vector store when `vec`
// says the pair is aligned.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, T a, T b, bool both, bool vec) {
  if (both && vec) {
    typename Vec2<T>::type v;
    v.x = a;
    v.y = b;
    *reinterpret_cast<typename Vec2<T>::type*>(dst) = v;
  } else {
    dst[0] = a;
    if (both) dst[1] = b;
  }
}

// Blocks an SM must hold, which caps the registers: 4 (64 registers), or 3
// (85) in f64, which would spill at 64 (its 62 KB of shared memory allow no
// more than 3 anyway).
template <typename C>
constexpr int sweep_blocks_per_sm() {
  return sizeof(C) == 8 ? 3 : 4;
}

// K3/K4/K5: one red-black sweep, both colours, one launch (see the header).
// TI: the stored type of x, b, r, Ap, alpha, b_out and of x' (the first
// colour); TO: of out. C: the arithmetic type (and that of the partials).
template <typename TI, typename TO, int MODE, bool ISO>
__global__ void __launch_bounds__(kTileThreads,
                                  sweep_blocks_per_sm<typename Compute<TI>::type>())
sweep_kernel(const TI* __restrict__ x, const TI* __restrict__ b, const TI* __restrict__ r,
             const TI* __restrict__ ap, const TI* __restrict__ alpha, TO* __restrict__ out,
             TI* __restrict__ bout, typename Compute<TI>::type* __restrict__ part0,
             typename Compute<TI>::type* __restrict__ part1, int nx, int ny, int nz, int chunk,
             Coef<typename Compute<TI>::type> k, int c0) {
  using C = typename Compute<TI>::type;
  using XW = TileWindow<2>;  // x: the tile and a 2-cell halo
  using VW = TileWindow<1>;  // x' and b: the tile and a 1-cell halo
  constexpr bool kFromX = MODE == kSweep || MODE == kSweepDots;  // reads an iterate x
  constexpr bool kUpd = MODE == kZeroUpdateSweep;
  constexpr bool kSums = MODE == kSweepDots || kUpd;
  // rings of four planes each: x (general modes), x' and b
  extern __shared__ __align__(16) unsigned char smem[];
  C* const xs = reinterpret_cast<C*>(smem);
  C* const vs = xs + (kFromX ? 4 * XW::kN : 0);
  C* const bs = vs + 4 * VW::kN;

  const int tid = threadIdx.x + kTZ * threadIdx.y;
  const int j0 = blockIdx.y * kTY, k0 = blockIdx.x * kTZ;
  const int i0 = blockIdx.z * chunk;
  const int n = min(chunk, nx - i0);
  const size_t plane = (size_t)ny * nz;
  const XW xw(j0, k0, ny, nz, tid);
  const VW vw(j0, k0, ny, nz, tid);
  // Cells go in pairs adjacent in z, which on an even extent hold one cell
  // of each colour: a thread updates the one of the colour at hand (chosen
  // by its address, so a warp does not diverge) and copies the other. x'
  // pair e2 is cells (e2 / kPZ, 2 (e2 % kPZ)) and the next in z of the
  // x'/b window; pvc and pxc are its first cell in that window and in the
  // x window, ppar the parities of j + k of its two cells (bits 0 and 1).
  constexpr int kPZ = VW::kZ / 2, kPN = kPZ * VW::kY;
  constexpr int kPR = (kPN + kTileThreads - 1) / kTileThreads;
  constexpr int kOwn = kTY * kTZ / 2 / kTileThreads;  // pairs a thread owns a plane
  static_assert(kOwn * kTileThreads * 2 == kTY * kTZ, "whole pairs a thread");
  int pvc[kPR], pxc[kPR], ppar[kPR];
#pragma unroll
  for (int rr = 0; rr < kPR; ++rr) {
    const int e2 = tid + rr * kTileThreads;
    const int vy = e2 / kPZ, vz = 2 * (e2 % kPZ);
    pvc[rr] = vy * VW::kZ + vz;
    pxc[rr] = (vy + 1) * XW::kZ + vz + 1;
    const int j = pmod(j0 - 1 + vy, ny);
    ppar[rr] = ((j + pmod(k0 - 1 + vz, nz)) & 1) | (((j + pmod(k0 + vz, nz)) & 1) << 1);
  }
  // the pairs this thread owns in each plane: cells (orow, 2 ozp) and the
  // next in z of the tile, orow = tid / (kTZ / 2) + h * (kTileThreads /
  // (kTZ / 2)) for h < kOwn
  const int ozp = tid % (kTZ / 2), ok = k0 + 2 * ozp;
  const bool own_b = ok + 1 < nz;
  int oj[kOwn], oc[kOwn];
  bool own[kOwn];
  size_t ooff[kOwn];
#pragma unroll
  for (int h = 0; h < kOwn; ++h) {
    const int orow = tid / (kTZ / 2) + h * (2 * kTileThreads / kTZ);
    oj[h] = j0 + orow;
    own[h] = oj[h] < ny && ok < nz;
    oc[h] = (orow + 1) * VW::kZ + 2 * ozp + 1;
    ooff[h] = (size_t)oj[h] * nz + ok;
  }
  const bool vec_out = !(nz & 1) && !(reinterpret_cast<size_t>(out) % (2 * sizeof(TO)));
  const bool vec_b = !(nz & 1) && !(reinterpret_cast<size_t>(bout) % (2 * sizeof(TI)));
  const int c1 = c0 ^ 1;
  const C a = kUpd ? cvt<C>(alpha[0]) : C(0);
  // ring slot of plane q (q >= i0 - 2)
  auto slot = [i0](int q) { return (q - i0 + 4) & 3; };
  // the wrapped index of the plane after wrapped index q: plane indices
  // advance one a step, so `%` is taken only before the loop
  auto next = [nx](int q) { return q + 1 == nx ? 0 : q + 1; };

  // the register stage: x plane p+1 and b (or r and Ap) plane p of the
  // next step, p = i0 - 1 + s; q is the wrapped index of plane p
  TI xr[XW::kR], br[VW::kR], pr[VW::kR];
  auto stage = [&](int q) {
    if constexpr (kFromX) {
      const TI* src = x + (size_t)next(q) * plane;
#pragma unroll
      for (int rr = 0; rr < XW::kR; ++rr)
        if (XW::has(rr, tid)) xr[rr] = src[xw.off[rr]];
    }
    const size_t bp = (size_t)q * plane;
#pragma unroll
    for (int rr = 0; rr < VW::kR; ++rr) {
      if (!VW::has(rr, tid)) continue;
      if constexpr (kUpd) {
        br[rr] = r[bp + vw.off[rr]];
        pr[rr] = ap[bp + vw.off[rr]];
      } else {
        br[rr] = b[bp + vw.off[rr]];
      }
    }
  };

  C s0 = C(0), s1 = C(0);
  int sq = pmod(i0 - 1, nx);  // the wrapped plane p of the next stage
  int pg = sq;                // the wrapped plane p of the step
  int ig = pmod(i0 - 3, nx);  // the wrapped plane p - 2 of the step
  if constexpr (kFromX) {
    // x planes i0-2 and i0-1 go straight to shared memory
    for (int q = i0 - 2; q < i0; ++q) {
      const TI* src = x + (size_t)pmod(q, nx) * plane;
#pragma unroll
      for (int rr = 0; rr < XW::kR; ++rr)
        if (XW::has(rr, tid))
          xs[slot(q) * XW::kN + tid + rr * kTileThreads] = cvt<C>(src[xw.off[rr]]);
    }
  }
  stage(sq);
  sq = next(sq);
  // Step s (p = i0 - 1 + s): store the staged x plane p+1 and b plane p,
  // one barrier, stage the planes of step s + 1, compute x' of plane p
  // (s <= n+1) and the second colour of plane p-2 (s >= 3). One barrier
  // suffices: a thread still in step s-1 reads x planes p-2..p, b planes
  // p-1 and p-3 and x' planes p-4..p-2, none in the slot step s writes.
  for (int s = 0; s <= n + 2; ++s) {
    const int p = i0 - 1 + s;
    if (s <= n + 1) {
      if constexpr (kFromX) {
        C* dst = xs + slot(p + 1) * XW::kN;
#pragma unroll
        for (int rr = 0; rr < XW::kR; ++rr)
          if (XW::has(rr, tid)) dst[tid + rr * kTileThreads] = cvt<C>(xr[rr]);
      }
      C* dst = bs + slot(p) * VW::kN;
#pragma unroll
      for (int rr = 0; rr < VW::kR; ++rr)
        if (VW::has(rr, tid))
          dst[tid + rr * kTileThreads] =
              kUpd ? cvt<C>(br[rr]) - a * cvt<C>(pr[rr]) : cvt<C>(br[rr]);
    }
    __syncthreads();
    if (s <= n) stage(sq);
    sq = next(sq);
    if (s <= n + 1) {
      const C* b0 = bs + slot(p) * VW::kN;
      if (kUpd && s >= 1 && s <= n) {
        // b = r - alpha Ap, written and reduced once, at the points owned
#pragma unroll
        for (int h = 0; h < kOwn; ++h) {
          if (!own[h]) continue;
          const C bna = b0[oc[h]], bnb = b0[oc[h] + 1];
          store_pair(bout + (size_t)pg * plane + ooff[h], cvt<TI>(bna), cvt<TI>(bnb), own_b,
                     vec_b);
          s0 += bna * bna;
          s1 += bna;
          if (own_b) {
            s0 += bnb * bnb;
            s1 += bnb;
          }
        }
      }
      // the first colour of plane p on the tile and its 1-cell halo
      C* v0 = vs + slot(p) * VW::kN;
      const C* x0 = xs + slot(p) * XW::kN;
      const C* xm = xs + slot(p - 1) * XW::kN;
      const C* xp = xs + slot(p + 1) * XW::kN;
#pragma unroll
      for (int rr = 0; rr < kPR; ++rr) {
        if (tid + rr * kTileThreads >= kPN) continue;
        const int vc = pvc[rr];
        const bool ma = ((pg + ppar[rr]) & 1) == c0;
        const bool mb = ((pg + (ppar[rr] >> 1)) & 1) == c0;
        C va, vb;
        if constexpr (kFromX) {
          const int xc = pxc[rr];
          if (ma != mb) {
            const int du = ma ? 0 : 1, xu = xc + du;
            const C upd = sor_update<C, ISO>(x0[xu], b0[vc + du], xm[xu], xp[xu],
                                             x0[xu - XW::kZ], x0[xu + XW::kZ], x0[xu - 1],
                                             x0[xu + 1], k);
            const C cpy = x0[xc + 1 - du];
            va = ma ? upd : cpy;
            vb = ma ? cpy : upd;
          } else {  // a wrap on an odd extent: both cells of the colour, or neither
            va = x0[xc];
            vb = x0[xc + 1];
            if (ma) {
              va = sor_update<C, ISO>(va, b0[vc], xm[xc], xp[xc], x0[xc - XW::kZ],
                                      x0[xc + XW::kZ], x0[xc - 1], x0[xc + 1], k);
              vb = sor_update<C, ISO>(vb, b0[vc + 1], xm[xc + 1], xp[xc + 1],
                                      x0[xc + 1 - XW::kZ], x0[xc + 1 + XW::kZ], x0[xc],
                                      x0[xc + 2], k);
            }
          }
        } else {
          va = (ma ? k.winv : C(0)) * b0[vc];
          vb = (mb ? k.winv : C(0)) * b0[vc + 1];
        }
        v0[vc] = cvt<C>(cvt<TI>(va));  // x' rounds to the input type
        v0[vc + 1] = cvt<C>(cvt<TI>(vb));
      }
    }
    if (s >= 3) {
      // the second colour of plane p-2 at the pairs owned: the cells are
      // owned and adjacent, so exactly one is of colour c1
      const int i = p - 2;
      const C* v0 = vs + slot(i) * VW::kN;
      const C* vm = vs + slot(i - 1) * VW::kN;
      const C* vp = vs + slot(i + 1) * VW::kN;
      const C* b0 = bs + slot(i) * VW::kN;
#pragma unroll
      for (int h = 0; h < kOwn; ++h) {
        if (!own[h]) continue;
        const bool ua = ((ig + oj[h] + ok) & 1) == c1;
        const int du = ua ? 0 : 1, ou = oc[h] + du;
        const C upd = sor_update<C, ISO>(v0[ou], b0[ou], vm[ou], vp[ou], v0[ou - VW::kZ],
                                         v0[ou + VW::kZ], v0[ou - 1], v0[ou + 1], k);
        const C cpy = v0[oc[h] + 1 - du];
        const C va = ua ? upd : cpy, vb = ua ? cpy : upd;
        store_pair(out + (size_t)ig * plane + ooff[h], cvt<TO>(va), cvt<TO>(vb), own_b,
                   vec_out);
        if constexpr (MODE == kSweepDots) {
          s0 += va * b0[oc[h]];
          s1 += va;
          if (own_b) {
            s0 += vb * b0[oc[h] + 1];
            s1 += vb;
          }
        }
      }
    }
    pg = next(pg);
    ig = next(ig);
  }
  if constexpr (kSums) block_partials<C, kTileWarps>(s0, s1, part0, part1);
}

// shared memory of a sweep block: rings of four planes (x; x' and b)
template <typename C, int MODE>
constexpr size_t sweep_smem() {
  constexpr bool from_x = MODE == kSweep || MODE == kSweepDots;
  return (size_t)((from_x ? 4 * TileWindow<2>::kN : 0) + 8 * TileWindow<1>::kN) * sizeof(C);
}

struct RbsorCoef {
  double ivx, ivy, ivz, center, six_iv, winv;
  template <typename C>
  Coef<C> as() const {
    return Coef<C>{C(ivx), C(ivy), C(ivz), C(center), C(six_iv), C(winv)};
  }
};

struct SweepArgs {
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

// the x planes a sweep block walks
inline int sweep_chunk(int nx, int ny, int nz) { return tile_chunk(nx, ny, nz, 32); }

template <typename TI, typename TO, int MODE, bool ISO>
cudaError_t launch_sweep(cudaStream_t s, const SweepArgs& a, int nx, int ny, int nz,
                         const RbsorCoef& k, int c0) {
  using C = typename Compute<TI>::type;
  const int chunk = sweep_chunk(nx, ny, nz);
  constexpr size_t smem = sweep_smem<C, MODE>();
  if constexpr (smem > 48 * 1024) {  // above the default limit (f64 with x)
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<TI, TO, MODE, ISO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sweep_kernel<TI, TO, MODE, ISO><<<tile_grid(nx, ny, nz, chunk), tile_block(), smem, s>>>(
      static_cast<const TI*>(a.x), static_cast<const TI*>(a.b), static_cast<const TI*>(a.r),
      static_cast<const TI*>(a.ap), static_cast<const TI*>(a.alpha), static_cast<TO*>(a.out),
      static_cast<TI*>(a.bout), static_cast<C*>(a.part0), static_cast<C*>(a.part1), nx, ny, nz,
      chunk, k.as<C>(), c0);
  return cudaGetLastError();
}

// Every mode, for the same-type pairs f32 -> f32 and f64 -> f64.
template <typename T, bool ISO>
cudaError_t launch_sweep_wide(int mode, cudaStream_t s, const SweepArgs& a, int nx, int ny,
                              int nz, const RbsorCoef& k, int c0) {
  switch (mode) {
    case kSweep:
      return launch_sweep<T, T, kSweep, ISO>(s, a, nx, ny, nz, k, c0);
    case kSweepDots:
      return launch_sweep<T, T, kSweepDots, ISO>(s, a, nx, ny, nz, k, c0);
    case kZeroSweep:
      return launch_sweep<T, T, kZeroSweep, ISO>(s, a, nx, ny, nz, k, c0);
    case kZeroUpdateSweep:
      return launch_sweep<T, T, kZeroUpdateSweep, ISO>(s, a, nx, ny, nz, k, c0);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool ISO>
cudaError_t launch_sweep_typed(int tin, int tout, int mode, cudaStream_t s, const SweepArgs& a,
                               int nx, int ny, int nz, const RbsorCoef& k, int c0) {
  using BF = __nv_bfloat16;
  if (tin == kF32 && tout == kF32) return launch_sweep_wide<float, ISO>(mode, s, a, nx, ny, nz, k, c0);
  if (tin == kF64 && tout == kF64)
    return launch_sweep_wide<double, ISO>(mode, s, a, nx, ny, nz, k, c0);
  if (tin == kBF16 && tout == kBF16 && mode == kSweep)
    return launch_sweep<BF, BF, kSweep, ISO>(s, a, nx, ny, nz, k, c0);
  if (tin == kBF16 && tout == kBF16 && mode == kZeroSweep)
    return launch_sweep<BF, BF, kZeroSweep, ISO>(s, a, nx, ny, nz, k, c0);
  if (tin == kF32 && tout == kBF16 && mode == kZeroUpdateSweep)
    return launch_sweep<float, BF, kZeroUpdateSweep, ISO>(s, a, nx, ny, nz, k, c0);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_colour(int iso, cudaStream_t s, const void* x, const void* b, void* out,
                          int nx, int ny, int nz, const RbsorCoef& k, int color) {
  using C = typename Compute<T>::type;
  const T* xx = static_cast<const T*>(x);
  const T* bb = static_cast<const T*>(b);
  T* oo = static_cast<T*>(out);
  if (iso)
    colour_kernel<T, true><<<launch_grid(nx, ny, nz), launch_block(), 0, s>>>(
        xx, bb, oo, nx, ny, nz, k.as<C>(), color);
  else
    colour_kernel<T, false><<<launch_grid(nx, ny, nz), launch_block(), 0, s>>>(
        xx, bb, oo, nx, ny, nz, k.as<C>(), color);
  return cudaGetLastError();
}

}  // namespace poissbox

extern "C" {

// One red-black sweep, one launch. tin/tout: dtype codes (0 float32, 1
// float64, 2 bfloat16) of the inputs and of out; mode: 0 general, 1 general
// + dots, 2 from zero, 3 from zero with CG's update fused in; iso: 1 when
// ivx == ivy == ivz; c0: the first colour. Pointers a mode does not use may
// be null; part0/part1 hold poissbox_rbsor_sweep_blocks slots. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a type
// pair the mode does not take).
int poissbox_rbsor_sweep(int tin, int tout, int mode, int iso, int device, void* stream,
                         const void* x, const void* b, const void* r, const void* ap,
                         const void* alpha, void* out, void* bout, void* part0, void* part1,
                         int nx, int ny, int nz, double ivx, double ivy, double ivz,
                         double center, double six_iv, double winv, int c0) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const poissbox::SweepArgs a{x, b, r, ap, alpha, out, bout, part0, part1};
  const poissbox::RbsorCoef k{ivx, ivy, ivz, center, six_iv, winv};
  if (iso)
    err = poissbox::launch_sweep_typed<true>(tin, tout, mode, s, a, nx, ny, nz, k, c0);
  else
    err = poissbox::launch_sweep_typed<false>(tin, tout, mode, s, a, nx, ny, nz, k, c0);
  return (int)err;
}

// The blocks of a sweep launch over (nx, ny, nz): one reduction partial each.
int poissbox_rbsor_sweep_blocks(int nx, int ny, int nz) {
  const dim3 g = poissbox::tile_grid(nx, ny, nz, poissbox::sweep_chunk(nx, ny, nz));
  return (int)(g.x * g.y * g.z);
}

// One colour update (K11): t is the dtype code of x, b and out (0 float32,
// 1 float64, 2 bfloat16). Returns the cudaError_t of the launch.
int poissbox_rbsor_colour(int t, int iso, int device, void* stream, const void* x,
                          const void* b, void* out, int nx, int ny, int nz, double ivx,
                          double ivy, double ivz, double center, double six_iv, double winv,
                          int color) {
  using namespace poissbox;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RbsorCoef k{ivx, ivy, ivz, center, six_iv, winv};
  if (t == kF32) return (int)launch_colour<float>(iso, s, x, b, out, nx, ny, nz, k, color);
  if (t == kF64) return (int)launch_colour<double>(iso, s, x, b, out, nx, ny, nz, k, color);
  if (t == kBF16)
    return (int)launch_colour<__nv_bfloat16>(iso, s, x, b, out, nx, ny, nz, k, color);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
