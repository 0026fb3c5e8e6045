// KB `rbsor`: red-black SOR on the periodic 7-point Laplacian. A colour
// update gives every point with (i+j+k) % 2 == c
//   x + winv * (b - A x),   winv = w / diag,  diag = -2 * sum(1/d^2) < 0,
// and copies every point of the other colour. A sweep is two colour updates,
// c0 then c1 = 1 - c0 ((0, 1), or (1, 0) when reversed), here in ONE launch.
//
// Replaces these TPU kernels of poissbox_tpu/ops/stencil_pallas.py:
//   K11 _sor (_upd_sor)                   one colour update: colour_kernel
//       (its own streamed kernel, below the sweep's design)
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
// On an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6) the kernel
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
// Design (colour_kernel, K11: one colour update, the colour update of every
// distributed multigrid level). KA's streamed skeleton (stencil7.cu) with
// the sweep's pairs: a block of 256 threads owns a 32 x 16 (y, z) tile on
// KA's grid (common.cuh ka_chunk: about 4096 blocks) and walks its chunk of
// x planes. The plane at hand sits in shared memory as a window with a
// 1-cell periodic halo in y and a 2-cell one in z (PairWindow), in a ring of
// three slots, one barrier a plane. A thread owns one z-adjacent pair of the
// tile a plane, k even: it updates the cell of the colour, chosen by its
// address (no warp diverges), and copies the other; x[i-1] of its pair is
// kept in registers from the step before, x[i+1] read at its pair of the
// next slot, so each x value comes from HBM about once. On an even z extent
// with aligned fields every window pair, b's pair and the stored pair move
// as one vector (VEC), so a bf16 cell costs half the load and store
// instructions of the point kernel it replaced; otherwise cell by cell.
// The next planes' windows and b are loaded into registers right after the
// barrier, one plane ahead, two in bf16 (the same registers then keep twice
// the bytes in flight). An owned pair never straddles the z wrap: on an odd
// extent the last one of a row is the lone cell nz - 1, updated or copied by
// its own parity, its z+1 neighbour the window's wrapped cell 0.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6) K11 takes
// 0.1094 ms in bf16 on the (256, 256, 512) block of the distributed 512^3
// level, 54.9 % of its bound (the one-thread-a-point kernel it replaced:
// 0.1770 ms, 34.0 %), 0.3996 ms in bf16 at 512^3 (60.2 %), 0.0827 ms in
// f32 at 256^3 (72.7 %; before 0.0896) and 0.1542 ms in f32 on the block
// (77.9 %; before 0.1730). What still holds bf16 back: a load moves half
// the bytes of an f32 one, and six blocks an SM two planes ahead keep too
// few bytes in flight to cover HBM's latency; a grid of 8192 blocks and
// f32 staged two planes ahead each moved the four cases by under 3 %.
//
// Bound on an H100 SXM (3.35 TB/s): a general sweep reads x and b and
// writes x_out, 3 field passes (0.060 ms at 256^3 f32, 0.240 ms at 512^3
// bf16); the zero sweep 2 (0.040; bf16 512^3 0.160); the fused update reads
// r and Ap and writes b and x1, 4 passes (0.080; narrow at 512^3 0.561).
// The colour update (K11) is 3 passes (0.060 ms at 256^3 f32 and in bf16
// on the (256, 256, 512) block, 0.120 ms there in f32, 0.240 ms at 512^3
// bf16): a sweep of two of them is 6.
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

// K11's window: the tile with a 1-cell halo in y and a 2-cell halo in z,
// kY rows of kZ cells, z fastest, staged as kP z-adjacent pairs (cells
// k0 - 2 + 2p and k0 - 1 + 2p of a row), so that on an even z extent every
// window pair starts at an even k and is one aligned vector in memory.
// Pair e of the window sits at cells 2e and 2e + 1 of the row-major window.
struct PairWindow {
  static constexpr int kZ = kTZ + 4;
  static constexpr int kY = kTY + 2;
  static constexpr int kN = kZ * kY;
  static constexpr int kP = kN / 2;
  static constexpr int kR = (kP + kTileThreads - 1) / kTileThreads;
  __device__ __forceinline__ static bool has(int r, int tid) {
    return tid + r * kTileThreads < kP;
  }
};

// Blocks an SM must hold, which caps the registers: KA's six (42
// registers), or four (64) in f64, whose pairs take twice the registers.
template <typename C>
constexpr int colour_blocks_per_sm() {
  return sizeof(C) == 8 ? 4 : kKaResident;
}

// K11: one colour update of the block's tile over its chunk of x planes
// (see the header). VEC: the z extent is even and x, b and out are aligned
// to a pair, so every pair moves as one vector; otherwise cell by cell.
template <typename T, bool ISO, bool VEC>
__global__ void __launch_bounds__(kTileThreads, colour_blocks_per_sm<typename Compute<T>::type>())
colour_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out, int nx,
              int ny, int nz, int chunk, Coef<typename Compute<T>::type> k, int color) {
  using C = typename Compute<T>::type;
  using T2 = typename Vec2<T>::type;
  using C2 = typename Vec2<C>::type;
  using PW = PairWindow;
  __shared__ __align__(16) C xs[3][PW::kN];
  const int tid = threadIdx.x + kTZ * threadIdx.y;
  const int j0 = blockIdx.y * kTY, k0 = blockIdx.x * kTZ;
  const int i0 = blockIdx.z * chunk;
  const int n = min(chunk, nx - i0);
  const size_t plane = (size_t)ny * nz;
  // the window pairs this thread stages: the offsets in a plane of their
  // first cells (and, cell by cell, of their second)
  int woff[PW::kR], woff1[PW::kR];
#pragma unroll
  for (int rr = 0; rr < PW::kR; ++rr) {
    const int e = tid + rr * kTileThreads;
    const int row = pmod(j0 - 1 + e / (PW::kZ / 2), ny) * nz, kz = k0 - 2 + 2 * (e % (PW::kZ / 2));
    woff[rr] = row + pmod(kz, nz);
    woff1[rr] = row + pmod(kz + 1, nz);
  }
  // the pair this thread owns in each plane: cells (oj, ok) and (oj, ok + 1)
  // of the tile, oc the first one's place in the window. ok is even, so on
  // an even extent the pair holds one cell of each colour; on an odd one
  // the last pair of a row is the lone cell nz - 1.
  const int orow = tid / (kTZ / 2), ozp = tid % (kTZ / 2);
  const int oj = j0 + orow, ok = k0 + 2 * ozp;
  const bool own = oj < ny && ok < nz;
  const bool own_b = own && ok + 1 < nz;
  const int oc = (orow + 1) * PW::kZ + 2 + 2 * ozp;
  const size_t ooff = (size_t)oj * nz + ok;
  const int jk = (oj + ok) & 1;
  const T zero = cvt<T>(C(0));
  auto next = [nx](int q) { return q + 1 == nx ? 0 : q + 1; };

  // the register stages, kDepth planes ahead: the window of an x plane, b
  // at the pair owned. bf16 stages two planes ahead, which keeps twice the
  // bytes of a 4-byte type's one plane in flight for the same registers.
  constexpr int kDepth = sizeof(T) == 2 ? 2 : 1;
  T2 xr[kDepth][PW::kR], br[kDepth];
  auto stage_x = [&](T2(&dst)[PW::kR], int q) {
    const T* src = x + (size_t)q * plane;
#pragma unroll
    for (int rr = 0; rr < PW::kR; ++rr) {
      if (!PW::has(rr, tid)) continue;
      if constexpr (VEC) {
        dst[rr] = *reinterpret_cast<const T2*>(src + woff[rr]);
      } else {
        dst[rr].x = src[woff[rr]];
        dst[rr].y = src[woff1[rr]];
      }
    }
  };
  // the pair owned in the plane at src (a lone cell's partner reads 0)
  auto owned = [&](const T* src) {
    T2 v;
    if constexpr (VEC) {
      v = *reinterpret_cast<const T2*>(src + ooff);
    } else {
      v.x = src[ooff];
      v.y = own_b ? src[ooff + 1] : zero;
    }
    return v;
  };
  auto put = [&](C* dst, const T2(&src)[PW::kR]) {
#pragma unroll
    for (int rr = 0; rr < PW::kR; ++rr) {
      if (!PW::has(rr, tid)) continue;
      C2 v;
      v.x = cvt<C>(src[rr].x);
      v.y = cvt<C>(src[rr].y);
      *reinterpret_cast<C2*>(dst + 2 * (tid + rr * kTileThreads)) = v;
    }
  };
  // qx, qb: the wrapped planes of the next x window and the next b to stage
  int qx = i0, qb = i0;
  auto stage = [&](int d) {
    stage_x(xr[d], qx);
    qx = next(qx);
    if (own) br[d] = owned(b + (size_t)qb * plane);
    qb = next(qb);
  };

  // plane i0 in slot 0; x[i0 - 1] at the pair owned; planes i0 + 1 ... and
  // b of planes i0 ... staged
  int qi = i0;  // the wrapped plane i of the step (i0 < nx)
  stage_x(xr[0], qx);
  qx = next(qx);
  put(xs[0], xr[0]);
  C2 um;  // x[i - 1] at the pair owned
  um.x = um.y = C(0);
  if (own) {
    const T2 v = owned(x + (size_t)pmod(i0 - 1, nx) * plane);
    um.x = cvt<C>(v.x);
    um.y = cvt<C>(v.y);
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    br[d].x = br[d].y = zero;
    if (d < n) stage(d);
  }
  int s0 = 0, s1 = 1;  // the slots of planes i and i + 1
  // Step t (plane i = i0 + t): store the staged plane i + 1, one barrier,
  // stage plane i + 1 + kDepth and b of plane i + kDepth, update plane i.
  // Three slots let one barrier a step suffice: a thread still in step
  // t - 1 reads planes i - 1 and i, never the slot step t writes.
  for (int t = 0; t < n; ++t) {
    put(xs[s1], xr[0]);
    const T2 bv = br[0];
#pragma unroll
    for (int d = 1; d < kDepth; ++d) {
#pragma unroll
      for (int rr = 0; rr < PW::kR; ++rr) xr[d - 1][rr] = xr[d][rr];
      br[d - 1] = br[d];
    }
    __syncthreads();
    const int q1 = next(qi);
    if (t + kDepth < n) stage(kDepth - 1);
    if (own) {
      const C* x0 = xs[s0];
      const C2 cc = *reinterpret_cast<const C2*>(x0 + oc);
      // the cell of the colour, chosen by its address: the first when the
      // pair's parity at plane i is the colour, else the second
      const bool ua = ((qi + jk) & 1) == color;
      const int cu = oc + (ua ? 0 : 1);
      const C zo = x0[ua ? oc - 1 : oc + 2];  // its z neighbour outside the pair
      const C upd = sor_update<C, ISO>(ua ? cc.x : cc.y, cvt<C>(ua ? bv.x : bv.y),
                                       ua ? um.x : um.y, xs[s1][cu], x0[cu - PW::kZ],
                                       x0[cu + PW::kZ], ua ? zo : cc.x, ua ? cc.y : zo, k);
      store_pair(out + (size_t)qi * plane + ooff, cvt<T>(ua ? upd : cc.x),
                 cvt<T>(ua ? cc.y : upd), own_b, VEC);
      um = cc;
    }
    const int s2 = 3 - s0 - s1;
    s0 = s1;
    s1 = s2;
    qi = q1;
  }
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

template <typename T, bool ISO, bool VEC>
cudaError_t launch_colour_as(cudaStream_t s, const T* x, const T* b, T* out, int nx, int ny,
                             int nz, const RbsorCoef& k, int color) {
  using C = typename Compute<T>::type;
  const int chunk = ka_chunk(nx, ny, nz);
  colour_kernel<T, ISO, VEC><<<tile_grid(nx, ny, nz, chunk), tile_block(), 0, s>>>(
      x, b, out, nx, ny, nz, chunk, k.as<C>(), color);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_colour(int iso, cudaStream_t s, const void* x, const void* b, void* out,
                          int nx, int ny, int nz, const RbsorCoef& k, int color) {
  const T* xx = static_cast<const T*>(x);
  const T* bb = static_cast<const T*>(b);
  T* oo = static_cast<T*>(out);
  constexpr size_t kPair = 2 * sizeof(T);
  const bool vec = !(nz & 1) && !(reinterpret_cast<size_t>(x) % kPair) &&
                   !(reinterpret_cast<size_t>(b) % kPair) && !(reinterpret_cast<size_t>(out) % kPair);
  if (iso)
    return vec ? launch_colour_as<T, true, true>(s, xx, bb, oo, nx, ny, nz, k, color)
               : launch_colour_as<T, true, false>(s, xx, bb, oo, nx, ny, nz, k, color);
  return vec ? launch_colour_as<T, false, true>(s, xx, bb, oo, nx, ny, nz, k, color)
             : launch_colour_as<T, false, false>(s, xx, bb, oo, nx, ny, nz, k, color);
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
