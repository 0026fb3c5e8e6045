// K15 `compact`: the 6th-order staggered compact operators as one line
// kernel along one axis of a 3-D field.
//
// Replaces these TPU kernels of poissbox_tpu/ops/compact_pcr.py (their
// bodies at :196-269, launched by _yz_call :282, _x_call :304 and lapl's
// own call :431): _yz_front_kernel, _yz_back_kernel, _yz_interp_kernel,
// _op1_kernel, _yz_lapl_kernel, _x_kernel and _x_sum_kernel. It also
// carries tridiag_pallas.py's _pcr_kernel (K14, :297, via
// _solve_pcr_blocks :303): a circulant PCR solve is the same kernel with
// the RHS taps replaced by a scale.
//
// Every operator solves the circulant system alpha*g[i-1] + g[i] +
// alpha*g[i+1] = rhs[i] along one axis, by the truncated PCR schedule of
// ops/compact_pcr.py: rhs from the staggered taps
//   a*(f[i+sh] + s*f[i+sh-1]) + b*(f[i+sh+1] + s*f[i+sh-2]),
// then d <- d - f_k*(d[i-2^k] + d[i+2^k]) for each step k, then d*(1/bF)
// (or, for an exact schedule, the (i, i+n/2) pairing). All indices wrap
// mod n, so every n >= 4 runs, powers of two or not.
//
// A launch runs a small static program: up to 3 inputs and 3 outputs;
// each output is the sum of up to 2 terms, a term a chain of up to 2
// operators along the launch's axis applied to one input. The Laplacian
// is three launches (z: iz'iz f and gz'gz f; y: iy'iy a1 and gy'gy a1 +
// iy'iy a3; x: gx'gx b1 + ix'ix b23), the gradient, divergence and
// interpolation three launches each with other programs.
//
// Layout: the field is viewed as (P, n, Q) with the line axis in the
// middle. For x and y lines (Q > 1) a block holds W neighbouring columns
// q of one p, all n rows of each (a row of W values is one coalesced
// load); for z lines (Q = 1) it holds W consecutive lines, one contiguous
// stretch of W*n values. Two kernels evaluate the program on those lines,
// and the wrapper (compact_pcr.route) picks one by the line length alone;
// a launch failure of either raises, neither stands in for the other:
//
// The register kernel (compact_reg_kernel), for n = 32*m, m in compact_pcr.REG_M
// (n = 64, 96, 128, 256, 384, 512, 640: every extent the solver's paths and
// the JAX package's bench use), float32 and float64. A warp owns a line,
// held in registers as 32 contiguous chunks: lane l holds points l*m ..
// l*m+m-1, m a template parameter, so every loop over a chunk unrolls and
// every register index is static. A periodic shift by s reads point
// l*m+j+s from lane (l + (j+s)/m) mod 32, register (j+s) mod m (the rule of
// compact_pcr.reg_source): a register rename where the lane offset is 0,
// else one __shfl_sync; the line's period is the lane wrap, so nothing is
// wrapped by hand. The taps use s in -2..+1 beside the stagger, PCR step k
// s = 2^k mod n (steps unrolled up to kMaxSteps, guarded by k < nsteps, so
// s is static too), the exact pairing s = n/2 (whole registers from lane
// l+16). A whole program runs in registers: no shared-memory pass and no
// barrier between operators, and a two-term output keeps its first term in
// registers while the second runs. Every warp runs the program, a warp
// whose line lies past the edge too (it stores nothing): a shuffle under a
// branch that depends on the thread makes the compiler guard each one for
// divergence (WARPSYNC and ENDCOLLECTIVE around every SHFL), which about
// doubles the registers a thread needs.
//   A z line is contiguous and lane l's chunk is the m values at l*m, so z
// lines go straight between global memory and registers, in 16-byte
// vectors where m and the fields' alignment allow, with no tile and no
// barrier. x and y lines go through shared memory once each way: a block
// of W = kRegWarps = 8 warps owns 8 neighbouring columns (a row of 8 values
// is one 32-byte sector in f32), loads them into an input tile with
// coalesced row loads, and each warp reads its column into its chunks; the
// results go back through an output tile. Each line of a tile has a chunk
// stride of m+1 for even m and a pitch 16 bytes past a multiple of 32
// words, so the row accesses and the chunk reads are free of bank
// conflicts, and the elements' addresses are walked by constant strides
// (RegWalk) with no division. An input stays in its tile while consecutive
// terms read it (the Laplacian's y sweep loads a1 once for both outputs).
//   Registers: a line, its next step and a two-term output's first term
// are 3m values; the launch bounds (reg_threads_per_sm) hold f32 at m <= 8
// to 64 registers (four blocks an SM), m = 12 and 16 to 80 (three), m = 20
// to 128 (two); f64 at m <= 4 to 64, m = 8 to 80, m = 12 and 16 to 128,
// m = 20 to 255 (ptxas: 206, one block). No instantiation spills. The
// other blocks on an SM cover a block's loads and barriers; nothing is
// prefetched across lines.
//
// The tile kernel (compact_kernel), for every other n >= 4 (the tests' 6,
// 20, 24, 33, 40, 48, any n < 64): its operators run as passes over a tile
// in shared memory. The tile sits as [i][w] with a pitch of W+1 (no bank
// conflicts in either load order); the W lanes are independent lines, so a
// step over the tile is n*W independent updates, spread over the block's
// threads, ping-ponging between buffers with a __syncthreads() between
// steps. Three buffers hold a two-term output, two otherwise. W is 32, 16
// or 8: the widest whose buffers let two blocks share an SM, else the
// widest that fits the 227 KB one block may use (the wrapper picks it). It
// stays because a register line needs n to be a multiple of 32 and an
// instantiation for each m: the tile kernel takes any n up to the length
// whose tile fits shared memory, at about 8x its HBM floor.
//
// Rounding: each operation is one IEEE operation in the order of the
// plain version (compact_pcr._vrhs/_vpcr with torch.roll), and the
// library is built with --fmad=false, so both kernels and plain agree.
//
// Bound on an H100 SXM (3.35 TB/s): the HBM floor is one read of each
// input and one write of each output, 10 field passes for the Laplacian
// (1.60 ms at 512^3 f32; the TPU's regrouped two-kernel form moves 6).
// The arithmetic is 7 operations a point for the taps, 3 a PCR step and 1
// for the scale: about 20 an operator in f32 (4 steps at 512), 6 operators
// in the Laplacian's y sweep, so 121 a point, 0.48 ms of f32 issue at 512^3
// with --fmad=false (every multiply and add issued alone) against 0.64 ms of
// HBM; the register kernel adds about 2 shuffles a point an operator. On
// an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6) the register kernel runs
// the 512^3 f32 sweeps at 48-66 % of their floors (the Laplacian 3.0 ms, 53
// %), bound by instruction issue: each add, multiply and shuffle is one
// instruction, and the x and y sweeps add their tile phases and barriers.
// What is left: fusing the z and y sweeps (thread-block clusters with
// distributed shared memory) to reach 6 HBM passes.
#include "common.cuh"

#include <utility>

namespace poissbox {

constexpr int kMaxSteps = 12;
constexpr int kMaxIn = 3;
constexpr int kMaxOut = 3;
constexpr int kCompactThreads = 512;

template <typename T>
struct COp {
  int taps;       // 1: staggered RHS taps; 0: scale by `a` (a plain PCR solve)
  int shift;      // 0 (cell -> vertex) or 1 (vertex -> cell)
  int nsteps;     // PCR steps
  int pair;       // 1: exact schedule, final (i, i+n/2) pairing
  T a, b, s;      // taps' coefficients, s = opsign (+-1)
  T f[kMaxSteps]; // elimination factors
  T c1, c2;       // final: d*c1 (truncated) or c1*d - c2*d[i+n/2] (pair)
};

template <typename T>
struct CTerm {
  int input, nops;
  COp<T> op[2];
};

template <typename T>
struct COut {
  int nterms;
  CTerm<T> term[2];
};

template <typename T>
struct CProgram {
  int nin, nout;
  COut<T> out[kMaxOut];
};

// The tile this block owns: element (i, w) of lane w sits at
// base + i*line_stride + w*lane_stride; lanes w >= nl lie past the edge.
struct TileMap {
  long long base, line_stride, lane_stride;
  int nl;
};

template <int W>
__device__ __forceinline__ TileMap tile_map(long long P, int n, long long Q) {
  TileMap m;
  if (Q > 1) {
    const long long qblocks = (Q + W - 1) / W;
    const long long p = blockIdx.x / qblocks;
    const long long q0 = (blockIdx.x % qblocks) * W;
    m.base = p * n * Q + q0;
    m.line_stride = Q;
    m.lane_stride = 1;
    m.nl = (int)min((long long)W, Q - q0);
  } else {
    const long long p0 = (long long)blockIdx.x * W;
    m.base = p0 * n;
    m.line_stride = 1;
    m.lane_stride = n;
    m.nl = (int)min((long long)W, P - p0);
  }
  return m;
}

// Element e of the tile (e < n*W, in load order): its row i, lane w and
// offset in the field. Rows of W lanes are contiguous for x/y lines
// (lane_stride 1), whole lines for z lines.
template <int W>
__device__ __forceinline__ void tile_elem(int e, const TileMap& m, int n, int* i, int* w,
                                          long long* off) {
  if (m.lane_stride == 1) {
    *i = e / W;
    *w = e % W;
    *off = m.base + *i * m.line_stride + *w;
  } else {
    *w = e / n;
    *i = e - *w * n;
    *off = m.base + *w * m.lane_stride + *i;
  }
}

// Global -> shared, kLoadBatch independent loads in flight per thread
// before their shared-memory stores (one block per SM holds few warps, so
// the loads, not the warps, have to carry the memory parallelism).
constexpr int kLoadBatch = 8;

template <typename T, int W>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g, const TileMap& m,
                                          int n) {
  constexpr int kPitch = W + 1;
  const int total = n * W;
  const int step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoadBatch * step) {
    T v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      int i, w;
      long long off;
      const int e = e0 + j * step;
      tile_elem<W>(e < total ? e : 0, m, n, &i, &w, &off);
      v[j] = (e < total && w < m.nl) ? g[off] : T(0);
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      int i, w;
      long long off;
      const int e = e0 + j * step;
      if (e < total) {
        tile_elem<W>(e, m, n, &i, &w, &off);
        s[i * kPitch + w] = v[j];
      }
    }
  }
}

// out = s0 (+ s1 when s1 is not null), stored to the owned lanes
template <typename T, int W>
__device__ __forceinline__ void store_tile(T* __restrict__ g, const T* s0, const T* s1,
                                           const TileMap& m, int n) {
  constexpr int kPitch = W + 1;
  const int total = n * W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int i, w;
    long long off;
    tile_elem<W>(e, m, n, &i, &w, &off);
    if (w >= m.nl) continue;
    T v = s0[i * kPitch + w];
    if (s1 != nullptr) v = v + s1[i * kPitch + w];
    g[off] = v;
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// One operator on the tile in buffer `cur` (the other buffer `nxt` is
// scratch); returns the buffer holding the result. Inlined, so `op` stays
// a read of the kernel's parameter space and is never copied per thread.
// The block has kCompactThreads threads, a multiple of W, so a thread
// keeps one lane w and walks the rows i0, i0 + kRowStep, ... in every
// pass. A truncated schedule's final scale is applied where the last step
// stores (the same two roundings as a separate pass, one pass fewer).
template <typename T, int W>
__device__ __forceinline__ int apply_op(T* smem, int tile, int cur, int nxt, const COp<T>& op, int n) {
  constexpr int kPitch = W + 1;
  constexpr int kRowStep = kCompactThreads / W;
  const int i0 = threadIdx.x / W;
  const int w = threadIdx.x % W;
  T* src = smem + cur * tile + w;
  T* dst = smem + nxt * tile + w;
  const T c1 = op.c1, c2 = op.c2;
  if (op.taps) {
    const T a = op.a, b = op.b, s = op.s;
    const int sh = op.shift;
    for (int i = i0; i < n; i += kRowStep) {
      const T x0 = src[wrap(i + sh, n) * kPitch];
      const T x1 = src[wrap(i + sh - 1, n) * kPitch];
      const T x2 = src[wrap(i + sh + 1, n) * kPitch];
      const T x3 = src[wrap(i + sh - 2, n) * kPitch];
      const T t1 = x0 + s * x1;
      const T t2 = x2 + s * x3;
      dst[i * kPitch] = a * t1 + b * t2;
    }
    __syncthreads();
    T* t = src;
    src = dst;
    dst = t;
    const int c = cur;
    cur = nxt;
    nxt = c;
  } else {
    const T a = op.a;
    for (int i = i0; i < n; i += kRowStep) src[i * kPitch] = src[i * kPitch] * a;
    __syncthreads();
  }
  for (int k = 0; k < op.nsteps; ++k) {
    const T f = op.f[k];
    const int sm = (int)((1LL << k) % n);
    const bool scale = !op.pair && k == op.nsteps - 1;
    for (int i = i0; i < n; i += kRowStep) {
      const T lo = src[wrap(i - sm, n) * kPitch];
      const T hi = src[wrap(i + sm, n) * kPitch];
      const T d = src[i * kPitch];
      T v = d - f * (lo + hi);
      if (scale) v = v * c1;
      dst[i * kPitch] = v;
    }
    __syncthreads();
    T* t = src;
    src = dst;
    dst = t;
    const int c = cur;
    cur = nxt;
    nxt = c;
  }
  if (op.pair) {
    const int half = n / 2;
    for (int i = i0; i < n; i += kRowStep) {
      const T d = src[i * kPitch];
      const T dn = src[wrap(i + half, n) * kPitch];
      dst[i * kPitch] = c1 * d - c2 * dn;
    }
    __syncthreads();
    return nxt;
  }
  if (op.nsteps == 0) {
    for (int i = i0; i < n; i += kRowStep) src[i * kPitch] = src[i * kPitch] * c1;
    __syncthreads();
  }
  return cur;
}

template <typename T, int W>
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const CProgram<T> prog, const T* __restrict__ in0, const T* __restrict__ in1,
               const T* __restrict__ in2, T* __restrict__ out0, T* __restrict__ out1,
               T* __restrict__ out2, long long P, int n, long long Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tile = n * (W + 1);
  const TileMap m = tile_map<W>(P, n, Q);
  const T* ins[kMaxIn] = {in0, in1, in2};
  T* outs[kMaxOut] = {out0, out1, out2};
  for (int o = 0; o < prog.nout; ++o) {
    const COut<T>& out = prog.out[o];
    int res[2] = {0, -1};
    for (int t = 0; t < out.nterms; ++t) {
      const CTerm<T>& term = out.term[t];
      // the two buffers not holding the first term's result
      int cur = 0, nxt = 1;
      if (t == 1) {
        cur = res[0] == 0 ? 1 : 0;
        nxt = res[0] == 2 ? 1 : 2;
      }
      load_tile<T, W>(smem + cur * tile, ins[term.input], m, n);
      __syncthreads();
      for (int k = 0; k < term.nops; ++k) {
        const int r = apply_op<T, W>(smem, tile, cur, nxt, term.op[k], n);
        nxt = r == cur ? nxt : cur;
        cur = r;
      }
      res[t] = cur;
    }
    store_tile<T, W>(outs[o], smem + res[0] * tile,
                     out.nterms == 2 ? smem + res[1] * tile : nullptr, m, n);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the register kernel: a warp owns a line of n = 32*M points
// ---------------------------------------------------------------------------

constexpr int kRegWarps = 8;  // lines a block (the W of its tiles)
constexpr int kRegThreads = 32 * kRegWarps;
constexpr unsigned kFullMask = 0xffffffffu;

// The shared-memory layout of one line of a register tile: point i at
// chunk i / M, offset i % M; a chunk stride of M+1 for even M (odd either
// way), so lane l reading offset j of its chunk hits bank l*kCS + j, all
// distinct; lines kLine apart, 16 bytes past a multiple of 32 words, so a
// row of kRegWarps lines lands on distinct banks too.
template <typename T, int M>
struct RegLayout {
  static constexpr int kCS = M % 2 == 0 ? M + 1 : M;
  static constexpr int kLine = 32 * kCS + 16 / (int)sizeof(T);
  static constexpr int kTile = kRegWarps * kLine;
  __device__ __forceinline__ static int pos(int i) { return (i / M) * kCS + i % M; }
};

// Point l*M + j + S of the line (S in [0, 32*M)) for lane l: register
// (j+S) % M of lane l + (j+S) / M (compact_pcr.reg_source). j is a
// constant wherever this is called (every loop over a chunk unrolls).
template <int M, int S, typename T>
__device__ __forceinline__ T reg_at(const T (&v)[M], int j, int lane) {
  const int q = (j + S) / M, r = (j + S) % M;
  return (q & 31) == 0 ? v[r] : __shfl_sync(kFullMask, v[r], (lane + q) & 31);
}

// S mod n in [0, n), n = 32*M, for any S
template <int M, int S>
struct Wrap {
  static constexpr int value = ((S % (32 * M)) + 32 * M) % (32 * M);
};

// the staggered RHS taps a*(f[i+SH] + s*f[i+SH-1]) + b*(f[i+SH+1] + s*f[i+SH-2])
template <int M, int SH, typename T>
__device__ __forceinline__ void reg_taps(T (&d)[M], T a, T b, T s, int lane) {
  T nd[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const T x0 = reg_at<M, Wrap<M, SH>::value>(d, j, lane);
    const T x1 = reg_at<M, Wrap<M, SH - 1>::value>(d, j, lane);
    const T x2 = reg_at<M, Wrap<M, SH + 1>::value>(d, j, lane);
    const T x3 = reg_at<M, Wrap<M, SH - 2>::value>(d, j, lane);
    const T t1 = x0 + s * x1;
    const T t2 = x2 + s * x3;
    nd[j] = a * t1 + b * t2;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) d[j] = nd[j];
}

// PCR step K: d <- d - f_K * (d[i - 2^K] + d[i + 2^K]), when K < nsteps
template <int K, int M, typename T>
__device__ __forceinline__ void reg_step(T (&d)[M], const COp<T>& op, int lane) {
  if (K < op.nsteps) {
    constexpr int S = Wrap<M, (1 << K)>::value;
    const T f = op.f[K];
    T nd[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T lo = reg_at<M, Wrap<M, -S>::value>(d, j, lane);
      const T hi = reg_at<M, S>(d, j, lane);
      nd[j] = d[j] - f * (lo + hi);
    }
#pragma unroll
    for (int j = 0; j < M; ++j) d[j] = nd[j];
  }
}

template <int M, typename T, int... K>
__device__ __forceinline__ void reg_steps(T (&d)[M], const COp<T>& op, int lane,
                                          std::integer_sequence<int, K...>) {
  (reg_step<K, M>(d, op, lane), ...);
}

// One operator on the line in d, the plain version's operations in order.
template <int M, typename T>
__device__ __forceinline__ void reg_op(T (&d)[M], const COp<T>& op, int lane) {
  if (op.taps) {
    if (op.shift)
      reg_taps<M, 1>(d, op.a, op.b, op.s, lane);
    else
      reg_taps<M, 0>(d, op.a, op.b, op.s, lane);
  } else {
    const T a = op.a;
#pragma unroll
    for (int j = 0; j < M; ++j) d[j] = d[j] * a;
  }
  reg_steps<M>(d, op, lane, std::make_integer_sequence<int, kMaxSteps>{});
  const T c1 = op.c1;
  if (op.pair) {  // c1*d - c2*d[i + n/2]: whole registers from lane l + 16
    const T c2 = op.c2;
    T nd[M];
#pragma unroll
    for (int j = 0; j < M; ++j) nd[j] = c1 * d[j] - c2 * reg_at<M, 16 * M>(d, j, lane);
#pragma unroll
    for (int j = 0; j < M; ++j) d[j] = nd[j];
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) d[j] = d[j] * c1;
  }
}

// The elements a thread moves between global memory and a register tile
// of x or y lines (rows of kRegWarps neighbouring columns): column w =
// tid % kRegWarps, rows r0 + k*kRows for k < M, r0 = tid / kRegWarps. The
// walk advances the global offset by a constant stride and the tile index
// (line w, chunk c, offset r) by a constant with a carry, so an element
// costs no division and no 64-bit multiply. The thread index goes through
// an empty asm, so the M offsets are recomputed in each phase instead of
// being hoisted out of the program's loops and held in registers all along.
template <typename T, int M>
struct RegWalk {
  using L = RegLayout<T, M>;
  static constexpr int kRows = kRegThreads / kRegWarps;
  long long goff, gstep;
  int sidx, r;
  bool own;
  __device__ __forceinline__ explicit RegWalk(const TileMap& mp) {
    unsigned tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const int w = tid % kRegWarps, r0 = tid / kRegWarps;
    own = w < mp.nl;
    goff = mp.base + (long long)r0 * mp.line_stride + w;
    gstep = (long long)kRows * mp.line_stride;
    r = r0 % M;
    sidx = w * L::kLine + (r0 / M) * L::kCS + r;
  }
  __device__ __forceinline__ void advance() {
    goff += gstep;
    sidx += (kRows / M) * L::kCS + kRows % M;
    if constexpr (kRows % M != 0) {
      r += kRows % M;
      if (r >= M) {
        r -= M;
        sidx += L::kCS - M;
      }
    }
  }
};

// Global -> input tile (x and y lines): M loads a thread, all in flight
// before their shared-memory stores; columns past the edge are skipped.
template <typename T, int M>
__device__ __forceinline__ void reg_load(T* s, const T* __restrict__ g, const TileMap& mp) {
  RegWalk<T, M> wk(mp);
  T v[M];
  int at[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (wk.own) v[k] = g[wk.goff];
    at[k] = wk.sidx;
    wk.advance();
  }
#pragma unroll
  for (int k = 0; k < M; ++k)
    if (wk.own) s[at[k]] = v[k];
}

// Output tile -> global (x and y lines), the owned columns only.
template <typename T, int M>
__device__ __forceinline__ void reg_store(T* __restrict__ g, const T* s, const TileMap& mp) {
  RegWalk<T, M> wk(mp);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (wk.own) g[wk.goff] = s[wk.sidx];
    wk.advance();
  }
}

// A z line is contiguous, and lane l's chunk is the M values at l*M: it is
// loaded and stored straight from registers, in vectors of V values (16
// bytes where M allows) when every field is aligned to them.
template <typename T, int V>
struct VecOf;
template <>
struct VecOf<float, 4> {
  using type = float4;
};
template <>
struct VecOf<float, 2> {
  using type = float2;
};
template <>
struct VecOf<double, 2> {
  using type = double2;
};

template <typename T, int M>
struct ChunkVec {
  static constexpr int value =
      sizeof(T) == 4 ? (M % 4 == 0 ? 4 : (M % 2 == 0 ? 2 : 1)) : (M % 2 == 0 ? 2 : 1);
};

template <typename T, int M, int V>
__device__ __forceinline__ void ld_chunk(T (&d)[M], const T* __restrict__ g) {
  if constexpr (V == 1) {
#pragma unroll
    for (int j = 0; j < M; ++j) d[j] = g[j];
  } else {
    using Vt = typename VecOf<T, V>::type;
    const Vt* p = reinterpret_cast<const Vt*>(g);
#pragma unroll
    for (int q = 0; q < M / V; ++q) {
      const Vt x = p[q];
      d[q * V] = x.x;
      d[q * V + 1] = x.y;
      if constexpr (V == 4) {
        d[q * V + 2] = x.z;
        d[q * V + 3] = x.w;
      }
    }
  }
}

template <typename T, int M, int V>
__device__ __forceinline__ void st_chunk(T* __restrict__ g, const T (&d)[M]) {
  if constexpr (V == 1) {
#pragma unroll
    for (int j = 0; j < M; ++j) g[j] = d[j];
  } else {
    using Vt = typename VecOf<T, V>::type;
    Vt* p = reinterpret_cast<Vt*>(g);
#pragma unroll
    for (int q = 0; q < M / V; ++q) {
      Vt x;
      x.x = d[q * V];
      x.y = d[q * V + 1];
      if constexpr (V == 4) {
        x.z = d[q * V + 2];
        x.w = d[q * V + 3];
      }
      p[q] = x;
    }
  }
}

// Threads of the register kernel an SM should hold: the register budget
// of a thread is 65536 over this.
template <typename T, int M>
constexpr int reg_threads_per_sm() {
  if (sizeof(T) == 4) return M <= 8 ? 1024 : (M <= 16 ? 768 : 512);
  return M <= 4 ? 1024 : (M <= 8 ? 768 : (M <= 16 ? 512 : 256));
}

template <typename T, int M>
constexpr int reg_min_blocks() {
  return reg_threads_per_sm<T, M>() / kRegThreads > 1 ? reg_threads_per_sm<T, M>() / kRegThreads
                                                      : 1;
}

// The program on the warp's line, whose values `fetch(input, d)` brings in
// and `put(o, acc)` takes out. Every warp runs it, the warps whose line lies
// past the edge too (on values they never store): a shuffle under a branch
// that depends on the thread would make the compiler guard every shuffle
// for divergence.
template <typename T, int M, typename Fetch, typename Put>
__device__ __forceinline__ void reg_program(const CProgram<T>& prog, int lane, Fetch fetch,
                                            Put put) {
  for (int o = 0; o < prog.nout; ++o) {
    const COut<T>& out = prog.out[o];
    T acc[M];
    for (int t = 0; t < out.nterms; ++t) {
      const CTerm<T>& term = out.term[t];
      T d[M];
      fetch(term.input, d);
      for (int k = 0; k < term.nops; ++k) reg_op<M>(d, term.op[k], lane);
#pragma unroll
      for (int j = 0; j < M; ++j) acc[j] = t == 0 ? d[j] : acc[j] + d[j];
    }
    put(o, acc);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kRegThreads, (reg_min_blocks<T, M>()))
compact_reg_kernel(const CProgram<T> prog, const T* __restrict__ in0, const T* __restrict__ in1,
                   const T* __restrict__ in2, T* __restrict__ out0, T* __restrict__ out1,
                   T* __restrict__ out2, long long P, long long Q) {
  using L = RegLayout<T, M>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // by select, not by an indexed array (which would live in local memory)
  auto ins = [&](int k) { return k == 0 ? in0 : (k == 1 ? in1 : in2); };
  auto outs = [&](int k) { return k == 0 ? out0 : (k == 1 ? out1 : out2); };
  if (Q == 1) {
    // z lines: straight between registers and global memory, no barrier
    constexpr int V = ChunkVec<T, M>::value;
    const long long line = (long long)blockIdx.x * kRegWarps + warp;
    const bool live = line < P;
    const size_t off = (size_t)(live ? line : 0) * (32 * M) + lane * M;
    const size_t align = V * sizeof(T);
    const bool vec = ((reinterpret_cast<size_t>(in0) | reinterpret_cast<size_t>(in1) |
                       reinterpret_cast<size_t>(in2) | reinterpret_cast<size_t>(out0) |
                       reinterpret_cast<size_t>(out1) | reinterpret_cast<size_t>(out2)) %
                      align) == 0;
    reg_program<T, M>(
        prog, lane,
        [&](int input, T(&d)[M]) {
          if (vec)
            ld_chunk<T, M, V>(d, ins(input) + off);
          else
            ld_chunk<T, M, 1>(d, ins(input) + off);
        },
        [&](int o, const T(&acc)[M]) {
          if (!live) return;
          if (vec)
            st_chunk<T, M, V>(outs(o) + off, acc);
          else
            st_chunk<T, M, 1>(outs(o) + off, acc);
        });
    return;
  }
  // x and y lines: through the tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const tin = reinterpret_cast<T*>(smem_raw);
  T* const tout = tin + L::kTile;
  const TileMap mp = tile_map<kRegWarps>(P, 32 * M, Q);
  const T* col_in = tin + warp * L::kLine + lane * L::kCS;
  T* col_out = tout + warp * L::kLine + lane * L::kCS;
  int held = -1;  // the input in the input tile
  reg_program<T, M>(
      prog, lane,
      [&](int input, T(&d)[M]) {
        if (input != held) {
          __syncthreads();  // every warp has read its column of the last input
          reg_load<T, M>(tin, ins(input), mp);
          held = input;
          __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < M; ++j) d[j] = col_in[j];
      },
      [&](int o, const T(&acc)[M]) {
        if (o > 0) __syncthreads();  // the last output's store has read the tile
#pragma unroll
        for (int j = 0; j < M; ++j) col_out[j] = acc[j];
        __syncthreads();
        reg_store<T, M>(outs(o), tout, mp);
      });
}

// Program layout (doubles): nin, nout, then per output: nterms, then per
// term: input, nops, then per operator: taps, a, b, opsign, shift,
// nsteps, f[0..nsteps), pair, c1, c2.
template <typename T>
bool parse_program(const double* code, int len, CProgram<T>* prog) {
  int pos = 0;
  auto next = [&](double* v) {
    if (pos >= len) return false;
    *v = code[pos++];
    return true;
  };
  double v;
  if (!next(&v)) return false;
  prog->nin = (int)v;
  if (!next(&v)) return false;
  prog->nout = (int)v;
  if (prog->nin < 1 || prog->nin > kMaxIn || prog->nout < 1 || prog->nout > kMaxOut)
    return false;
  for (int o = 0; o < prog->nout; ++o) {
    COut<T>& out = prog->out[o];
    if (!next(&v)) return false;
    out.nterms = (int)v;
    if (out.nterms < 1 || out.nterms > 2) return false;
    for (int t = 0; t < out.nterms; ++t) {
      CTerm<T>& term = out.term[t];
      if (!next(&v)) return false;
      term.input = (int)v;
      if (!next(&v)) return false;
      term.nops = (int)v;
      if (term.input < 0 || term.input >= prog->nin || term.nops < 1 || term.nops > 2)
        return false;
      for (int k = 0; k < term.nops; ++k) {
        COp<T>& op = term.op[k];
        double taps, a, b, s, shift, nsteps, pair, c1, c2;
        if (!(next(&taps) && next(&a) && next(&b) && next(&s) && next(&shift) &&
              next(&nsteps)))
          return false;
        op.taps = (int)taps;
        op.a = T(a);
        op.b = T(b);
        op.s = T(s);
        op.shift = (int)shift;
        op.nsteps = (int)nsteps;
        if (op.nsteps < 0 || op.nsteps > kMaxSteps) return false;
        for (int j = 0; j < op.nsteps; ++j) {
          double f;
          if (!next(&f)) return false;
          op.f[j] = T(f);
        }
        if (!(next(&pair) && next(&c1) && next(&c2))) return false;
        op.pair = (int)pair;
        op.c1 = T(c1);
        op.c2 = T(c2);
      }
    }
  }
  return pos == len;
}

template <typename T, int W>
cudaError_t launch_compact(const CProgram<T>& prog, cudaStream_t stream, const void* const* in,
                           void* const* out, long long P, int n, long long Q, int nbuf) {
  const size_t bytes = (size_t)nbuf * n * (W + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(compact_kernel<T, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = Q > 1 ? P * ((Q + W - 1) / W) : (P + W - 1) / W;
  compact_kernel<T, W><<<(unsigned)blocks, kCompactThreads, bytes, stream>>>(
      prog, static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<T*>(out[0]), static_cast<T*>(out[1]),
      static_cast<T*>(out[2]), P, n, Q);
  return cudaGetLastError();
}

template <typename T, int M>
cudaError_t launch_compact_reg(const CProgram<T>& prog, cudaStream_t stream,
                               const void* const* in, void* const* out, long long P,
                               long long Q) {
  // the input and output tiles of x and y lines; z lines take none
  const size_t tiles = 2 * (size_t)RegLayout<T, M>::kTile * sizeof(T);
  const size_t bytes = Q > 1 ? tiles : 0;
  cudaError_t err = cudaFuncSetAttribute(compact_reg_kernel<T, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tiles);
  if (err != cudaSuccess) return err;
  const long long blocks =
      Q > 1 ? P * ((Q + kRegWarps - 1) / kRegWarps) : (P + kRegWarps - 1) / kRegWarps;
  compact_reg_kernel<T, M><<<(unsigned)blocks, kRegThreads, bytes, stream>>>(
      prog, static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<T*>(out[0]), static_cast<T*>(out[1]),
      static_cast<T*>(out[2]), P, Q);
  return cudaGetLastError();
}

// The register kernel's line lengths n = 32*m (compact_pcr.REG_M).
template <typename T>
cudaError_t run_compact_reg(const CProgram<T>& prog, cudaStream_t stream, const void* const* in,
                            void* const* out, long long P, int n, long long Q) {
  switch (n) {
    case 64:
      return launch_compact_reg<T, 2>(prog, stream, in, out, P, Q);
    case 96:
      return launch_compact_reg<T, 3>(prog, stream, in, out, P, Q);
    case 128:
      return launch_compact_reg<T, 4>(prog, stream, in, out, P, Q);
    case 256:
      return launch_compact_reg<T, 8>(prog, stream, in, out, P, Q);
    case 384:
      return launch_compact_reg<T, 12>(prog, stream, in, out, P, Q);
    case 512:
      return launch_compact_reg<T, 16>(prog, stream, in, out, P, Q);
    case 640:
      return launch_compact_reg<T, 20>(prog, stream, in, out, P, Q);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_compact(const double* code, int len, cudaStream_t stream, const void* const* in,
                        void* const* out, long long P, int n, long long Q, int W, int nbuf) {
  CProgram<T> prog;
  if (!parse_program<T>(code, len, &prog)) return cudaErrorInvalidValue;
  switch (W) {
    case 0:
      return run_compact_reg<T>(prog, stream, in, out, P, n, Q);
    case 32:
      return launch_compact<T, 32>(prog, stream, in, out, P, n, Q, nbuf);
    case 16:
      return launch_compact<T, 16>(prog, stream, in, out, P, n, Q, nbuf);
    case 8:
      return launch_compact<T, 8>(prog, stream, in, out, P, n, Q, nbuf);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace poissbox

extern "C" {

// dtype: 0 = float32, 1 = float64. The field is viewed as (P, n, Q), the
// lines along n; in*/out* are (P, n, Q) contiguous fields (unused ones
// null). W = 0: the register kernel (n one of its line lengths; nbuf
// unused); W = 32, 16 or 8: the tile kernel with W lanes per block and
// nbuf tile buffers of n*(W+1) values in shared memory. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// length the register kernel is not built for).
int poissbox_compact(int dtype, int device, void* stream, const double* code, int code_len,
                     const void* in0, const void* in1, const void* in2, void* out0, void* out1,
                     void* out2, long long P, int n, long long Q, int W, int nbuf) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[3] = {in0, in1, in2};
  void* out[3] = {out0, out1, out2};
  if (dtype == poissbox::kF32)
    err = poissbox::run_compact<float>(code, code_len, s, in, out, P, n, Q, W, nbuf);
  else if (dtype == poissbox::kF64)
    err = poissbox::run_compact<double>(code, code_len, s, in, out, P, n, Q, W, nbuf);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
