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
// stretch of W*n values. The tile sits in shared memory as [i][w] with a
// pitch of W+1 (no bank conflicts in either load order); the W lanes are
// independent lines, so a step over the tile is n*W independent updates,
// spread over the block's threads, ping-ponging between buffers with a
// __syncthreads() between steps. Three buffers hold a two-term output
// (the first term's result waits in one while the second runs in the
// other two), two otherwise. W is 32, 16 or 8: the widest whose buffers
// let two blocks share an SM (one block's loads then overlap the other's
// steps), else the widest that fits the 227 KB one block may use (the
// wrapper picks it): at n = 512 a three-buffer f32 tile of W = 16 takes
// 102 KB.
//
// Rounding: each operation is one IEEE operation in the order of the
// plain version (compact_pcr._vrhs/_vpcr with torch.roll), and the
// library is built with --fmad=false, so kernel and plain agree.
//
// Bound on an H100 SXM (3.35 TB/s): the HBM floor is one read of each
// input and one write of each output, 10 field passes for the Laplacian
// (1.60 ms at 512^3 f32; the TPU's regrouped two-kernel form moves 6).
// The arithmetic is a few flops per point per PCR step, far below the
// compute roof, but every pass over the tile (the taps, then one per PCR
// step, the final scale folded into the last) reads three or four and
// writes one shared-memory value per point, with a __syncthreads()
// between passes: this first design is bound by shared-memory traffic
// and instruction issue, not by HBM. What it leaves on the table:
// registers for the line (fewer shared passes), fusing the z and y sweeps
// (thread-block clusters or split planes) to reach 6 HBM passes, and TMA
// loads.
#include "common.cuh"

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

template <typename T>
cudaError_t run_compact(const double* code, int len, cudaStream_t stream, const void* const* in,
                        void* const* out, long long P, int n, long long Q, int W, int nbuf) {
  CProgram<T> prog;
  if (!parse_program<T>(code, len, &prog)) return cudaErrorInvalidValue;
  switch (W) {
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
// null); W lanes per block, nbuf tile buffers of n*(W+1) values in shared
// memory. Returns the cudaError_t of the launch (0 on success).
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
