// Batched tridiagonal solves along axis 0, one thread per line:
//   K13 `thomas`: the Thomas solve with the periodic (Sherman-Morrison)
//       correction fused in;
//   K16 `babe`: the twisted (burn-at-both-ends) factorization solve;
//   K17 `compact_thomas`: the staggered compact RHS formed inside K13's
//       forward sweep, in four modes (compact, dual, chain, sum).
//
// Replaces, in poissbox_tpu/ops/tridiag_pallas.py: _solve_blocks (:293;
// _thomas_kernel :69 with _bwd_and_corr :38, launched by _launch_tridiag
// :270); _solve_babe_blocks (:330; _babe_kernel :83); _solve_compact_blocks
// (:381; _compact_thomas_kernel :151), _dual_blocks (:459;
// _compact_thomas2_kernel :192), _chain_blocks (:467;
// _compact_chain_kernel :216) and _sum_blocks (:475; _compact_sum_kernel
// :245), launched by _launch_fused :422. The circulant PCR solve (K14,
// _solve_pcr_blocks :303) runs on K15's line kernel in csrc/compact.cu,
// with the RHS taps replaced by a scale.
//
// Layout: every field is (n, Q), n rows, Q independent lines (the batch).
// One thread owns one line; consecutive threads own consecutive columns,
// so every row access of a warp is one coalesced load or store. The
// factor vectors are precomputed once per coefficient set and read as
// device arrays: every thread of a warp reads the same row's value, a
// broadcast from L1. Each operation is one IEEE operation in the order of
// the Pallas kernels (and of the plain versions in ops/tridiag_cuda.py);
// the library is built with --fmad=false, so kernel and plain agree bit
// for bit.
//
// K13: forward sweep dmod_i = d_i - w_i*dmod_{i-1}, back substitution
// x_i = dmod_i*binv_i - cb_i*x_{i+1} and, when corr[1] != 0, the rank-1
// correction x_i -= usol_i*((x_0 + ar*x_{n-1})*(1/denom)).
//
// K16: the sub-diagonal is eliminated downward on rows 1..m and the
// super-diagonal upward on rows n-2..m+1 (m = (n-2)/2), the middle row m
// couples both, x_m = (dd_m - vm*du_{m+1})*(1/bmid), and the back
// substitution runs outward from m in both directions. Each step of the
// thread's loops advances both recurrences (independent rows), so the
// chain of dependent steps is about n instead of Thomas's 2n; an odd
// split takes one or two extra one-sided steps. The correction is K13's.
//
// K17: the RHS row i of a compact operator (a, b, s = opsign, sh = shift)
// is a*(f[i+sh] + s*f[i+sh-1]) + b*(f[i+sh+1] + s*f[i+sh-2]), indices mod
// n. A window of the four taps rolls down the line with the forward sweep,
// so each input row is loaded once. Modes:
//   compact: one operator, f -> out0;
//   dual:    two operators of one input, f -> (out0, out1), both forward
//            sweeps in one loop;
//   chain:   op2(op1(f)) along the line, op1's whole solve (correction
//            included) in the scratch field `mid` before op2's taps wrap;
//   sum:     op1(fa + fb) + op2(f3), the tap of op1 formed as fa[j] + fb[j]
//            per row, op1 solved in `mid`, op2 in out0, then out0 += mid.
// The wrapper allocates `mid`; the kernel allocates nothing.
//
// Bound on an H100 SXM (3.35 TB/s): the floor is one read of each input
// and one write of each output (2 field passes for K13, K16, K17 compact
// and chain, 3 for dual, 4 for sum: 0.32 / 0.48 / 0.64 ms at 512^3 f32).
// These designs write the forward sweep to the output, read it back in
// the back substitution and read and write it once more in the
// correction, so each solved line costs 3 reads and 3 writes of HBM at
// 512^3 (beyond what the L2 holds); chain and sum pay that for `mid` too.
// Each thread's rows depend on each other (first-order recurrences), so
// at small batch (Q below a few thousand lines per SM) the latency of the
// dependent steps, not HBM, sets the time. Keeping a stretch of each line
// in registers or shared memory would cut the passes toward the floor.
#include "common.cuh"

namespace poissbox {

constexpr int kThomasThreads = 256;

__device__ __forceinline__ long long line_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// The periodic rank-1 correction, when corr[1] != 0: x0 and xn are the
// uncorrected x_0 and x_{n-1}.
template <typename T>
__device__ __forceinline__ void correct(const T* __restrict__ corr, T x0, T xn, T* x, int n,
                                        long long Q, long long q) {
  if (corr[1] != T(0)) {
    const T factor = (x0 + corr[0] * xn) * corr[1];
    for (int i = 0; i < n; ++i) x[i * Q + q] = x[i * Q + q] - corr[2 + i] * factor;
  }
}

// Back substitution and correction on x, which holds the forward sweep;
// `last` is its row n-1.
template <typename T>
__device__ __forceinline__ void bwd_and_corr(const T* __restrict__ binv, const T* __restrict__ cb,
                                             const T* __restrict__ corr, T last, T* x, int n,
                                             long long Q, long long q) {
  const T xn = last * binv[n - 1];
  x[(n - 1) * Q + q] = xn;
  T prev = xn;
#pragma unroll 4
  for (int i = n - 2; i >= 0; --i) {
    const T v = x[i * Q + q] * binv[i] - cb[i] * prev;
    x[i * Q + q] = v;
    prev = v;
  }
  correct(corr, prev, xn, x, n, Q, q);
}

template <typename T>
__global__ void __launch_bounds__(kThomasThreads)
thomas_kernel(const T* __restrict__ d, T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ binv, const T* __restrict__ cb,
              const T* __restrict__ corr, int n, long long Q) {
  const long long q = line_index();
  if (q >= Q) return;
  T prev = d[q];
  x[q] = prev;
#pragma unroll 4
  for (int i = 1; i < n; ++i) {
    const T v = d[i * Q + q] - w[i] * prev;
    x[i * Q + q] = v;
    prev = v;
  }
  bwd_and_corr(binv, cb, corr, prev, x, n, Q, q);
}

// K16. wv: w_i for i <= m, v_i for i > m; binv: 1/bd_i (i < m), 1/bmid
// (m), 1/bu_i (i > m); ca: c_i (i < m), a_i (i > m); corr as K13's with
// vm at corr[n + 2].
template <typename T>
__global__ void __launch_bounds__(kThomasThreads)
babe_kernel(const T* __restrict__ d, T* __restrict__ x, const T* __restrict__ wv,
            const T* __restrict__ binv, const T* __restrict__ ca,
            const T* __restrict__ corr, int n, int m, long long Q) {
  const long long q = line_index();
  if (q >= Q) return;
  T lo = d[q];                    // the downward chain, from row 0
  T hi = d[(n - 1) * Q + q];      // the upward chain, from row n-1
  x[q] = lo;
  x[(n - 1) * Q + q] = hi;
  const int kd = m, ku = n - 2 - m;
  const int ke = kd > ku ? kd : ku;
  for (int k = 0; k < ke; ++k) {
    if (k < kd) {
      const int i = 1 + k;
      const T v = d[i * Q + q] - wv[i] * lo;
      x[i * Q + q] = v;
      lo = v;
    }
    if (k < ku) {
      const int j = n - 2 - k;
      const T v = d[j * Q + q] - wv[j] * hi;
      x[j * Q + q] = v;
      hi = v;
    }
  }
  // lo is row m of the downward sweep, hi row m+1 of the upward one
  const T xm = (lo - corr[n + 2] * hi) * binv[m];
  x[m * Q + q] = xm;
  lo = xm;
  hi = xm;
  const int bd = m, bu = n - 1 - m;
  const int be = bd > bu ? bd : bu;
  for (int k = 0; k < be; ++k) {
    if (k < bd) {
      const int i = m - 1 - k;
      const T v = (x[i * Q + q] - ca[i] * lo) * binv[i];
      x[i * Q + q] = v;
      lo = v;
    }
    if (k < bu) {
      const int j = m + 1 + k;
      const T v = (x[j * Q + q] - ca[j] * hi) * binv[j];
      x[j * Q + q] = v;
      hi = v;
    }
  }
  correct(corr, lo, hi, x, n, Q, q);   // lo = x_0, hi = x_{n-1}
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

enum CompactMode { kCompact = 0, kDual = 1, kChain = 2, kSum = 3 };

// One compact operator on a line: its RHS taps and its Thomas factors.
template <typename T>
struct LineOp {
  T a, b, s;
  int shift;
  const T* w;
  const T* binv;
  const T* cb;
  const T* corr;
};

// Row j of a line of one field, or of the sum of two (the sum mode's
// fa[j] + fb[j]). Not __restrict__: `mid` is read after this thread wrote
// it, so its loads must not go through the read-only path.
template <typename T>
struct Row {
  const T* f;
  long long Q, q;
  __device__ __forceinline__ T operator()(int j) const { return f[j * Q + q]; }
};

template <typename T>
struct RowSum {
  const T* fa;
  const T* fb;
  long long Q, q;
  __device__ __forceinline__ T operator()(int j) const { return fa[j * Q + q] + fb[j * Q + q]; }
};

// The taps f[i+sh-2], f[i+sh-1], f[i+sh], f[i+sh+1] (mod n) of row i.
template <typename T>
struct Window {
  T t0, t1, t2, t3;
  int next;

  template <typename Src>
  __device__ __forceinline__ void init(const Src& src, int shift, int n) {
    auto mod = [n](int j) { return ((j % n) + n) % n; };
    t0 = src(mod(shift - 2));
    t1 = src(mod(shift - 1));
    t2 = src(mod(shift));
    t3 = src(mod(shift + 1));
    next = mod(shift + 2);
  }

  template <typename Src>
  __device__ __forceinline__ void advance(const Src& src, int n) {
    t0 = t1;
    t1 = t2;
    t2 = t3;
    t3 = src(next);
    next = next + 1 == n ? 0 : next + 1;
  }

  __device__ __forceinline__ T rhs(const LineOp<T>& op) const {
    const T u1 = t2 + op.s * t1;
    const T u2 = t3 + op.s * t0;
    return op.a * u1 + op.b * u2;
  }
};

// Forward sweep of one operator into x; returns row n-1.
template <typename T, typename Src>
__device__ __forceinline__ T forward(const LineOp<T>& op, const Src& src, T* x, int n,
                                     long long Q, long long q) {
  Window<T> win;
  win.init(src, op.shift, n);
  T prev = win.rhs(op);
  x[q] = prev;
  for (int i = 1; i < n; ++i) {
    win.advance(src, n);
    const T v = win.rhs(op) - op.w[i] * prev;
    x[i * Q + q] = v;
    prev = v;
  }
  return prev;
}

// Two forward sweeps advanced in one loop (independent recurrences).
template <typename T, typename S1, typename S2>
__device__ __forceinline__ void forward2(const LineOp<T>& o1, const S1& s1, T* x1,
                                         const LineOp<T>& o2, const S2& s2, T* x2, int n,
                                         long long Q, long long q, T* last1, T* last2) {
  Window<T> w1, w2;
  w1.init(s1, o1.shift, n);
  w2.init(s2, o2.shift, n);
  T p1 = w1.rhs(o1), p2 = w2.rhs(o2);
  x1[q] = p1;
  x2[q] = p2;
  for (int i = 1; i < n; ++i) {
    w1.advance(s1, n);
    w2.advance(s2, n);
    const T v1 = w1.rhs(o1) - o1.w[i] * p1;
    const T v2 = w2.rhs(o2) - o2.w[i] * p2;
    x1[i * Q + q] = v1;
    x2[i * Q + q] = v2;
    p1 = v1;
    p2 = v2;
  }
  *last1 = p1;
  *last2 = p2;
}

template <typename T>
__device__ __forceinline__ void solve_op(const LineOp<T>& op, T last, T* x, int n, long long Q,
                                         long long q) {
  bwd_and_corr(op.binv, op.cb, op.corr, last, x, n, Q, q);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThomasThreads)
compact_thomas_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                      const T* __restrict__ f2, T* __restrict__ out0, T* __restrict__ out1,
                      T* mid, const LineOp<T> op1, const LineOp<T> op2, int n, long long Q) {
  const long long q = line_index();
  if (q >= Q) return;
  if (MODE == kCompact) {
    const T last = forward(op1, Row<T>{f0, Q, q}, out0, n, Q, q);
    solve_op(op1, last, out0, n, Q, q);
  } else if (MODE == kDual) {
    T l1, l2;
    forward2(op1, Row<T>{f0, Q, q}, out0, op2, Row<T>{f0, Q, q}, out1, n, Q, q, &l1, &l2);
    solve_op(op1, l1, out0, n, Q, q);
    solve_op(op2, l2, out1, n, Q, q);
  } else if (MODE == kChain) {
    const T l1 = forward(op1, Row<T>{f0, Q, q}, mid, n, Q, q);
    solve_op(op1, l1, mid, n, Q, q);
    const T l2 = forward(op2, Row<T>{mid, Q, q}, out0, n, Q, q);
    solve_op(op2, l2, out0, n, Q, q);
  } else {
    T l1, l2;
    forward2(op1, RowSum<T>{f0, f1, Q, q}, mid, op2, Row<T>{f2, Q, q}, out0, n, Q, q, &l1,
             &l2);
    solve_op(op1, l1, mid, n, Q, q);
    solve_op(op2, l2, out0, n, Q, q);
    for (int i = 0; i < n; ++i) out0[i * Q + q] = out0[i * Q + q] + mid[i * Q + q];
  }
}

inline unsigned line_blocks(long long Q) {
  return (unsigned)((Q + kThomasThreads - 1) / kThomasThreads);
}

template <typename T>
cudaError_t launch_thomas(cudaStream_t stream, const void* d, void* x, const void* w,
                          const void* binv, const void* cb, const void* corr, int n,
                          long long Q) {
  thomas_kernel<T><<<line_blocks(Q), kThomasThreads, 0, stream>>>(
      static_cast<const T*>(d), static_cast<T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(binv), static_cast<const T*>(cb), static_cast<const T*>(corr), n,
      Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_babe(cudaStream_t stream, const void* d, void* x, const void* wv,
                        const void* binv, const void* ca, const void* corr, int n, int m,
                        long long Q) {
  babe_kernel<T><<<line_blocks(Q), kThomasThreads, 0, stream>>>(
      static_cast<const T*>(d), static_cast<T*>(x), static_cast<const T*>(wv),
      static_cast<const T*>(binv), static_cast<const T*>(ca), static_cast<const T*>(corr), n,
      m, Q);
  return cudaGetLastError();
}

template <typename T>
LineOp<T> line_op(const void* const* fac, double a, double b, int opsign, int shift) {
  LineOp<T> op;
  op.a = T(a);
  op.b = T(b);
  op.s = T(opsign);
  op.shift = shift;
  op.w = static_cast<const T*>(fac[0]);
  op.binv = static_cast<const T*>(fac[1]);
  op.cb = static_cast<const T*>(fac[2]);
  op.corr = static_cast<const T*>(fac[3]);
  return op;
}

template <typename T>
cudaError_t launch_compact_thomas(cudaStream_t stream, int mode, const void* const* in,
                                  void* const* out, void* mid, const void* const* fac1,
                                  const void* const* fac2, const double* spec, const int* ispec,
                                  int n, long long Q) {
  const LineOp<T> op1 = line_op<T>(fac1, spec[0], spec[1], ispec[0], ispec[1]);
  // compact mode has no second operator: op2 is never read
  const LineOp<T> op2 =
      mode == kCompact ? op1 : line_op<T>(fac2, spec[2], spec[3], ispec[2], ispec[3]);
  const T* f0 = static_cast<const T*>(in[0]);
  const T* f1 = static_cast<const T*>(in[1]);
  const T* f2 = static_cast<const T*>(in[2]);
  T* o0 = static_cast<T*>(out[0]);
  T* o1 = static_cast<T*>(out[1]);
  T* m = static_cast<T*>(mid);
  const unsigned blocks = line_blocks(Q);
  switch (mode) {
    case kCompact:
      compact_thomas_kernel<T, kCompact>
          <<<blocks, kThomasThreads, 0, stream>>>(f0, f1, f2, o0, o1, m, op1, op2, n, Q);
      break;
    case kDual:
      compact_thomas_kernel<T, kDual>
          <<<blocks, kThomasThreads, 0, stream>>>(f0, f1, f2, o0, o1, m, op1, op2, n, Q);
      break;
    case kChain:
      compact_thomas_kernel<T, kChain>
          <<<blocks, kThomasThreads, 0, stream>>>(f0, f1, f2, o0, o1, m, op1, op2, n, Q);
      break;
    case kSum:
      compact_thomas_kernel<T, kSum>
          <<<blocks, kThomasThreads, 0, stream>>>(f0, f1, f2, o0, o1, m, op1, op2, n, Q);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace poissbox

extern "C" {

// dtype: 0 = float32, 1 = float64. d and x are (n, Q) contiguous; w, binv
// and cb hold n values, corr n + 2 (corr[1] = 0: no periodic
// correction). Returns the cudaError_t of the launch (0 on success).
int poissbox_thomas(int dtype, int device, void* stream, const void* d, void* x, const void* w,
                    const void* binv, const void* cb, const void* corr, int n, long long Q) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == poissbox::kF32)
    err = poissbox::launch_thomas<float>(s, d, x, w, binv, cb, corr, n, Q);
  else if (dtype == poissbox::kF64)
    err = poissbox::launch_thomas<double>(s, d, x, w, binv, cb, corr, n, Q);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// K16: as poissbox_thomas, with the twisted factorization's wv, binv and
// ca (n values each), corr (n + 3, vm at corr[n + 2]) and the middle row
// m = (n - 2) / 2; n >= 2.
int poissbox_babe(int dtype, int device, void* stream, const void* d, void* x, const void* wv,
                  const void* binv, const void* ca, const void* corr, int n, int m,
                  long long Q) {
  if (n < 2 || m != (n - 2) / 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == poissbox::kF32)
    err = poissbox::launch_babe<float>(s, d, x, wv, binv, ca, corr, n, m, Q);
  else if (dtype == poissbox::kF64)
    err = poissbox::launch_babe<double>(s, d, x, wv, binv, ca, corr, n, m, Q);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// K17: mode 0 compact (in0 -> out0), 1 dual (in0 -> out0, out1), 2 chain
// (in0 -> out0 through mid), 3 sum (in0 + in1 and in2 -> out0, op1 solved
// in mid). Every field is (n, Q) contiguous, unused ones null. Operator k
// (k = 1, 2) has the Thomas factors wk, binvk, cbk, corrk (as
// poissbox_thomas's) and the RHS (ak, bk, opsignk, shiftk).
int poissbox_compact_thomas(int dtype, int mode, int device, void* stream, const void* in0,
                            const void* in1, const void* in2, void* out0, void* out1, void* mid,
                            const void* w1, const void* binv1, const void* cb1,
                            const void* corr1, const void* w2, const void* binv2,
                            const void* cb2, const void* corr2, double a1, double b1,
                            int opsign1, int shift1, double a2, double b2, int opsign2,
                            int shift2, int n, long long Q) {
  if (mode < 0 || mode > 3 || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[3] = {in0, in1, in2};
  void* out[2] = {out0, out1};
  const void* fac1[4] = {w1, binv1, cb1, corr1};
  const void* fac2[4] = {w2, binv2, cb2, corr2};
  const double spec[4] = {a1, b1, a2, b2};
  const int ispec[4] = {opsign1, shift1, opsign2, shift2};
  if (dtype == poissbox::kF32)
    err = poissbox::launch_compact_thomas<float>(s, mode, in, out, mid, fac1, fac2, spec, ispec,
                                                 n, Q);
  else if (dtype == poissbox::kF64)
    err = poissbox::launch_compact_thomas<double>(s, mode, in, out, mid, fac1, fac2, spec,
                                                  ispec, n, Q);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
