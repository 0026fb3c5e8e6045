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
// so each input row is read once. Modes:
//   compact: one operator, f -> out0;
//   dual:    two operators of one input, f -> (out0, out1);
//   chain:   op2(op1(f)) along the line, op1's whole solve (correction
//            included) before op2's taps wrap;
//   sum:     op1(fa + fb) + op2(f3), the tap of op1 formed as fa[j] + fb[j]
//            per row.
//
// Bound on an H100 SXM (3.35 TB/s): the floor is one read of each input
// and one write of each output (2 field passes for K13, K16, K17 compact
// and chain, 3 for dual, 4 for sum: 0.32 / 0.48 / 0.64 ms at 512^3 f32).
// Each line is a chain of dependent steps, one thread a line: at 512^3 the
// shared memory holds about 100 lines an SM, so the chain's latency, not
// HBM, sets the time (PERF.md: compact and K16 near half their floor,
// the two-operator modes lower).
//
// K13, K16 and K17 run on STRIP kernels. A worker (one warp, its first 32 or 16
// lanes) owns a strip of whole lines in dynamic shared memory, row r of
// lane t at r * pitch + t: a row of the strip is one coalesced
// transaction, and a warp's accesses hit consecutive banks. Each lane
// loads its own column by cp.async, kChunk rows a group, every group
// issued up front (kDepth), so the forward sweep starts once the first two
// chunks land; no lane reads another's column, so no barrier is needed.
// The sweep writes dmod_i over row i in place once the tap window holds
// every tap that reads it; the taps past the line's end (rows 0 and 1) are
// held in registers from the start. The back substitution and, for chain,
// op1's correction run on the strip; the last correction is fused into the
// one coalesced store. HBM sees each input once and each output once. A
// thread reads kU rows into registers before it writes any (the compiler
// keeps a thread's strip reads behind its earlier strip writes), and the
// operators' factors sit in shared-memory tables that the block loads once.
// Blocks are persistent, one an SM, each with as many workers as the
// shared memory holds (at most kMaxWorkers); with few workers and many
// strips each, the workers start one after another (stagger), so one's
// loads and stores meet the others' arithmetic. One lane owns one line in
// every mode: chain's op2 reads op1's solution from the strip (no scratch
// field); dual loads f again for op2; sum loads fb into a second column
// of the strip beside fa, and op2 runs there on f3 while op1's solution
// waits in the first.
// strip_lanes picks 32 lanes when a block holds three 32-lane workers and
// the lines make two strips an SM, else 16 when it holds two 16-lane
// workers. Lines too long for that (on an H100 over 1613 rows in f32 and
// 806 in f64 for K13, compact and K16, 1452 and 726 for dual and chain, 806
// and 403 for sum's two columns a lane) take the STREAMING kernels below,
// one thread a line with the forward sweep written to the output and read
// back (3 reads and 3 writes of HBM a solved line; chain and sum solve op1
// in the scratch field `mid`, which the wrapper allocates for them alone).
// K13's strip is K17 compact's worker with the RHS taps replaced by the row
// itself: the forward sweep overwrites row i with dmod_i as soon as chunk
// i / kChunk has landed (no tap reads ahead of the row), the back
// substitution runs on the strip and the correction is fused into the
// store, so HBM sees d once and x once, against 3 reads and 3 writes a
// line on the streaming kernel.
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

// K16, streaming kernel. wv: w_i for i <= m, v_i for i > m; binv: 1/bd_i (i < m), 1/bmid
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
// K17, streaming kernel
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

// ---------------------------------------------------------------------------
// Strip kernels (K16, K17)
// ---------------------------------------------------------------------------

constexpr int kChunk = 16;   // rows of one cp.async group
constexpr int kDepth = 32;   // groups issued up front (all of a 512-row line)
// Rows a thread reads into registers before it writes any of them: the
// compiler keeps a thread's strip reads behind its earlier strip writes
// (it cannot tell the rows apart), so a loop that read and wrote one row
// at a time would wait out a shared-memory round trip every row.
constexpr int kU = 8;
constexpr int kBabe = 4;     // strip_lanes' mode code for K16
constexpr int kThomas = 5;   // and for K13

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Every group of this thread but the N most recent has landed and is
// visible to it.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One lane's column of the strip: row i at p[i * pitch].
template <typename T>
struct Col {
  T* p;
  int pitch;
  __device__ __forceinline__ T& operator[](int i) const { return p[i * pitch]; }
};

// One lane's async loads: rows of the global column g0 (row stride Q)
// into c0 and, when g1 is not null, of g1 into c1 (whether it is should
// be the same for every lane of the warp: a branch that splits it would
// be taken row by row). Group c holds rows [c*kChunk, (c+1)*kChunk); past
// the line it is empty.
template <typename T>
struct Feed {
  const T* g0;
  const T* g1;
  Col<T> c0, c1;
  long long Q;
  int n;

  __device__ __forceinline__ void issue(int c) const {
    const int r1 = min(n, (c + 1) * kChunk);
    for (int r = c * kChunk; r < r1; ++r) {
      cp_async<sizeof(T)>(&c0[r], g0 + r * Q);
      if (g1 != nullptr) cp_async<sizeof(T)>(&c1[r], g1 + r * Q);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void start() const {
    for (int c = 0; c < kDepth; ++c) issue(c);
  }
};

// Where a sweep's tap window starts: row j of the global line (plus a
// second one where `add`: the sum's fa + fb), or of the strip.
template <typename T>
struct GlobalTap {
  const T* g0;
  const T* g1;
  long long Q;
  bool add;
  __device__ __forceinline__ T operator()(int j) const {
    const T v = g0[j * Q];
    if (g1 == nullptr) return v;
    const T w = g1[j * Q];
    return add ? v + w : v;
  }
};

template <typename T>
struct StripTap {
  Col<T> x;
  __device__ __forceinline__ T operator()(int j) const { return x[j]; }
};

// The RHS from the taps, with op.s known to be SIGN (+1 or -1), so s*t is
// t or -t exactly and t2 + s*t1 is one add or subtract, bit for bit the
// same.
template <int SIGN, typename T>
__device__ __forceinline__ T taps_rhs(const LineOp<T>& op, T t0, T t1, T t2, T t3) {
  if constexpr (SIGN > 0) return op.a * (t2 + t1) + op.b * (t3 + t0);
  return op.a * (t2 - t1) + op.b * (t3 - t0);
}

// Forward sweep of op on one lane's line, in place: the taps of row i are
// rows i+sh-2 .. i+sh+1 (mod n) of x (plus y where MAYBE_Y and has_y: the
// sum's fa + fb; y is read either way, so it must be a real column, and
// the sum is a select, not a branch), and dmod_i overwrites x[i] once the window
// holds its rows; row i+sh+1 > i is still the input. The window starts
// from `tap`, and the taps past the line's end (rows 0 and 1, overwritten
// by then) come from h0 and h1, read with it. FED: the rows arrive by
// `feed`, whose first kDepth groups are in flight; chunk c is swept once
// groups c and c+1 have landed (the window reads two rows past the
// chunk), then group c + kDepth is issued. Returns dmod_{n-1}.
template <typename T, bool FED, bool MAYBE_Y, int SIGN, typename Tap>
__device__ __forceinline__ T forward_strip(const LineOp<T>& op, Col<T> x, Col<T> y, bool has_y,
                                           const Tap& tap, const Feed<T>& feed, int n) {
  const int sh = op.shift;
  auto mod = [n](int j) { return ((j % n) + n) % n; };
  T t0 = tap(mod(sh - 2)), t1 = tap(mod(sh - 1)), t2 = tap(mod(sh)), t3 = tap(mod(sh + 1));
  const T h0 = tap(0), h1 = tap(mod(1));
  const int wrap = n - 1 - sh;   // rows i >= wrap take their new tap from h0, h1
  T prev = T(0);
  for (int c = 0; c * kChunk < n; ++c) {
    if (FED) cp_async_wait<kDepth - 2>();
    const int hi = min(n, (c + 1) * kChunk);
    int i = c * kChunk;
    if (i == 0) {
      prev = taps_rhs<SIGN>(op, t0, t1, t2, t3);
      x[0] = prev;
      i = 1;
    }
    const int main_end = min(hi, wrap);
    for (; i + kU <= main_end; i += kU) {
      // the new taps (rows i+sh+1 ..) and factors of kU rows, then their
      // steps; a row read here is written later in the block or after
      T tn[kU], wn[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = i + u + sh + 1;
        tn[u] = x[j];
        if constexpr (MAYBE_Y) {
          const T yv = y[j];
          tn[u] = has_y ? tn[u] + yv : tn[u];
        }
        wn[u] = op.w[i + u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        t0 = t1;
        t1 = t2;
        t2 = t3;
        t3 = tn[u];
        const T v = taps_rhs<SIGN>(op, t0, t1, t2, t3) - wn[u] * prev;
        x[i + u] = v;
        prev = v;
      }
    }
    for (; i < main_end; ++i) {
      const int j = i + sh + 1;
      T tn = x[j];
      if constexpr (MAYBE_Y) {
        const T yv = y[j];
        tn = has_y ? tn + yv : tn;
      }
      t0 = t1;
      t1 = t2;
      t2 = t3;
      t3 = tn;
      const T v = taps_rhs<SIGN>(op, t0, t1, t2, t3) - op.w[i] * prev;
      x[i] = v;
      prev = v;
    }
    for (; i < hi; ++i) {
      t0 = t1;
      t1 = t2;
      t2 = t3;
      t3 = i + sh + 1 == n ? h0 : h1;
      const T v = taps_rhs<SIGN>(op, t0, t1, t2, t3) - op.w[i] * prev;
      x[i] = v;
      prev = v;
    }
    if (FED) feed.issue(c + kDepth);
  }
  if (FED) cp_async_wait<0>();
  return prev;
}

// forward_strip for a warp whose lanes all run op: the sign of op.s fixed
// at compile time.
template <typename T, bool FED, bool MAYBE_Y, typename Tap>
__device__ __forceinline__ T forward_uniform(const LineOp<T>& op, Col<T> x, Col<T> y,
                                             bool has_y, const Tap& tap, const Feed<T>& feed,
                                             int n) {
  if (op.s > T(0)) return forward_strip<T, FED, MAYBE_Y, 1>(op, x, y, has_y, tap, feed, n);
  return forward_strip<T, FED, MAYBE_Y, -1>(op, x, y, has_y, tap, feed, n);
}

// K13's forward sweep on one lane's line, in place: dmod_i = d_i -
// w_i*dmod_{i-1} over x[i]. The rows arrive by `feed`, whose first kDepth
// groups are in flight; chunk c is swept once group c has landed (a row
// reads only itself), then group c + kDepth is issued. Returns
// dmod_{n-1}.
template <typename T>
__device__ __forceinline__ T thomas_forward_strip(const T* w, Col<T> x, const Feed<T>& feed,
                                                  int n) {
  T prev = T(0);
  for (int c = 0; c * kChunk < n; ++c) {
    cp_async_wait<kDepth - 1>();
    const int hi = min(n, (c + 1) * kChunk);
    int i = c * kChunk;
    if (i == 0) {
      prev = x[0];   // dmod_0 = d_0, already in place
      i = 1;
    }
    for (; i + kU <= hi; i += kU) {   // kU rows and factors, then their steps
      T dn[kU], wn[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        dn[u] = x[i + u];
        wn[u] = w[i + u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const T v = dn[u] - wn[u] * prev;
        x[i + u] = v;
        prev = v;
      }
    }
    for (; i < hi; ++i) {
      const T v = x[i] - w[i] * prev;
      x[i] = v;
      prev = v;
    }
    feed.issue(c + kDepth);
  }
  cp_async_wait<0>();
  return prev;
}

// Back substitution on the strip (x holds the forward sweep, `last` its
// row n-1); x_0 and x_{n-1}, uncorrected, go to *x0 and *xn.
template <typename T>
__device__ __forceinline__ void backward_strip(const LineOp<T>& op, Col<T> x, T last, int n,
                                               T* x0, T* xn) {
  const T vn = last * op.binv[n - 1];
  x[n - 1] = vn;
  T prev = vn;
  int i = n - 2;
  for (; i >= kU - 1; i -= kU) {   // rows i, i-1, .., i-kU+1
    T xs[kU], bs[kU], cs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      xs[u] = x[i - u];
      bs[u] = op.binv[i - u];
      cs[u] = op.cb[i - u];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const T v = xs[u] * bs[u] - cs[u] * prev;
      x[i - u] = v;
      prev = v;
    }
  }
  for (; i >= 0; --i) {
    const T v = x[i] * op.binv[i] - op.cb[i] * prev;
    x[i] = v;
    prev = v;
  }
  *x0 = prev;
  *xn = vn;
}

// The periodic correction x_i -= usol_i * factor, factor = (x_0 +
// ar*x_{n-1})*(1/denom), applied when corr[1] != 0.
template <typename T>
struct Correction {
  const T* corr;
  T factor;
  bool on;

  __device__ __forceinline__ Correction(const T* c, T x0, T xn) : corr(c) {
    const T inv = c[1];
    on = inv != T(0);
    factor = (x0 + c[0] * xn) * inv;
  }
  // row i of the corrected solution (a select, not a branch, so that a
  // block of rows issues its reads together)
  __device__ __forceinline__ T operator()(Col<T> x, int i) const {
    const T v = x[i];
    const T fixed = v - corr[2 + i] * factor;
    return on ? fixed : v;
  }
};

// put(i, get(i)) for every row, in blocks of kU rows whose gets (the
// reads) all come before their puts (the writes).
template <typename T, typename Get, typename Put>
__device__ __forceinline__ void each_row(int n, const Get& get, const Put& put) {
  int i = 0;
  for (; i + kU <= n; i += kU) {
    T v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) v[u] = get(i + u);
#pragma unroll
    for (int u = 0; u < kU; ++u) put(i + u, v[u]);
  }
  for (; i < n; ++i) put(i, get(i));
}

// The corrected solution to row stride Q of out, one coalesced row at a
// time (nothing for a lane past the last line).
template <typename T>
__device__ __forceinline__ void store_strip(const LineOp<T>& op, Col<T> x, T x0, T xn, T* out,
                                            long long Q, int n, bool live) {
  const Correction<T> corr(op.corr, x0, xn);
  if (!live) return;
  each_row<T>(n, [&](int i) { return corr(x, i); }, [&](int i, T v) { out[i * Q] = v; });
}

// The corrected solution over the strip, in place.
template <typename T>
__device__ __forceinline__ void correct_strip(const LineOp<T>& op, Col<T> x, T x0, T xn, int n) {
  const Correction<T> corr(op.corr, x0, xn);
  each_row<T>(n, [&](int i) { return corr(x, i); }, [&](int i, T v) { x[i] = v; });
}

// Values of a strip row for `lanes` lanes (the sum's two columns a lane).
__host__ __device__ inline int strip_pitch(int mode, int lanes) {
  return mode == kSum ? 2 * lanes : lanes;
}

// K17 (or, for MODE kThomas, K13: f0 the RHS d, op1 the factors) on one
// strip of n * strip_pitch(MODE, lanes) values, lane t of `lanes` owning
// line first_line + t; op1 and op2 read their factors from the block's
// tables. `signal` (when not null) is set once op1's forward sweep is
// done.
template <typename T, int MODE>
__device__ __forceinline__ void compact_strip(T* strip, int t, int lanes, long long first_line,
                                              const T* __restrict__ f0, const T* __restrict__ f1,
                                              const T* __restrict__ f2, T* __restrict__ out0,
                                              T* __restrict__ out1, const LineOp<T>& op1,
                                              const LineOp<T>& op2, int n, long long Q,
                                              volatile int* signal) {
  const long long line = first_line + t;
  const bool live = line < Q;
  const long long q = live ? line : Q - 1;       // a lane past the last line reads a real one
  const int pitch = strip_pitch(MODE, lanes);
  const Col<T> x{strip + t, pitch};
  const Col<T> none{nullptr, pitch};
  T x0, xn, last;
  if constexpr (MODE == kThomas) {
    const Feed<T> feed{f0 + q, nullptr, x, none, Q, n};
    feed.start();
    last = thomas_forward_strip(op1.w, x, feed, n);
    if (signal != nullptr) *signal = 1;
    backward_strip(op1, x, last, n, &x0, &xn);
    store_strip(op1, x, x0, xn, out0 + q, Q, n, live);
  } else if constexpr (MODE == kCompact || MODE == kDual) {
    const Feed<T> feed{f0 + q, nullptr, x, none, Q, n};
    const GlobalTap<T> tap{f0 + q, nullptr, Q, false};
    feed.start();
    last = forward_uniform<T, true, false>(op1, x, x, false, tap, feed, n);
    if (signal != nullptr) *signal = 1;
    backward_strip(op1, x, last, n, &x0, &xn);
    store_strip(op1, x, x0, xn, out0 + q, Q, n, live);
    if constexpr (MODE == kDual) {   // f once more, for op2
      feed.start();
      last = forward_uniform<T, true, false>(op2, x, x, false, tap, feed, n);
      backward_strip(op2, x, last, n, &x0, &xn);
      store_strip(op2, x, x0, xn, out1 + q, Q, n, live);
    }
  } else if constexpr (MODE == kChain) {
    const Feed<T> feed{f0 + q, nullptr, x, none, Q, n};
    feed.start();
    last = forward_uniform<T, true, false>(op1, x, x, false, GlobalTap<T>{f0 + q, nullptr, Q, false},
                                           feed, n);
    if (signal != nullptr) *signal = 1;
    backward_strip(op1, x, last, n, &x0, &xn);
    correct_strip(op1, x, x0, xn, n);
    // op2's window and held rows are op1's solution, read from the strip
    last = forward_uniform<T, false, false>(op2, x, x, false, StripTap<T>{x}, feed, n);
    backward_strip(op2, x, last, n, &x0, &xn);
    store_strip(op2, x, x0, xn, out0 + q, Q, n, live);
  } else {   // sum: op1 on fa + fb in x (fb in y), then op2 on f3 in y
    const Col<T> y{strip + lanes + t, pitch};
    const Feed<T> feed1{f0 + q, f1 + q, x, y, Q, n};
    feed1.start();
    last = forward_uniform<T, true, true>(op1, x, y, true, GlobalTap<T>{f0 + q, f1 + q, Q, true},
                                          feed1, n);
    if (signal != nullptr) *signal = 1;
    backward_strip(op1, x, last, n, &x0, &xn);
    correct_strip(op1, x, x0, xn, n);
    const Feed<T> feed2{f2 + q, nullptr, y, none, Q, n};
    feed2.start();
    last = forward_uniform<T, true, false>(op2, y, y, false,
                                           GlobalTap<T>{f2 + q, nullptr, Q, false}, feed2, n);
    backward_strip(op2, y, last, n, &x0, &xn);
    const Correction<T> corr2(op2.corr, x0, xn);
    if (live)
      each_row<T>(n, [&](int i) { return corr2(y, i) + x[i]; },
                  [&](int i, T v) { out0[i * Q + q] = v; });
  }
}

// The most workers (warps) a strip block runs.
constexpr int kMaxWorkers = 8;

// Values of an operator's factor table: w, binv, cb (or K16's wv, binv,
// ca) and corr (K16's: n + 3).
__host__ __device__ inline int table_size(int n) { return 4 * n + 3; }

// Copies op's factors into `table` (every thread of the block takes part;
// the caller synchronises) and returns op reading them from there.
template <typename T>
__device__ __forceinline__ LineOp<T> table_op(const LineOp<T>& op, T* table, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    table[i] = op.w[i];
    table[n + i] = op.binv[i];
    table[2 * n + i] = op.cb[i];
  }
  for (int i = threadIdx.x; i < n + 2; i += blockDim.x) table[3 * n + i] = op.corr[i];
  LineOp<T> t = op;
  t.w = table;
  t.binv = table + n;
  t.cb = table + 2 * n;
  t.corr = table + 3 * n;
  return t;
}

// Waits until worker `worker - 1` of the block has set its flag: with
// stagger on, the workers of a block start one after another, so that one
// worker's loads and stores meet the others' arithmetic.
__device__ __forceinline__ void wait_turn(const int* started, int worker) {
  if (worker == 0) return;
  while (reinterpret_cast<const volatile int*>(started)[worker - 1] == 0) __nanosleep(256);
}

// K17 (and K13) on strips: a persistent block of blockDim.x / 32 workers, one warp
// each (its first `lanes` lanes, 16 or 32), each owning one strip of the
// block's dynamic shared memory after the operators' factor tables; worker
// w of block b takes strips b*W + w, then every gridDim.x*W-th.
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxWorkers * 32)
compact_strip_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                     const T* __restrict__ f2, T* __restrict__ out0, T* __restrict__ out1,
                     const LineOp<T> op1, const LineOp<T> op2, int n, long long Q, int lanes,
                     int stagger) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int started[kMaxWorkers];
  constexpr int kOps = MODE == kCompact || MODE == kThomas ? 1 : 2;
  T* tables = reinterpret_cast<T*>(smem_raw);
  const LineOp<T> t1 = table_op(op1, tables, n);
  const LineOp<T> t2 = kOps == 2 ? table_op(op2, tables + table_size(n), n) : t1;
  if (threadIdx.x < kMaxWorkers) started[threadIdx.x] = 0;
  __syncthreads();
  const int worker = threadIdx.x / 32, t = threadIdx.x % 32, workers = blockDim.x / 32;
  if (t >= lanes) return;
  T* strip = tables + kOps * table_size(n) + (size_t)worker * n * strip_pitch(MODE, lanes);
  const long long strips = (Q + lanes - 1) / lanes;
  bool first = true;
  for (long long k = (long long)blockIdx.x * workers + worker; k < strips;
       k += (long long)gridDim.x * workers) {
    if (first && stagger) wait_turn(started, worker);
    compact_strip<T, MODE>(strip, t, lanes, k * lanes, f0, f1, f2, out0, out1, t1, t2, n, Q,
                           first ? started + worker : nullptr);
    first = false;
  }
}

// K16 on a strip, one lane per line. The loads arrive from both ends:
// group c holds rows [c*kChunk, (c+1)*kChunk) of the downward half (rows
// 0..m) and rows [n-(c+1)*kChunk, n-c*kChunk) of the upward half
// (m+1..n-1), so both eliminations start at once; step k reads rows 1+k
// and n-2-k, which group k/kChunk + 1 covers. Both chains write into the
// strip in place, the middle row couples them, the outward back
// substitution runs on the strip and the correction is fused into the
// store.
template <typename T>
__device__ __forceinline__ void babe_strip(T* strip, int t, int lanes, long long first_line,
                                           const T* __restrict__ d, T* __restrict__ out,
                                           const T* wv, const T* binv, const T* ca,
                                           const T* corr, int n, int m, long long Q,
                                           volatile int* signal) {
  const long long line = first_line + t;
  const bool live = line < Q;
  const long long q = live ? line : Q - 1;
  const Col<T> x{strip + t, lanes};
  const T* g = d + q;
  auto issue = [&](int c) {
    const int f1 = min(m + 1, (c + 1) * kChunk);
    for (int r = c * kChunk; r < f1; ++r) cp_async<sizeof(T)>(&x[r], g + r * Q);
    const int b0 = max(m + 1, n - (c + 1) * kChunk);
    for (int r = n - 1 - c * kChunk; r >= b0; --r) cp_async<sizeof(T)>(&x[r], g + r * Q);
    cp_async_commit();
  };
  for (int c = 0; c < kDepth; ++c) issue(c);
  cp_async_wait<kDepth - 1>();   // group 0: rows 0 and n-1
  T lo = x[0];                   // the downward chain, from row 0
  T hi = x[n - 1];               // the upward chain, from row n-1
  const int kd = m, ku = n - 2 - m;
  const int ke = kd > ku ? kd : ku;
  for (int c = 0; c * kChunk < ke; ++c) {
    cp_async_wait<kDepth - 2>();
    const int k1 = min(ke, (c + 1) * kChunk);
    int k = c * kChunk;
    for (const int kb = min(k1, min(kd, ku)); k + kU <= kb; k += kU) {   // both chains
      T xd[kU], wd[kU], xu[kU], wu[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        xd[u] = x[1 + k + u];
        wd[u] = wv[1 + k + u];
        xu[u] = x[n - 2 - k - u];
        wu[u] = wv[n - 2 - k - u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        lo = xd[u] - wd[u] * lo;
        x[1 + k + u] = lo;
        hi = xu[u] - wu[u] * hi;
        x[n - 2 - k - u] = hi;
      }
    }
    for (; k < k1; ++k) {
      if (k < kd) {
        const int i = 1 + k;
        const T v = x[i] - wv[i] * lo;
        x[i] = v;
        lo = v;
      }
      if (k < ku) {
        const int j = n - 2 - k;
        const T v = x[j] - wv[j] * hi;
        x[j] = v;
        hi = v;
      }
    }
    issue(c + kDepth);
  }
  cp_async_wait<0>();
  if (signal != nullptr) *signal = 1;
  // lo is row m of the downward sweep, hi row m+1 of the upward one
  const T xm = (lo - corr[n + 2] * hi) * binv[m];
  x[m] = xm;
  lo = xm;
  hi = xm;
  const int bd = m, bu = n - 1 - m;   // bu >= bd
  int k = 0;
  for (; k + kU <= bd; k += kU) {   // both directions
    T xd[kU], cd[kU], bdv[kU], xu[kU], cu[kU], buv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = m - 1 - k - u, j = m + 1 + k + u;
      xd[u] = x[i];
      cd[u] = ca[i];
      bdv[u] = binv[i];
      xu[u] = x[j];
      cu[u] = ca[j];
      buv[u] = binv[j];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      lo = (xd[u] - cd[u] * lo) * bdv[u];
      x[m - 1 - k - u] = lo;
      hi = (xu[u] - cu[u] * hi) * buv[u];
      x[m + 1 + k + u] = hi;
    }
  }
  for (; k < bu; ++k) {
    if (k < bd) {
      const int i = m - 1 - k;
      const T v = (x[i] - ca[i] * lo) * binv[i];
      x[i] = v;
      lo = v;
    }
    if (k < bu) {
      const int j = m + 1 + k;
      const T v = (x[j] - ca[j] * hi) * binv[j];
      x[j] = v;
      hi = v;
    }
  }
  const Correction<T> c(corr, lo, hi);   // lo = x_0, hi = x_{n-1}
  if (live)
    each_row<T>(n, [&](int i) { return c(x, i); }, [&](int i, T v) { out[i * Q + q] = v; });
}

// K16 on strips: the persistent blocks of compact_strip_kernel, with one
// factor table (wv, binv, ca, corr).
template <typename T>
__global__ void __launch_bounds__(kMaxWorkers * 32)
babe_strip_kernel(const T* __restrict__ d, T* __restrict__ out, const T* __restrict__ wv,
                  const T* __restrict__ binv, const T* __restrict__ ca,
                  const T* __restrict__ corr, int n, int m, long long Q, int lanes,
                  int stagger) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int started[kMaxWorkers];
  T* table = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    table[i] = wv[i];
    table[n + i] = binv[i];
    table[2 * n + i] = ca[i];
  }
  for (int i = threadIdx.x; i < n + 3; i += blockDim.x) table[3 * n + i] = corr[i];
  if (threadIdx.x < kMaxWorkers) started[threadIdx.x] = 0;
  __syncthreads();
  const int worker = threadIdx.x / 32, t = threadIdx.x % 32, workers = blockDim.x / 32;
  if (t >= lanes) return;
  T* strip = table + table_size(n) + (size_t)worker * n * lanes;
  const long long strips = (Q + lanes - 1) / lanes;
  bool first = true;
  for (long long k = (long long)blockIdx.x * workers + worker; k < strips;
       k += (long long)gridDim.x * workers) {
    if (first && stagger) wait_turn(started, worker);
    babe_strip(strip, t, lanes, k * lanes, d, out, table, table + n, table + 2 * n,
               table + 3 * n, n, m, Q, first ? started + worker : nullptr);
    first = false;
  }
}

// What a strip launch needs of the device: the most shared memory a block
// may take (static and dynamic) and the number of SMs.
struct SmemLimits {
  int per_block = 0, sms = 0;
};

inline cudaError_t smem_limits(int device, SmemLimits* lim) {
  cudaError_t err = cudaDeviceGetAttribute(&lim->per_block,
                                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&lim->sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

inline size_t strip_bytes(int mode, int lanes, int n, size_t tsize) {
  return (size_t)n * strip_pitch(mode, lanes) * tsize;
}

inline size_t table_bytes(int mode, int n, size_t tsize) {
  return (size_t)(mode == kCompact || mode == kBabe || mode == kThomas ? 1 : 2) *
         table_size(n) * tsize;
}

// Workers one block can hold beside its factor tables (the static flags
// take the 64 bytes kept aside), at most kMaxWorkers.
inline int max_workers(const SmemLimits& lim, int mode, int lanes, int n, size_t tsize) {
  const long long room =
      (long long)lim.per_block - 64 - (long long)table_bytes(mode, n, tsize);
  const long long w = room / (long long)strip_bytes(mode, lanes, n, tsize);
  return w < 0 ? 0 : w > kMaxWorkers ? kMaxWorkers : (int)w;
}

// Lanes of a worker for Q lines of n rows: 32 when a block holds three
// 32-lane workers and the lines make two strips an SM, else 16 when a
// block holds two 16-lane workers, else 0 (the streaming kernel).
inline int strip_lanes(const SmemLimits& lim, int mode, int n, long long Q, size_t tsize) {
  if (max_workers(lim, mode, 32, n, tsize) >= 3 && Q >= 2LL * lim.sms * 32) return 32;
  if (max_workers(lim, mode, 16, n, tsize) >= 2) return 16;
  return 0;
}

// Sets a kernel's shared-memory attributes for `bytes` once (per device
// and size; a launch is host-bound at the small sizes).
inline cudaError_t allow_smem(const void* kernel, int device, size_t bytes) {
  struct Entry {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static Entry seen[64];
  static int count = 0;
  for (int k = 0; k < count; ++k)
    if (seen[k].kernel == kernel && seen[k].device == device && seen[k].bytes >= bytes)
      return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && count < 64) seen[count++] = Entry{kernel, device, bytes};
  return err;
}

// Launches a strip kernel: one persistent block an SM (fewer when there
// are fewer strips), as many workers a block as the strips need and the
// shared memory holds. The workers start in turn (stagger) when a block
// has at most four and each takes eight strips or more (PERF.md: with six
// workers a block, or few strips each, staggering costs more than it
// saves).
template <typename Kernel, typename... Args>
cudaError_t launch_strip(Kernel* kernel, const SmemLimits& lim, int device, int mode, int lanes,
                         int n, size_t tsize, cudaStream_t stream, long long Q, Args... args) {
  if (lanes != 16 && lanes != 32) return cudaErrorInvalidValue;
  const int wmax = max_workers(lim, mode, lanes, n, tsize);
  if (wmax < 1) return cudaErrorInvalidValue;
  const long long strips = (Q + lanes - 1) / lanes;
  const long long grid = strips < lim.sms ? strips : lim.sms;
  const long long need = (strips + grid - 1) / grid;
  const int workers = need < wmax ? (int)need : wmax;
  const int stagger = workers <= 4 && strips >= 8 * grid * workers;
  const size_t bytes = table_bytes(mode, n, tsize) + workers * strip_bytes(mode, lanes, n, tsize);
  // all of the SM's shared memory to the block
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), device, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, workers * 32, bytes, stream>>>(args..., Q, lanes, stagger);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_compact_strip(cudaStream_t stream, const SmemLimits& lim, int device, int mode,
                                 int lanes, const void* const* in, void* const* out,
                                 const LineOp<T>& op1, const LineOp<T>& op2, int n, long long Q) {
  const T* f0 = static_cast<const T*>(in[0]);
  const T* f1 = static_cast<const T*>(in[1]);
  const T* f2 = static_cast<const T*>(in[2]);
  T* o0 = static_cast<T*>(out[0]);
  T* o1 = static_cast<T*>(out[1]);
#define POISSBOX_STRIP(M)                                                                    \
  launch_strip(compact_strip_kernel<T, M>, lim, device, M, lanes, n, sizeof(T), stream, Q, f0, \
               f1, f2, o0, o1, op1, op2, n)
  switch (mode) {
    case kCompact:
      return POISSBOX_STRIP(kCompact);
    case kDual:
      return POISSBOX_STRIP(kDual);
    case kChain:
      return POISSBOX_STRIP(kChain);
    case kSum:
      return POISSBOX_STRIP(kSum);
    case kThomas:
      return POISSBOX_STRIP(kThomas);
    default:
      return cudaErrorInvalidValue;
  }
#undef POISSBOX_STRIP
}

template <typename T>
cudaError_t launch_babe_strip(cudaStream_t stream, const SmemLimits& lim, int device, int lanes,
                              const void* d, void* x, const void* wv, const void* binv,
                              const void* ca, const void* corr, int n, int m, long long Q) {
  return launch_strip(babe_strip_kernel<T>, lim, device, kBabe, lanes, n, sizeof(T), stream, Q,
                      static_cast<const T*>(d), static_cast<T*>(x), static_cast<const T*>(wv),
                      static_cast<const T*>(binv), static_cast<const T*>(ca),
                      static_cast<const T*>(corr), n, m);
}

}  // namespace poissbox

extern "C" {

// K13. dtype: 0 = float32, 1 = float64. d and x are (n, Q) contiguous; w,
// binv and cb hold n values, corr n + 2 (corr[1] = 0: no periodic
// correction). The strip kernel where the lines fit, else the streaming
// one (poissbox_strip_lanes, mode 5). Returns the cudaError_t of the
// launch (0 on success).
int poissbox_thomas(int dtype, int device, void* stream, const void* d, void* x, const void* w,
                    const void* binv, const void* cb, const void* corr, int n, long long Q) {
  if (n < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  if (dtype != poissbox::kF32 && dtype != poissbox::kF64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  poissbox::SmemLimits lim;
  err = poissbox::smem_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const bool f32 = dtype == poissbox::kF32;
  const int lanes = poissbox::strip_lanes(lim, poissbox::kThomas, n, Q, f32 ? 4 : 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes == 0)
    return (int)(f32 ? poissbox::launch_thomas<float>(s, d, x, w, binv, cb, corr, n, Q)
                     : poissbox::launch_thomas<double>(s, d, x, w, binv, cb, corr, n, Q));
  const void* in[3] = {d, nullptr, nullptr};
  void* out[2] = {x, nullptr};
  const void* fac[4] = {w, binv, cb, corr};
  if (f32) {
    const auto op = poissbox::line_op<float>(fac, 0.0, 0.0, 1, 0);
    err = poissbox::launch_compact_strip<float>(s, lim, device, poissbox::kThomas, lanes, in, out,
                                                op, op, n, Q);
  } else {
    const auto op = poissbox::line_op<double>(fac, 0.0, 0.0, 1, 0);
    err = poissbox::launch_compact_strip<double>(s, lim, device, poissbox::kThomas, lanes, in,
                                                 out, op, op, n, Q);
  }
  return (int)err;
}

// The strip lanes that K17 mode `mode` (0 compact, 1 dual, 2 chain, 3
// sum), K16 (mode 4) or K13 (mode 5) takes for Q lines of n rows of dtype
// on `device`: 32 or 16, or 0 for the streaming kernel; a negative
// cudaError_t on a bad argument.
int poissbox_strip_lanes(int dtype, int mode, int n, long long Q, int device) {
  if ((dtype != poissbox::kF32 && dtype != poissbox::kF64) || mode < 0 || mode > 5 || n < 1 ||
      Q < 1)
    return -(int)cudaErrorInvalidValue;
  poissbox::SmemLimits lim;
  const cudaError_t err = poissbox::smem_limits(device, &lim);
  if (err != cudaSuccess) return -(int)err;
  return poissbox::strip_lanes(lim, mode, n, Q, dtype == poissbox::kF32 ? 4 : 8);
}

// K16: as poissbox_thomas, with the twisted factorization's wv, binv and
// ca (n values each), corr (n + 3, vm at corr[n + 2]) and the middle row
// m = (n - 2) / 2; n >= 2. The strip kernel where the lines fit, else the
// streaming one (poissbox_strip_lanes).
int poissbox_babe(int dtype, int device, void* stream, const void* d, void* x, const void* wv,
                  const void* binv, const void* ca, const void* corr, int n, int m,
                  long long Q) {
  if (n < 2 || m != (n - 2) / 2 || Q < 1) return (int)cudaErrorInvalidValue;
  if (dtype != poissbox::kF32 && dtype != poissbox::kF64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  poissbox::SmemLimits lim;
  err = poissbox::smem_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const bool f32 = dtype == poissbox::kF32;
  const int lanes = poissbox::strip_lanes(lim, poissbox::kBabe, n, Q, f32 ? 4 : 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes == 0)
    err = f32 ? poissbox::launch_babe<float>(s, d, x, wv, binv, ca, corr, n, m, Q)
              : poissbox::launch_babe<double>(s, d, x, wv, binv, ca, corr, n, m, Q);
  else
    err = f32 ? poissbox::launch_babe_strip<float>(s, lim, device, lanes, d, x, wv, binv, ca,
                                                   corr, n, m, Q)
              : poissbox::launch_babe_strip<double>(s, lim, device, lanes, d, x, wv, binv, ca,
                                                    corr, n, m, Q);
  return (int)err;
}

// K17: mode 0 compact (in0 -> out0), 1 dual (in0 -> out0, out1), 2 chain
// (in0 -> out0), 3 sum (in0 + in1 and in2 -> out0). Every field is (n, Q)
// contiguous, unused ones null. Operator k (k = 1, 2) has the Thomas
// factors wk, binvk, cbk, corrk (as poissbox_thomas's) and the RHS (ak,
// bk, opsignk, shiftk). The strip kernel where the lines fit, else the
// streaming one (poissbox_strip_lanes), which solves chain's and sum's op1
// in the scratch field mid (null for the strip kernel).
int poissbox_compact_thomas(int dtype, int mode, int device, void* stream, const void* in0,
                            const void* in1, const void* in2, void* out0, void* out1, void* mid,
                            const void* w1, const void* binv1, const void* cb1,
                            const void* corr1, const void* w2, const void* binv2,
                            const void* cb2, const void* corr2, double a1, double b1,
                            int opsign1, int shift1, double a2, double b2, int opsign2,
                            int shift2, int n, long long Q) {
  if (mode < 0 || mode > 3 || n < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  if (dtype != poissbox::kF32 && dtype != poissbox::kF64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  poissbox::SmemLimits lim;
  err = poissbox::smem_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const bool f32 = dtype == poissbox::kF32;
  const int lanes = poissbox::strip_lanes(lim, mode, n, Q, f32 ? 4 : 8);
  if (lanes == 0 && (mode == poissbox::kChain || mode == poissbox::kSum) && mid == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[3] = {in0, in1, in2};
  void* out[2] = {out0, out1};
  const void* fac1[4] = {w1, binv1, cb1, corr1};
  const void* fac2[4] = {w2, binv2, cb2, corr2};
  const double spec[4] = {a1, b1, a2, b2};
  const int ispec[4] = {opsign1, shift1, opsign2, shift2};
  if (lanes == 0) {
    err = f32 ? poissbox::launch_compact_thomas<float>(s, mode, in, out, mid, fac1, fac2, spec,
                                                       ispec, n, Q)
              : poissbox::launch_compact_thomas<double>(s, mode, in, out, mid, fac1, fac2, spec,
                                                        ispec, n, Q);
  } else if (f32) {
    const auto op1 = poissbox::line_op<float>(fac1, spec[0], spec[1], ispec[0], ispec[1]);
    const auto op2 = mode == poissbox::kCompact
                         ? op1
                         : poissbox::line_op<float>(fac2, spec[2], spec[3], ispec[2], ispec[3]);
    err = poissbox::launch_compact_strip<float>(s, lim, device, mode, lanes, in, out, op1, op2, n,
                                                Q);
  } else {
    const auto op1 = poissbox::line_op<double>(fac1, spec[0], spec[1], ispec[0], ispec[1]);
    const auto op2 = mode == poissbox::kCompact
                         ? op1
                         : poissbox::line_op<double>(fac2, spec[2], spec[3], ispec[2], ispec[3]);
    err = poissbox::launch_compact_strip<double>(s, lim, device, mode, lanes, in, out, op1, op2,
                                                 n, Q);
  }
  return (int)err;
}

}  // extern "C"
