// The elementwise multi-limb operations (mp.add / sub / mul / fma / div /
// sqrt / mul_float) at KLIMBS limbs, one fused kernel per operation, and
// mp.sum_'s halving-tree reduction in one launch.
//
// Replaces the reference's jitted tier arithmetic: repro/core/sdp.py's
// _ml_add/_ml_sub/_ml_smul_*/... (jax.jit of mp.add, mp.mul, ...), which
// XLA fuses into one loop per call, and the tier ops inside the jitted
// linear algebra (repro/core/linalg.py) and refinement steps
// (repro/solve/refine.py).  Eager PyTorch runs each limb-level EFT step as
// its own launch: a qd mp.mul is some two thousand of them, a qd mp.div
// some seven thousand, so the SDP loop's small sequential factorizations
// and triangular solves are bound by launch overhead.  Here one launch computes the whole
// operation per element.  The build compiles this file once per limb
// count (-DKLIMBS=2|3|4, see kernels/_build.py).
//
// What it computes: exactly the plain version's sequence -- dd.add /
// dd.mul / dd.div / dd.sqrt / dd.mul_float (dd_device.cuh) at dd, the
// count-generic mp.*_limbs family (ml_device.cuh) at td/qd -- so kernel and
// plain version (repro_torch/kernels/mpops.py, mpops_plain) agree bit for
// bit.  sub is add with the second operand's limbs negated, as
// mp.sub = add(a, neg(b)); fma is add(acc, mul(a, b)).
//
// Bound on the H100: operations for the wide ops at large sizes, bytes
// for add at large sizes, launch latency at the small sizes of the SDP's
// sequential loops (chip_smoke.py counts both for its timed shape).
//
// Design: a grid-stride loop, one element per thread step.  Operands are
// read through their own strides over the (up to 4-D) output shape, so
// broadcasts and sliced views cost no copy.  The sum runs one block
// per output column, its threads sharing each level's pair adds.
#include <cuda_runtime.h>

#include "dd_device.cuh"
#include "ml_device.cuh"

#ifndef KLIMBS
#error "build with -DKLIMBS=2, 3 or 4"
#endif

namespace {

constexpr int K = KLIMBS;
constexpr int THREADS = 128;

enum Op { kAdd = 0, kSub = 1, kMul = 2, kFma = 3, kDiv = 4, kSqrt = 5, kMulFloat = 6 };

constexpr int DIMS = 4;

// Operand limbs with their element strides over the (up to 4-D, leading
// dims padded with 1) output shape; 0 is a broadcast dim.
struct Operand {
  const double *p[K];
  long long st[DIMS];
};
struct Out {
  double *p[K];
};
struct Shape {
  long long d[DIMS];
};

// Element offset of output index i in operand x.
__device__ __forceinline__ long long offset(const Operand &x, const Shape &sh, long long i) {
  long long off = 0;
#pragma unroll
  for (int k = DIMS - 1; k >= 0; --k) {
    off += (i % sh.d[k]) * x.st[k];
    i /= sh.d[k];
  }
  return off;
}

__device__ __forceinline__ void load(const Operand &x, const Shape &sh, long long i,
                                     double (&v)[K]) {
  long long off = offset(x, sh, i);
#pragma unroll
  for (int l = 0; l < K; ++l) v[l] = x.p[l][off];
}

__device__ __forceinline__ void add(const double (&a)[K], const double (&b)[K], double (&r)[K]) {
  if constexpr (K == 2) {
    r[0] = a[0];
    r[1] = a[1];
    dd::add_to(r[0], r[1], b[0], b[1]);
  } else {
    ml::add_limbs<K>(a, b, r);
  }
}

__device__ __forceinline__ void mul(const double (&a)[K], const double (&b)[K], double (&r)[K]) {
  if constexpr (K == 2) {
    dd::mul(a[0], a[1], b[0], b[1], r[0], r[1]);
  } else {
    ml::mul_limbs<K>(a, b, r);
  }
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
mpops_kernel(Operand x, Operand y, Operand w, Out o, Shape sh, long long n) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    double a[K], r[K];
    load(x, sh, i, a);
    if constexpr (OP == kAdd || OP == kSub || OP == kMul || OP == kDiv) {
      double b[K];
      load(y, sh, i, b);
      if constexpr (OP == kSub) {
#pragma unroll
        for (int l = 0; l < K; ++l) b[l] = -b[l];
      }
      if constexpr (OP == kAdd || OP == kSub) add(a, b, r);
      if constexpr (OP == kMul) mul(a, b, r);
      if constexpr (OP == kDiv) {
        if constexpr (K == 2) dd::div(a[0], a[1], b[0], b[1], r[0], r[1]);
        else ml::div_limbs<K>(a, b, r);
      }
    } else if constexpr (OP == kFma) {
      double b[K], c[K], p[K];
      load(y, sh, i, b);
      load(w, sh, i, c);
      mul(b, c, p);
      add(a, p, r);
    } else if constexpr (OP == kSqrt) {
      if constexpr (K == 2) dd::sqrt(a[0], a[1], r[0], r[1]);
      else ml::sqrt_limbs<K>(a, r);
    } else if constexpr (OP == kMulFloat) {
      double s = y.p[0][offset(y, sh, i)];
      if constexpr (K == 2) dd::mul_float(a[0], a[1], s, r[0], r[1]);
      else ml::mul_float_limbs<K>(a, s, r);
    }
#pragma unroll
    for (int l = 0; l < K; ++l) o.p[l][i] = r[l];
  }
}

// mp.sum_ along the leading axis of x (L, N): the tier modules' halving
// tree, pairs (2i, 2i+1) per level and an odd tail added onto the first
// partial through a zero-padded row (so every partial of that level takes
// the add, as in the plain version).  One block per column at a time; the
// levels ping-pong between two scratch buffers (x is only read).
__global__ void __launch_bounds__(THREADS)
sum_kernel(Operand x, Out s0, Out s1, Out o, long long L, long long N) {
  for (long long j = blockIdx.x; j < N; j += gridDim.x) {
    const double *src[K];
    double *dst[K];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      src[l] = x.p[l];
      dst[l] = s0.p[l];
    }
    bool to_s0 = true;
    for (long long m = L; m > 1; m /= 2) {
      const long long half = m / 2;
      for (long long i = threadIdx.x; i < half; i += THREADS) {
        double a[K], b[K], r[K];
#pragma unroll
        for (int l = 0; l < K; ++l) {
          a[l] = src[l][(2 * i) * N + j];
          b[l] = src[l][(2 * i + 1) * N + j];
        }
        add(a, b, r);
        if (m % 2) {
          double t[K], r2[K];
#pragma unroll
          for (int l = 0; l < K; ++l) t[l] = i == 0 ? src[l][(m - 1) * N + j] : 0.0;
          add(r, t, r2);
#pragma unroll
          for (int l = 0; l < K; ++l) r[l] = r2[l];
        }
#pragma unroll
        for (int l = 0; l < K; ++l) dst[l][i * N + j] = r[l];
      }
      __syncthreads();
#pragma unroll
      for (int l = 0; l < K; ++l) {
        src[l] = dst[l];
        dst[l] = to_s0 ? s1.p[l] : s0.p[l];
      }
      to_s0 = !to_s0;
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int l = 0; l < K; ++l) o.p[l][j] = src[l][j];
    }
    __syncthreads();
  }
}

template <int OP>
cudaError_t launch(Operand x, Operand y, Operand w, Out o, Shape sh,
                   long long n, cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  mpops_kernel<OP><<<(unsigned)blocks, THREADS, 0, stream>>>(x, y, w, o, sh, n);
  return cudaGetLastError();
}

Operand operand(const double *const *p, const long long *st, int nlimbs) {
  Operand x{};
  for (int l = 0; l < K; ++l) x.p[l] = l < nlimbs ? p[l] : nullptr;
  for (int k = 0; k < DIMS; ++k) x.st[k] = st ? st[k] : 0;
  return x;
}

}  // namespace

// out = op(x[, y[, w]]) elementwise over the 4-D output shape `shape`
// (leading dims padded with 1; out contiguous) at KLIMBS limbs.  x, y, w
// and out point at KLIMBS limb pointers each (host arrays; unused operands
// may be null; mul_float's y is one f64 tensor, y[0]); sx, sy, sw are each
// input's 4 element strides (0 on a broadcast dim).  op: 0 add, 1 sub,
// 2 mul, 3 fma (x + y*w), 4 div, 5 sqrt, 6 mul_float.  Launches on
// `stream`; returns the launch's cudaGetLastError() (0 on success).
extern "C" int mpops(int op, const double *const *x, const long long *sx,
                     const double *const *y, const long long *sy,
                     const double *const *w, const long long *sw,
                     double *const *out, const long long *shape,
                     cudaStream_t stream) {
  Shape sh;
  long long n = 1;
  for (int k = 0; k < DIMS; ++k) {
    sh.d[k] = shape[k];
    n *= shape[k];
  }
  if (n <= 0) return 0;
  Operand xo = operand(x, sx, K);
  Operand yo = y ? operand(y, sy, op == kMulFloat ? 1 : K) : Operand{};
  Operand wo = w ? operand(w, sw, K) : Operand{};
  Out o;
  for (int l = 0; l < K; ++l) o.p[l] = out[l];
  switch (op) {
    case kAdd: return (int)launch<kAdd>(xo, yo, wo, o, sh, n, stream);
    case kSub: return (int)launch<kSub>(xo, yo, wo, o, sh, n, stream);
    case kMul: return (int)launch<kMul>(xo, yo, wo, o, sh, n, stream);
    case kFma: return (int)launch<kFma>(xo, yo, wo, o, sh, n, stream);
    case kDiv: return (int)launch<kDiv>(xo, yo, wo, o, sh, n, stream);
    case kSqrt: return (int)launch<kSqrt>(xo, yo, wo, o, sh, n, stream);
    case kMulFloat: return (int)launch<kMulFloat>(xo, yo, wo, o, sh, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[j] = sum over the leading axis of x (L, N) at KLIMBS limbs, in the
// halving-tree order of mp.sum_.  x, s0, s1 and out point at KLIMBS limb
// pointers each (host arrays): x (L, N) contiguous and only read, s0
// (L / 2, N) and s1 (max(L / 4, 1), N) scratch, out (N,).  Launches on
// `stream`; returns the launch's cudaGetLastError() (0 on success).
extern "C" int mpops_sum(const double *const *x, double *const *s0,
                         double *const *s1, double *const *out, long long L,
                         long long N, cudaStream_t stream) {
  if (L <= 0 || N <= 0) return L < 0 || N < 0 ? (int)cudaErrorInvalidValue : 0;
  const long long st[DIMS] = {0, 0, N, 1};
  Operand xo = operand(x, st, K);
  Out a, b, o;
  for (int l = 0; l < K; ++l) {
    a.p[l] = s0[l];
    b.p[l] = s1[l];
    o.p[l] = out[l];
  }
  long long blocks = N < 132 * 16 ? N : 132 * 16;
  sum_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(xo, a, b, o, L, N);
  return (int)cudaGetLastError();
}
