// k-limb (td, qd) device arithmetic shared by the hand-written kernels.
//
// Every function repeats, op for op and term for term, the count-generic
// family of repro_torch/core/mp.py (itself the port of repro/core/mp.py):
// two_prod_terms with the scale rescue, renorm_list with three sweeps and
// the `last = last + t` tail, add/mul/fma/mul_float/div/sqrt at k limbs.
// The same two rules as dd_device.cuh keep a kernel bit-identical to its
// plain PyTorch version: every add, subtract and multiply is a __d*_rn
// intrinsic (never contracted; the build passes --fmad=false besides), and
// nothing is reassociated.  Term lists live in fixed-size arrays indexed by
// compile-time constants, so they stay in registers once unrolled.
#pragma once

#include "dd_device.cuh"

namespace ml {

using dd::add;
using dd::mul;
using dd::quick_two_sum;
using dd::sub;
using dd::two_sum;

// An operand of two_prod_terms after the rescue and the mask split; the
// low part is split once more at 12 bits (the `b` side of the product).
struct Split {
  double h, l, lh, ll;
  int e;
};

__device__ __forceinline__ Split split(double x) {
  dd::Split s = dd::split(x);
  double lh = __longlong_as_double(__double_as_longlong(s.l) &
                                   (long long)0xFFFFFF0000000000ULL);
  return {s.h, s.l, lh, sub(s.l, lh), s.e};
}

// efts.two_prod_terms: a*b as five floats summing to it exactly, in the
// order [ah*bh, ah*bl, al*bh, al*blh, al*bll].
__device__ __forceinline__ void two_prod_terms(const Split &a, const Split &b, double *t) {
  int e = a.e + b.e;
  t[0] = dd::unscale(mul(a.h, b.h), e);
  t[1] = dd::unscale(mul(a.h, b.l), e);
  t[2] = dd::unscale(mul(a.l, b.h), e);
  t[3] = dd::unscale(mul(a.l, b.lh), e);
  t[4] = dd::unscale(mul(a.l, b.ll), e);
}

// mp._vecsum_bottom_up, in place.
template <int N>
__device__ __forceinline__ void vecsum_bottom_up(double (&t)[N]) {
  double s = t[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) {
    double e;
    two_sum(t[i], s, s, e);
    t[i + 1] = e;
  }
  t[0] = s;
}

// mp._compress_top_down, in place.
template <int N>
__device__ __forceinline__ void compress_top_down(double (&t)[N]) {
  double acc = t[0];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    double e;
    two_sum(acc, t[i], acc, e);
    t[i] = e;
  }
  t[0] = acc;
}

// mp.renorm_list(terms, k=K, sweeps=3).  Destroys t.
template <int K, int N>
__device__ __forceinline__ void renorm(double (&t)[N], double (&out)[K]) {
  static_assert(N >= K, "renorm distills at least K terms");
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    vecsum_bottom_up(t);
    compress_top_down(t);
  }
  double last = t[N - 1];
#pragma unroll
  for (int i = N - 2; i >= K - 1; --i) last = add(last, t[i]);
  double h[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) h[i] = t[i];
  h[K - 1] = last;
  vecsum_bottom_up(h);
  compress_top_down(h);
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = h[i];
}

// mp.add_limbs: distill the concatenated expansions.
template <int K>
__device__ __forceinline__ void add_limbs(const double (&a)[K], const double (&b)[K],
                                          double (&out)[K]) {
  double t[2 * K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    t[i] = a[i];
    t[K + i] = b[i];
  }
  renorm<K>(t, out);
}

// Terms of mp.mul_limbs at K limbs: exact pair products below order K-1,
// plain products at order K-1.
template <int K>
constexpr int kMulTerms = 5 * (K * (K - 1) / 2) + K;

// mp.mul_limbs with the operands' splits precomputed (limbs 0..K-2 of
// each; the systolic kernel splits every operand once per K step).
template <int K>
__device__ __forceinline__ void mul_limbs_split(const double (&a)[K], const Split *as,
                                                const double (&b)[K], const Split *bs,
                                                double (&out)[K]) {
  double t[kMulTerms<K>];
  int n = 0;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (i + j < K - 1) {
        two_prod_terms(as[i], bs[j], t + n);
        n += 5;
      } else if (i + j == K - 1) {
        t[n++] = mul(a[i], b[j]);
      }
    }
  renorm<K>(t, out);
}

template <int K>
__device__ __forceinline__ void mul_limbs(const double (&a)[K], const double (&b)[K],
                                          double (&out)[K]) {
  Split as[K - 1], bs[K - 1];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    as[i] = split(a[i]);
    bs[i] = split(b[i]);
  }
  mul_limbs_split<K>(a, as, b, bs, out);
}

// mp.fma_limbs: acc + a*b.
template <int K>
__device__ __forceinline__ void fma_limbs(const double (&acc)[K], const double (&a)[K],
                                          const double (&b)[K], double (&out)[K]) {
  double p[K];
  mul_limbs<K>(a, b, p);
  add_limbs<K>(acc, p, out);
}

// mp.mul_float_limbs: K limbs times one float.
template <int K>
__device__ __forceinline__ void mul_float_limbs(const double (&a)[K], double b,
                                                double (&out)[K]) {
  double t[5 * (K - 1) + 1];
  Split bs = split(b);
#pragma unroll
  for (int i = 0; i < K - 1; ++i) two_prod_terms(split(a[i]), bs, t + 5 * i);
  t[5 * (K - 1)] = mul(a[K - 1], b);
  renorm<K>(t, out);
}

// mp.div_limbs: K + 1 native-quotient correction rounds.
template <int K>
__device__ __forceinline__ void div_limbs(const double (&a)[K], const double (&b)[K],
                                          double (&out)[K]) {
  double q[K + 1], r[K];
#pragma unroll
  for (int i = 0; i < K; ++i) r[i] = a[i];
#pragma unroll
  for (int i = 0; i < K + 1; ++i) {
    q[i] = __ddiv_rn(r[0], b[0]);
    double p[K];
    mul_float_limbs<K>(b, q[i], p);
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = -p[j];
    double nr[K];
    add_limbs<K>(r, p, nr);
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = nr[j];
  }
  renorm<K>(q, out);
}

// mp.sqrt_limbs: a dd seed (dd.sqrt of the double-word rounding) and one
// Heron step s <- (s + a/s) / 2; zero maps to zero.
template <int K>
__device__ __forceinline__ void sqrt_limbs(const double (&a)[K], double (&out)[K]) {
  double s, e;
  quick_two_sum(a[0], a[1], s, e);
  if constexpr (K > 2) {
    double tail = a[2];
#pragma unroll
    for (int i = 3; i < K; ++i) tail = add(tail, a[i]);
    e = add(e, tail);
  }
  double hi, lo;
  quick_two_sum(s, e, hi, lo);
  double s0[K];
  dd::sqrt(hi, lo, s0[0], s0[1]);
#pragma unroll
  for (int i = 2; i < K; ++i) s0[i] = 0.0;
  double q[K], h[K];
  div_limbs<K>(a, s0, q);
  add_limbs<K>(s0, q, h);
  bool zero = a[0] == 0.0;
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = zero ? 0.0 : mul(h[i], 0.5);
}

}  // namespace ml
