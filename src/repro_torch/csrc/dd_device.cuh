// Double-word (dd) device arithmetic shared by the hand-written kernels.
//
// Every function repeats, op for op, the error-free-transformation sequence
// of repro_torch/core/efts.py and core/dd.py (themselves ports of
// repro/core/efts.py and repro/core/dd.py), so that a kernel and its plain
// PyTorch version agree bit for bit.  Two rules keep that true:
//   * every add, subtract and multiply is a __d*_rn intrinsic, which the
//     compiler never contracts into an FMA (and the build passes
//     --fmad=false besides): a multiply fused into the following add would
//     collapse the error terms of two_sum/two_prod;
//   * nothing is reassociated: (a + b) - b stays two rounded operations.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dd {

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// Knuth's two_sum: s + e == a + b exactly.
__device__ __forceinline__ void two_sum(double a, double b, double &s, double &e) {
  s = add(a, b);
  double bb = sub(s, a);
  e = add(sub(a, sub(s, bb)), sub(b, bb));
}

// Dekker's quick_two_sum: exact when |a| >= |b|.
__device__ __forceinline__ void quick_two_sum(double a, double b, double &s, double &e) {
  s = add(a, b);
  e = sub(b, sub(s, a));
}

// An operand of two_prod after the scale rescue and the mask split:
// x * 2^-e == h + l, h holding the top 26 significant bits.
struct Split {
  double h, l;
  int e;
};

// _rescue + mask_split of efts.py: operands beyond 2^+-484 move by 2^-+512
// into the safe band (e is the integer unscale exponent), then the low 27
// mantissa bits are masked off through the integer view.
__device__ __forceinline__ Split split(double x) {
  double ax = fabs(x);
  double s = 1.0;
  int e = 0;
  if (ax < 0x1p-484) {
    s = 0x1p512;
    e = -512;
  } else if (ax > 0x1p484) {
    s = 0x1p-512;
    e = 512;
  }
  double xs = mul(x, s);
  double h = __longlong_as_double(__double_as_longlong(xs) &
                                  (long long)0xFFFFFFFFF8000000ULL);
  return {h, sub(xs, h), e};
}

// Exact 2^e through the exponent field (e in the normal range).
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// _unscale: x * 2^(ea+eb) as two exact halves.  x * 1.0 * 1.0 == x for
// every x, so the in-band case (sum 0, by far the common one) skips it.
__device__ __forceinline__ double unscale(double x, int e) {
  if (e == 0) return x;
  int h = e >> 1;  // shift sums are even
  return mul(mul(x, pow2(h)), pow2(e - h));
}

// two_prod on split operands: p + e == a*b up to 2^-104 relative.
__device__ __forceinline__ void two_prod(const Split &a, const Split &b, double &p, double &e) {
  double m1 = mul(a.h, b.h);
  double m2 = mul(a.h, b.l);
  double m3 = mul(a.l, b.h);
  double m4 = mul(a.l, b.l);
  double s, e1, e2, e3;
  two_sum(m1, m2, s, e1);
  two_sum(s, m3, s, e2);
  two_sum(s, m4, s, e3);
  double er = add(e1, add(e2, e3));
  int sc = a.e + b.e;
  p = unscale(s, sc);
  e = unscale(er, sc);
}

// dd.mul with the operands' splits precomputed (the systolic kernel splits
// each A and B element once per K step, not once per output).
__device__ __forceinline__ void mul_split(double ahi, double alo, const Split &as,
                                          double bhi, double blo, const Split &bs,
                                          double &rhi, double &rlo) {
  double p, e;
  two_prod(as, bs, p, e);
  e = add(e, add(mul(ahi, blo), mul(alo, bhi)));
  quick_two_sum(p, e, rhi, rlo);
}

// dd.mul(a, b).
__device__ __forceinline__ void mul(double ahi, double alo, double bhi, double blo,
                                    double &rhi, double &rlo) {
  mul_split(ahi, alo, split(ahi), bhi, blo, split(bhi), rhi, rlo);
}

// dd.add(a, b): Li et al.'s accurate add.  In place on a.
__device__ __forceinline__ void add_to(double &ahi, double &alo, double bhi, double blo) {
  double s, e, t, f;
  two_sum(ahi, bhi, s, e);
  two_sum(alo, blo, t, f);
  e = add(e, t);
  quick_two_sum(s, e, s, e);
  e = add(e, f);
  quick_two_sum(s, e, ahi, alo);
}

// dd.add_float(a, b).  In place on a.
__device__ __forceinline__ void add_float_to(double &ahi, double &alo, double b) {
  double s, e;
  two_sum(ahi, b, s, e);
  e = add(e, alo);
  quick_two_sum(s, e, ahi, alo);
}

// dd.mul_float(a, b).
__device__ __forceinline__ void mul_float(double ahi, double alo, double b,
                                          double &rhi, double &rlo) {
  double p, e;
  two_prod(split(ahi), split(b), p, e);
  e = add(e, mul(alo, b));
  quick_two_sum(p, e, rhi, rlo);
}

// dd.sub(a, b) == dd.add(a, dd.neg(b)).  In place on a.
__device__ __forceinline__ void sub_from(double &ahi, double &alo, double bhi, double blo) {
  add_to(ahi, alo, -bhi, -blo);
}

// dd.div(a, b): three native quotients, the QD library's long division.
__device__ __forceinline__ void div(double ahi, double alo, double bhi, double blo,
                                    double &rhi, double &rlo) {
  double q1 = __ddiv_rn(ahi, bhi);
  double mh, ml, rh = ahi, rl = alo;
  mul_float(bhi, blo, q1, mh, ml);
  sub_from(rh, rl, mh, ml);
  double q2 = __ddiv_rn(rh, bhi);
  mul_float(bhi, blo, q2, mh, ml);
  sub_from(rh, rl, mh, ml);
  double q3 = __ddiv_rn(rh, bhi);
  double q, e;
  quick_two_sum(q1, q2, q, e);
  add_float_to(q, e, q3);
  rhi = q;
  rlo = e;
}

// dd.sqrt: Karp's trick, x ~ 1/sqrt(hi); s = a*x; s + x*(a - s^2)/2.  The
// products with the zero low limb of (ax, 0) stay, as in the plain version.
__device__ __forceinline__ void sqrt(double ahi, double alo, double &rhi, double &rlo) {
  double x = __ddiv_rn(1.0, __dsqrt_rn(ahi));
  double ax = mul(ahi, x);
  double p, e;
  two_prod(split(ax), split(ax), p, e);
  e = add(e, add(mul(ax, 0.0), mul(0.0, ax)));
  double mh, ml;
  quick_two_sum(p, e, mh, ml);
  double eh = ahi, el = alo;
  sub_from(eh, el, mh, ml);
  add_float_to(eh, el, 0.0);
  double corr = mul(eh, mul(x, 0.5));
  double oh = ax, ol = 0.0;
  add_float_to(oh, ol, corr);
  bool zero = ahi == 0.0;
  rhi = zero ? 0.0 : oh;
  rlo = zero ? 0.0 : ol;
}

}  // namespace dd
