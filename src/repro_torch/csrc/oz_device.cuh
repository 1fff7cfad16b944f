// Pieces shared by the two builds of kernel #2, the fused Ozaki-slice GEMM
// (csrc/ozgemm.cu: f64 slices; csrc/ozgemm_narrow.cu: bf16/f32 slices):
// the anchor, one slice step, the diagonal fold and the drain's epilogue,
// each repeating the rounding sequence of the plain version
// (repro_torch/kernels/ozgemm.py, core/ozaki.py) at KLIMBS limbs.
#pragma once

#include "dd_device.cuh"
#include "ml_device.cuh"

#ifndef KLIMBS
#error "build with -DKLIMBS=2, 3 or 4"
#endif

namespace oz {

constexpr int K = KLIMBS;

enum Epilogue { kNone = 0, kAlpha = 1, kFull = 2 };

// The CTA tile of both builds: 64 rows of A, 64 columns of B.
constexpr int BM = 64, BN = 64;

// The narrow variants (slice type / accumulator type); the numbering is the
// wrapper's.  kF64 is csrc/ozgemm.cu's f64-slice kernel.
enum Variant { kF64 = -1, kBf16F32 = 0, kF32F32 = 1, kBf16F64 = 2, kF32F64 = 3 };

// Bytes of one slice element in shared memory: f64; f32 for f32/f64; 16 bits
// otherwise (bf16, or f16 for the <= 11-bit slices of f32/f32).
__host__ __device__ constexpr int elem_bytes(int v) {
  return v == kF64 ? 8 : v == kF32F64 ? 4 : 2;
}

// The row stride of a narrow slice in shared memory, in elements: the slab
// depth rounded up to the MMA's 16, plus 8 so fragment loads hit 32 banks.
__host__ __device__ constexpr int kstride(int bk) { return (bk + 15) / 16 * 16 + 8; }

// Shared memory one CTA asks for: the slices of both tiles, then per row
// and column the anchor and a nonzero flag, and with narrow slices also the
// scale and its inverse.  The one count for both builds; the wrapper
// (kernels/ozgemm.py smem_bytes) repeats it for CPU tensors, and
// chip_smoke.py holds the two equal.
inline int smem_bytes(int bk, int n_slices, int variant) {
  const int ks = variant == kF64 ? bk : kstride(bk);
  const int per_row = (variant == kF64 ? 1 : 3) * (int)sizeof(double) + (int)sizeof(bool);
  return n_slices * (BM + BN) * ks * elem_bytes(variant) + (BM + BN) * per_row;
}

struct In {
  const double *p[K];
};
struct Out {
  double *p[K];
};

// _pow2_near of core/ozaki.py: mu / mantissa(mu) == 2^exponent(mu).
__device__ __forceinline__ double pow2_near(double mu) {
  mu = mu < 0x1p-511 ? 0x1p-511 : mu;  // NaN passes through
  int e;
  double m = frexp(mu, &e);
  return __ddiv_rn(mu, m);
}

// max that propagates NaN, as torch.amax does.
__device__ __forceinline__ double nan_max(double mu, double x) {
  return (x > mu || isnan(x)) && !isnan(mu) ? x : mu;
}

// r -= s in the residual's tier (mp.sub(r, mp.from_float(s))).
__device__ __forceinline__ void sub_slice(double (&r)[K], double s) {
  if constexpr (K == 2) {
    dd::add_to(r[0], r[1], -s, -0.0);
  } else {
    double neg[K], out[K];
    neg[0] = -s;
#pragma unroll
    for (int l = 1; l < K; ++l) neg[l] = -0.0;
    ml::add_limbs<K>(r, neg, out);
#pragma unroll
    for (int l = 0; l < K; ++l) r[l] = out[l];
  }
}

// One slice off the residual: (r0 + sigma) - sigma, never reassociated.
__device__ __forceinline__ double slice_step(double (&r)[K], double sigma, bool nonzero) {
  double sl = nonzero ? dd::sub(dd::add(r[0], sigma), sigma) : 0.0;
  sub_slice(r, sl);
  return sl;
}

// acc += one diagonal's exact f64 sum, in acc's tier.
__device__ __forceinline__ void fold(double (&acc)[K], double dsum) {
  if constexpr (K == 2) {
    dd::add_float_to(acc[0], acc[1], dsum);
  } else {
    double t[K + 1];
#pragma unroll
    for (int l = 0; l < K; ++l) t[l] = acc[l];
    t[K] = dsum;
    ml::renorm<K>(t, acc);
  }
}

// out = x * y in the tier (mp.mul, x first).
__device__ __forceinline__ void tier_mul(const double (&x)[K], const double (&y)[K],
                                         double (&out)[K]) {
  if constexpr (K == 2) {
    dd::mul(x[0], x[1], y[0], y[1], out[0], out[1]);
  } else {
    ml::mul_limbs<K>(x, y, out);
  }
}

// acc += y in the tier (mp.add).
__device__ __forceinline__ void tier_add_to(double (&acc)[K], const double (&y)[K]) {
  if constexpr (K == 2) {
    dd::add_to(acc[0], acc[1], y[0], y[1]);
  } else {
    double out[K];
    ml::add_limbs<K>(acc, y, out);
#pragma unroll
    for (int l = 0; l < K; ++l) acc[l] = out[l];
  }
}

// The drain's scalars: alpha and beta limbs, and whether beta == 0.
struct Scalars {
  double al[K], be[K];
  bool beta_zero;
};

__device__ __forceinline__ Scalars load_scalars(const double *alpha, const double *beta_s,
                                                int epilogue) {
  Scalars s;
  s.beta_zero = epilogue == kFull;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    s.al[l] = epilogue != kNone ? alpha[l] : 0.0;
    s.be[l] = epilogue == kFull ? beta_s[l] : 0.0;
    s.beta_zero = s.beta_zero && s.be[l] == 0.0;
  }
  return s;
}

// The fused Rgemm epilogue on one accumulator, then its store:
// o = alpha * acc [+ beta * c], beta == 0 selecting zero (C's NaN/Inf never
// leak).  coff and ooff are the element's offsets into C and the output.
__device__ __forceinline__ void drain_one(const double (&acc)[K], const Scalars &s,
                                          int epilogue, const In &c, long long coff,
                                          const Out &o, long long ooff) {
  double res[K];
#pragma unroll
  for (int l = 0; l < K; ++l) res[l] = acc[l];
  if (epilogue != kNone) {
    double t[K];
    tier_mul(s.al, res, t);
#pragma unroll
    for (int l = 0; l < K; ++l) res[l] = t[l];
  }
  if (epilogue == kFull) {
    double cv[K], bc[K];
#pragma unroll
    for (int l = 0; l < K; ++l) cv[l] = c.p[l][coff];
    tier_mul(s.be, cv, bc);
#pragma unroll
    for (int l = 0; l < K; ++l) bc[l] = s.beta_zero ? 0.0 : bc[l];
    tier_add_to(res, bc);
  }
#pragma unroll
  for (int l = 0; l < K; ++l) o.p[l][ooff] = res[l];
}

}  // namespace oz
