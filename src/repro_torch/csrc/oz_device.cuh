// Pieces shared by the three builds of kernel #2, the fused Ozaki-slice
// GEMM: the slicing pre-pass (csrc/ozslice.cu) and the two GEMMs on its
// workspace (csrc/ozgemm.cu: f64 slices; csrc/ozgemm_narrow.cu: bf16, f16
// and f32 slices).  The anchor, one slice step, the slice types, the
// workspace geometry, the staged copy of one slab into shared memory, the
// pair dots on the f64 tensor cores, the diagonal fold and the drain's
// epilogue, each repeating the rounding sequence of the plain versions
// (repro_torch/kernels/ozslice.py, ozgemm.py, core/ozaki.py) at KLIMBS
// limbs.
#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "dd_device.cuh"
#include "ml_device.cuh"

#ifndef KLIMBS
#error "build with -DKLIMBS=2, 3 or 4"
#endif

namespace oz {

constexpr int K = KLIMBS;

enum Epilogue { kNone = 0, kAlpha = 1, kFull = 2 };

// The GEMMs' launch flags for a K panel (kernels/ozgemm.py walks K in
// panels when the workspace outgrows its budget): start from the partial
// accumulator already in the output, and drain with the epilogue (the
// last panel) rather than store the raw accumulator.
enum PanelFlags { kLoadAcc = 1, kFinal = 2 };

// The CTA tile of both GEMMs: 64 rows of A, 64 columns of B.
constexpr int BM = 64, BN = 64;

// Shared memory one Hopper block may opt in to.
constexpr int kSmemLimit = 232448;

// The slice types (slice type / accumulator type); the numbering is the
// wrapper's.  kF64 is csrc/ozgemm.cu's f64-slice kernel.  kF32F32 stores
// its <= 11-bit slices as f16, so it also runs the wrapper's f16/f32 pair.
enum Variant { kF64 = -1, kBf16F32 = 0, kF32F32 = 1, kBf16F64 = 2, kF32F64 = 3 };

// Bytes of one slice element in the workspace and in shared memory: f64;
// f32 for f32/f64; 16 bits otherwise (bf16, or f16 for the <= 11-bit
// slices of f32/f32).
__host__ __device__ constexpr int elem_bytes(int v) {
  return v == kF64 ? 8 : v == kF32F64 ? 4 : 2;
}

// The workspace's slab depth: bk rounded up to the MMA's depth (4 for the
// f64 m8n8k4, 16 for bf16 m16n8k16), zero beyond bk.
__host__ __device__ constexpr int kdepth(int bk, int v) {
  return v == kF64 ? (bk + 3) / 4 * 4 : (bk + 15) / 16 * 16;
}

// The row stride of a slice in shared memory, in elements: the slab depth
// plus 32 bytes (f64) or 8 elements (narrow), so that the fragment loads
// of eight rows take the fewest wavefronts (the f32 slices of f32/f64 are
// loaded two K values a lane, 8 bytes, as the f64 ones are).
__host__ __device__ constexpr int kstride(int bk, int v) {
  return kdepth(bk, v) + (v == kF64 ? 4 : 8);
}

// Rows (of A) or columns (of B) in the workspace: whole CTA tiles.
__host__ __device__ constexpr int rows_padded(int r) { return (r + BM - 1) / BM * BM; }

// One pipeline stage: one slab's slices of a CTA's 64 rows of A and 64
// columns of B ([slice][row][kstride] each) and, for narrow slices, their
// 64 + 64 scales.
__host__ __device__ inline int stage_bytes(int bk, int n_slices, int variant) {
  return n_slices * (BM + BN) * kstride(bk, variant) * elem_bytes(variant) +
         (variant == kF64 ? 0 : (BM + BN) * (int)sizeof(double));
}

// Stages in flight: two (slab j + 1 lands while slab j is dotted and
// folded) where two fit a block's shared memory, else one.
__host__ __device__ inline int stages(int bk, int n_slices, int variant) {
  return 2 * stage_bytes(bk, n_slices, variant) <= kSmemLimit ? 2 : 1;
}

// Shared memory one CTA asks for.  The one count for both GEMMs; the
// wrapper (kernels/ozgemm.py smem_bytes) repeats it for CPU tensors, and
// chip_smoke.py holds the two equal.
inline int smem_bytes(int bk, int n_slices, int variant) {
  return stages(bk, n_slices, variant) * stage_bytes(bk, n_slices, variant);
}

// How each variant stores its slices: put() rounds an f64 as torch's .to()
// does (f64 -> f32 -> bf16 / f16), exact on every slice.
template <int V>
struct Store;
template <>
struct Store<kF64> {
  using T = double;
  static __device__ __forceinline__ T put(double x) { return x; }
};
template <>
struct Store<kBf16F32> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T put(double x) {
    return __float2bfloat16_rn(__double2float_rn(x));
  }
};
template <>
struct Store<kBf16F64> : Store<kBf16F32> {};
template <>
struct Store<kF32F32> {
  using T = __half;  // exact: beta <= 11 with an f32 accumulator
  static __device__ __forceinline__ T put(double x) {
    return __float2half_rn(__double2float_rn(x));
  }
};
template <>
struct Store<kF32F64> {
  using T = float;
  static __device__ __forceinline__ T put(double x) { return __double2float_rn(x); }
};

// 16-byte asynchronous copies, global -> shared, in commit groups.
__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of one slab into one stage, spread over the block's
// threads.  wa / wb point at the slab's first slice in the operand's
// workspace (rows_padded(m) or rows_padded(n) rows of kp = kdepth elements
// per slice), sca / scb at its scales (null for f64 slices).
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char *stage, const T *wa,
                                           const double *sca, const T *wb,
                                           const double *scb, int kp, int ks,
                                           int n_slices, int rpa, int rpb,
                                           int row0, int col0) {
  constexpr int per = 16 / (int)sizeof(T);  // elements per copy
  const int cpr = kp / per;                 // copies per row
  const int per_op = n_slices * BM * cpr;
  for (int idx = threadIdx.x; idx < 2 * per_op; idx += blockDim.x) {
    const bool is_b = idx >= per_op;
    const int rem = is_b ? idx - per_op : idx;
    const int s = rem / (BM * cpr), r = rem / cpr % BM, c = rem % cpr;
    const T *src = is_b ? wb + ((size_t)s * rpb + col0 + r) * kp
                        : wa + ((size_t)s * rpa + row0 + r) * kp;
    cp_async16(stage + ((size_t)((is_b ? n_slices : 0) + s) * BM + r) * ks * sizeof(T) +
                   c * 16,
               src + c * per);
  }
  if (sca != nullptr && threadIdx.x < (BM + BN) / 2) {
    // the 64 + 64 scales behind the slices, two per copy
    const int i = 2 * threadIdx.x;
    const double *src = i < BM ? sca + row0 + i : scb + col0 + i - BM;
    cp_async16(stage + (size_t)2 * n_slices * BM * ks * sizeof(T) + i * sizeof(double), src);
  }
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

// The GEMMs' warp tiling: each warp owns 16 rows of the CTA tile and NT
// n8 column tiles, so a CTA runs 1024 / NT threads.  NT = 2 (16 warps,
// 8 outputs a thread) for the f64 kernel at dd, whose folds want the
// warps to hide their latency and whose 128 registers a thread hold them;
// NT = 4 (8 warps, 16 outputs a thread) otherwise: the wider tiers'
// accumulators need the registers, and the narrow kernels at dd spill
// within 128 (their scales beside the fragments of two pairs in flight;
// f32/f64's DMMA loop too, which is otherwise the f64 kernel's).
__host__ __device__ constexpr int nt_of(int v) {
  return K == 2 && v == kF64 ? 2 : 4;
}
__host__ __device__ constexpr int threads_of(int v) { return 1024 / nt_of(v); }

// The outputs a thread owns in both GEMMs, the C-fragment layout of
// mma.sync (lane = 4g + q, warp w): rows wr + g + 8i (i < 2, wr =
// 16 (w % 4)) and columns wc + 8 (jj / 2) + 2q + jj % 2 (jj < 2 NT,
// wc = 8 NT (w / 4)) of the CTA tile.
__device__ __forceinline__ int frag_row(int i) {
  return 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4 + 8 * i;
}
template <int NT>
__device__ __forceinline__ int frag_col(int jj) {
  return 8 * NT * (threadIdx.x / 128) + 8 * (jj / 2) + 2 * (threadIdx.x % 4) + jj % 2;
}

// Pair dots taken at a time in the GEMMs' pair loops: a warp keeps
// PAIRS * NT independent MMAs in flight (every partial sum is exact, so
// any order gives the same bits).
constexpr int PAIRS = 2;

// One m16n8k4 tile on the f64 tensor cores: (d0, d1, d2, d3) += A B,
// where a0 = A[g][q], a1 = A[g + 8][q], b = B[q][g], and (d0, d1) are
// C[g][2q], C[g][2q + 1], (d2, d3) C[g + 8][2q], C[g + 8][2q + 1].
__device__ __forceinline__ void dmma(double &d0, double &d1, double &d2, double &d3,
                                     double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// The w-th K value of what one fragment load gave a lane, widened to f64
// (exactly: every f32 slice is an f64).
__device__ __forceinline__ double kval(double x, int) { return x; }
__device__ __forceinline__ double kval(float2 x, int w) { return w ? x.y : x.x; }

// The DMMA dots of U pairs (s, d - s), ..., pair u into ds[u], from slices
// of type T (f64, or f32 widened as they load) in shared memory.  A lane
// loads W = 8 / sizeof(T) consecutive K values of each fragment element at
// once (f32: a float2) and issues W MMAs; the W MMAs take K values kb + Wq
// + w in the k slot q of lane 4g + q, the same permutation of K for A and
// for B, so a tile still sums every product of its 4W-deep step once.
template <typename T, int NT, int U>
__device__ __forceinline__ void f64_pairs(double (&ds)[U][2][2 * NT], const T *sa,
                                          const T *sb, int s, int d, int ks, int kp) {
  constexpr int W = 8 / (int)sizeof(T);
  using L = typename std::conditional<W == 1, double, float2>::type;
  const int g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  const int wr = 16 * (threadIdx.x / 32 % 4), wc = 8 * NT * (threadIdx.x / 128);
  for (int kb = 0; kb < kp; kb += 4 * W) {
    L a[U][2], b[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T *pa = sa + ((size_t)(s + u) * BM + wr + g) * ks + kb + W * q;
      const T *pb = sb + ((size_t)(d - s - u) * BN + wc + g) * ks + kb + W * q;
      a[u][0] = *reinterpret_cast<const L *>(pa);
      a[u][1] = *reinterpret_cast<const L *>(pa + 8 * ks);
#pragma unroll
      for (int j = 0; j < NT; ++j) b[u][j] = *reinterpret_cast<const L *>(pb + 8 * j * ks);
    }
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          dmma(ds[u][0][2 * j], ds[u][0][2 * j + 1], ds[u][1][2 * j], ds[u][1][2 * j + 1],
               kval(a[u][0], w), kval(a[u][1], w), kval(b[u][j], w));
  }
}

// One diagonal's exact f64 sums on the f64 tensor cores: its pairs s_lo ..
// s_hi, PAIRS at a time, each into its own set of C fragments, the sets
// added at the end.
template <typename T, int NT>
__device__ __forceinline__ void dmma_diagonal(double (&dsum)[2][2 * NT], const T *sa,
                                              const T *sb, int s_lo, int s_hi, int d, int ks,
                                              int kp) {
  double ds[PAIRS][2][2 * NT];
#pragma unroll
  for (int u = 0; u < PAIRS; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj) ds[u][i][jj] = 0.0;
  int s = s_lo;
  for (; s + PAIRS <= s_hi + 1; s += PAIRS) f64_pairs<T, NT, PAIRS>(ds, sa, sb, s, d, ks, kp);
  for (; s <= s_hi; ++s)
    f64_pairs<T, NT, 1>(reinterpret_cast<double(&)[1][2][2 * NT]>(ds[0]), sa, sb, s, d, ks,
                        kp);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj) {
      dsum[i][jj] = ds[0][i][jj];
#pragma unroll
      for (int u = 1; u < PAIRS; ++u) dsum[i][jj] = dd::add(dsum[i][jj], ds[u][i][jj]);
    }
}

// The accumulators at the start of a K panel: zero, or (kLoadAcc) the
// partial sums the previous panel stored raw in the output.
template <int NT>
__device__ __forceinline__ void start_acc(double (&acc)[2][2 * NT][K], int flags,
                                          const Out &o, long long zo, int row0, int col0,
                                          int m, int n) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj) {
      const int r = row0 + frag_row(i), cc = col0 + frag_col<NT>(jj);
      const bool in = (flags & kLoadAcc) && r < m && cc < n;
#pragma unroll
      for (int l = 0; l < K; ++l)
        acc[i][jj][l] = in ? o.p[l][zo + (long long)r * n + cc] : 0.0;
    }
}

// The drain: the fused Rgemm epilogue on the last panel (kFinal), the raw
// accumulator on the others, then the store.
template <int NT>
__device__ __forceinline__ void drain_tile(const double (&acc)[2][2 * NT][K], const double *alpha,
                                           const double *beta_s, int epilogue, int flags,
                                           const In &c, long long zc, const Out &o,
                                           long long zo, int row0, int col0, int m,
                                           int n) {
  const int epi = (flags & kFinal) ? epilogue : kNone;
  const Scalars sc = load_scalars(alpha, beta_s, epi);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + frag_row(i);
    if (r >= m) continue;
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj) {
      const int cc = col0 + frag_col<NT>(jj);
      if (cc >= n) continue;
      const long long off = (long long)r * n + cc;
      drain_one(acc[i][jj], sc, epi, c, zc + off, o, zo + off);
    }
  }
}

}  // namespace oz
