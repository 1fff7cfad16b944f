// Kernel #2: the fused Ozaki-slice GEMM at dd, with the Rgemm epilogue
// fused into its drain.
//
// Replaces the Pallas kernel repro/kernels/ozgemm.py (_ozgemm_kernel /
// ozgemm_kernel_call, with _slab_update and _fold_diagonal): the engine's
// `ozaki-pallas` backend at 2 limbs, f64 slices, f64 accumulation.
//
// What it computes, per 64x64 output tile and per K slab of the plan's
// depth bk, in slab order:
//   1. the per-row max mu of |A.hi| over the slab and the per-column max of
//      |B.hi|; the anchor sigma = pow2_near(mu) * 2^(53-beta);
//   2. n_slices error-free slices per element, s = (hi + sigma) - sigma
//      (never reassociated or contracted), the dd residual updated by
//      dd.add(r, (-s, -0)), then sigma *= 2^-beta;
//   3. for each diagonal d = 0..n_diag-1, the sum in f64 of the pair dots
//      sa[s] . sb[t] with s + t = d, folded into the dd accumulator with
//      dd.add_float.
// The drain applies the `none` / `alpha` / `full` epilogue (alpha * acc,
// plus beta * C, where beta == 0 selects zero so C's NaN/Inf never leak).
// beta, n_slices and bk come from the plan; nothing is re-derived here.
// The bits depend on bk, beta and n_slices, not on the tile size, and the
// plain version (repro_torch/kernels/ozgemm.py, ozgemm_plain) agrees with
// this kernel bit for bit.
//
// Bound on the H100: compute.  The pair dots are 2*m*n*k*P flops (P pair
// dots per slab, 15 at n_slices=5) against the 34 TFLOP/s f64 peak; the
// extraction adds ~22 operations per operand element per slice and the
// folds 10 per output per diagonal per slab.  The f64 tensor cores (67
// TFLOP/s, DMMA) are the later design: every pair product is exact and
// every diagonal sum is exact by the slice_params headroom, so any
// summation order, and fused multiply-add, give the same bits.  That is
// also why the dot loop below uses fma() explicitly: the one place in the
// port where fusing cannot change a bit.
//
// Design: one CTA of 256 threads per 64x64 output tile, a 4x4 micro-tile
// of dd accumulators per thread in registers.  Per slab the CTA extracts
// both operands' slices into shared memory (n_slices * bk * (64 + 64) f64
// values, 80 KB at bk=16, n_slices=5: dynamic shared memory above 48 KB),
// then runs the diagonal dots out of shared memory.  Ragged edges are
// masked; a zero entry slices to zero and leaves every max unchanged, so
// masking equals the reference's zero padding.
#include <cuda_runtime.h>

#include "dd_device.cuh"

namespace {

constexpr int BM = 64, BN = 64;
constexpr int TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;  // 16 x 16 threads
constexpr int THREADS = TX * TY;
constexpr int MAX_SLICES = 16;

enum Epilogue { kNone = 0, kAlpha = 1, kFull = 2 };

// _pow2_near of core/ozaki.py: mu / mantissa(mu) == 2^exponent(mu).
__device__ __forceinline__ double pow2_near(double mu) {
  mu = mu < 0x1p-511 ? 0x1p-511 : mu;  // NaN passes through
  int e;
  double m = frexp(mu, &e);
  return __ddiv_rn(mu, m);
}

// Slices of one operand element on its row's (or column's) anchor ladder;
// out[s * stride] receives slice s.
__device__ __forceinline__ void extract(double hi, double lo, double sigma,
                                        bool nonzero, int beta, int n_slices,
                                        double *out, int stride) {
  const double step = dd::pow2(-beta);
  double rh = hi, rl = lo;
  for (int s = 0; s < n_slices; ++s) {
    double sl = nonzero ? dd::sub(dd::add(rh, sigma), sigma) : 0.0;
    out[s * stride] = sl;
    dd::add_to(rh, rl, -sl, -0.0);
    sigma = dd::mul(sigma, step);
  }
}

__global__ void __launch_bounds__(THREADS)
ozgemm_dd_kernel(const double *__restrict__ a_hi, const double *__restrict__ a_lo,
                 const double *__restrict__ b_hi, const double *__restrict__ b_lo,
                 const double *__restrict__ alpha, const double *__restrict__ beta_s,
                 const double *__restrict__ c_hi, const double *__restrict__ c_lo,
                 double *__restrict__ o_hi, double *__restrict__ o_lo,
                 int m, int n, int k, int bk, int beta, int n_slices,
                 int n_diag, int epilogue) {
  extern __shared__ double smem[];
  double *sa = smem;                       // [n_slices][bk][BM]
  double *sb = sa + n_slices * bk * BM;    // [n_slices][bk][BN]
  double *sig_a = sb + n_slices * bk * BN; // [BM] row anchors
  double *sig_b = sig_a + BM;              // [BN] column anchors
  bool *nz_a = reinterpret_cast<bool *>(sig_b + BN);  // [BM]
  bool *nz_b = nz_a + BM;                              // [BN]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const double up = dd::pow2(53 - beta);

  double acc_hi[TM][TN], acc_lo[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_hi[i][j] = acc_lo[i][j] = 0.0;

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int kd = min(bk, k - k0);
    // 1. anchors: thread r < BM scans A's row r, BM <= thread < BM + BN
    //    scans B's column; NaN propagates into mu as in torch.amax
    if (threadIdx.x < BM + BN) {
      bool is_a = threadIdx.x < BM;
      int r = is_a ? threadIdx.x : threadIdx.x - BM;
      int g = (is_a ? row0 : col0) + r;
      double mu = 0.0;
      if (g < (is_a ? m : n)) {
        for (int kk = 0; kk < kd; ++kk) {
          double x = fabs(is_a ? a_hi[(size_t)g * k + k0 + kk]
                               : b_hi[(size_t)(k0 + kk) * n + g]);
          mu = (x > mu || isnan(x)) && !isnan(mu) ? x : mu;
        }
      }
      (is_a ? sig_a : sig_b)[r] = dd::mul(pow2_near(mu), up);
      (is_a ? nz_a : nz_b)[r] = mu > 0.0;
    }
    __syncthreads();
    // 2. slices of every slab element into shared memory (zero beyond the
    //    ragged edges and beyond the slab's depth kd)
    for (int idx = threadIdx.x; idx < BM * bk; idx += THREADS) {
      int r = idx / bk, kk = idx % bk;
      int gr = row0 + r;
      bool ok = gr < m && kk < kd;
      size_t off = (size_t)gr * k + k0 + kk;
      extract(ok ? a_hi[off] : 0.0, ok ? a_lo[off] : 0.0, sig_a[r],
              nz_a[r] && ok, beta, n_slices, sa + kk * BM + r, bk * BM);
    }
    for (int idx = threadIdx.x; idx < bk * BN; idx += THREADS) {
      int kk = idx / BN, c = idx % BN;
      int gc = col0 + c;
      bool ok = gc < n && kk < kd;
      size_t off = (size_t)(k0 + kk) * n + gc;
      extract(ok ? b_hi[off] : 0.0, ok ? b_lo[off] : 0.0, sig_b[c],
              nz_b[c] && ok, beta, n_slices, sb + kk * BN + c, bk * BN);
    }
    __syncthreads();
    // 3. diagonals, most significant first; each exact sum folds once
    for (int d = 0; d < n_diag; ++d) {
      double dsum[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dsum[i][j] = 0.0;
      int s_lo = max(0, d - n_slices + 1), s_hi = min(d, n_slices - 1);
      for (int s = s_lo; s <= s_hi; ++s) {
        const double *pa = sa + (s * bk) * BM;
        const double *pb = sb + ((d - s) * bk) * BN;
        for (int kk = 0; kk < kd; ++kk) {
          double av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = pa[kk * BM + ty + TY * i];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = pb[kk * BN + tx + TX * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) dsum[i][j] = fma(av[i], bv[j], dsum[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dd::add_float_to(acc_hi[i][j], acc_lo[i][j], dsum[i][j]);
    }
    __syncthreads();
  }

  // drain: the fused Rgemm epilogue, then the store
  const bool beta_zero = epilogue == kFull && beta_s[0] == 0.0 && beta_s[1] == 0.0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = row0 + ty + TY * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col0 + tx + TX * j;
      if (c >= n) continue;
      size_t off = (size_t)r * n + c;
      double h = acc_hi[i][j], l = acc_lo[i][j];
      if (epilogue != kNone) dd::mul(alpha[0], alpha[1], h, l, h, l);
      if (epilogue == kFull) {
        double bh, bl;
        dd::mul(beta_s[0], beta_s[1], c_hi[off], c_lo[off], bh, bl);
        if (beta_zero) bh = bl = 0.0;
        dd::add_to(h, l, bh, bl);
      }
      o_hi[off] = h;
      o_lo[off] = l;
    }
  }
}

}  // namespace

// Shared memory one CTA needs for a slab depth and slice count.
extern "C" int ozgemm_dd_smem_bytes(int bk, int n_slices) {
  return (int)(n_slices * bk * (BM + BN) * sizeof(double) +
               (BM + BN) * (sizeof(double) + sizeof(bool)));
}

// out = epilogue(A @ B), dd limbs: A (m, k), B (k, n), C and out (m, n),
// all row-major contiguous f64 on the device; alpha and beta_s point at
// two limbs each ({hi, lo}).  epilogue: 0 none, 1 alpha (alpha * AB),
// 2 full (alpha * AB + beta * C).  Launches on `stream`; returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int ozgemm_dd(const double *a_hi, const double *a_lo,
                         const double *b_hi, const double *b_lo,
                         const double *alpha, const double *beta_s,
                         const double *c_hi, const double *c_lo,
                         double *o_hi, double *o_lo, int m, int n, int k,
                         int bk, int beta, int n_slices, int n_diag,
                         int epilogue, cudaStream_t stream) {
  if (n_slices < 1 || n_slices > MAX_SLICES || bk < 1)
    return (int)cudaErrorInvalidValue;
  int smem = ozgemm_dd_smem_bytes(bk, n_slices);
  cudaError_t err = cudaFuncSetAttribute(
      ozgemm_dd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  ozgemm_dd_kernel<<<grid, THREADS, smem, stream>>>(
      a_hi, a_lo, b_hi, b_lo, alpha, beta_s, c_hi, c_lo, o_hi, o_lo, m, n, k,
      bk, beta, n_slices, n_diag, epilogue);
  return (int)cudaGetLastError();
}
